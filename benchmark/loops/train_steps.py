"""Train steps back to back on the pool, cycled: `train_step` dispatched
ahead with one synchronise at the window's end and none per step.

Set-up drives the window's own object through the first three steps from
the weights made from the seed, on three different batches, and keeps on
the host what the check compares of them (their losses, the first
gradient as Adam took it, the parameters' change); then `warmup` more
steps. After the window the object takes three more steps on the next
three batches, from its state as the window left it, copied to the host
first; the check follows both threes with the reference.

Traffic keys: `pool`, `warmup`, `label_shares`, `target_rate`, and `batch`
(optional; the configuration's training batch where it is left out).
"""
import time

from benchlib import session, trace

CHECKED_STEPS = 3


class Loop(session.Loop):
    KIND = "train"

    def __init__(self, cell, seed, devices, rec):
        super().__init__(cell, seed, devices, rec)
        with self.aside():
            start = self.prog.parameters()
        self.early = self._checked_steps()
        with self.aside():
            self.early_change = {n: p - start[n] for n, p in self.prog.parameters().items()}
        del start
        for _ in range(self.traffic["warmup"]):
            self.once()

    def once(self, mark=None) -> None:
        self.prog.train_step(self.pool[self.step % self.pool_n], self.step, mark=mark)
        self.step += 1

    def _checked_steps(self):
        """Three steps through the window's call: (losses, the first step's
        gradients as Adam took them, the moments before) with the host
        copies set aside."""
        with self.aside():
            before = self.prog.moments()
        losses = []
        for k in range(CHECKED_STEPS):
            losses.append(self.prog.train_step(self.pool[self.step % self.pool_n],
                                               self.step)["loss"])
            self.step += 1
            if k == 0:
                with self.aside():
                    first = self._taken(before, self.prog.moments())
        return [float(x) for x in losses], first, before

    def _taken(self, before, after):
        """Each leaf's gradient as Adam took it in the step between two
        copies of its state: (exp_avg after - beta1 exp_avg before) /
        (1 - beta1)."""
        b1 = self.prog.opt.param_groups[0]["betas"][0]
        out = {}
        for n, (m, _, _) in after.items():
            m0 = before[n][0] if n in before else 0.0
            out[n] = (m - b1 * m0) / (1 - b1)
        return out

    def window(self, seconds, profile):
        rec, n = self.rec, 0
        session.sync(self.device)
        with trace.profiled(profile) as holder:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                rec.step_start()
                self.once(mark=rec.mark if rec.enabled else None)
                n += 1
            session.sync(self.device)
            t1 = time.perf_counter()
        return session.Window(t0, t1 - t0, n, [], holder.prof)

    def after_window(self):
        """The late three steps, from the window's state copied first."""
        self.late_step = self.step
        self.late_state = self.prog.state()
        self.late_batches = [self.pool[(self.step + k) % self.pool_n]
                             for k in range(CHECKED_STEPS)]
        losses, first, moments = self._checked_steps()
        self.late_moments = moments
        after = self.prog.parameters()
        start = {n: self.late_state[n] for n in after}
        self.late = (losses, first, {n: p - start[n] for n, p in after.items()})

    def outputs(self, since):
        losses, first, _ = self.early
        got = {"early": (losses, first, self.early_change), "late": self.late}
        kept = {"early": self.pool[:CHECKED_STEPS], "late": self.late_batches,
                "late_step": self.late_step, "late_state": self.late_state,
                "late_moments": self.late_moments}
        return got, kept
