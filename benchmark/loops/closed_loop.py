"""One client in a closed loop: each request is `eval_step` on the next
batch of the pool (cycled) with a fresh confusion matrix; its predictions,
confusion matrix and loss are read to the host before the next request is
sent. A request's latency runs from its dispatch until those answers are
on the host. Set-up sends `warmup` requests. The check compares the last
request of each batch that the window served, its logits caught by a
forward hook on the model.

Traffic keys: `pool`, `warmup`, `label_shares`, `target_rate`, and `batch`
(optional; the configuration's evaluation batch where it is left out).
"""
import time

import torch

from benchlib import session, trace


class Loop(session.Loop):
    KIND = "eval"

    def __init__(self, cell, seed, devices, rec):
        super().__init__(cell, seed, devices, rec)
        self.captured, self.answers, self._slot = {}, {}, None

        def capture(_m, _inputs, out):
            self.captured[self._slot] = out

        self.prog.model.register_forward_hook(capture)
        for _ in range(self.traffic["warmup"]):
            self.request()

    def request(self) -> None:
        i = self.step
        self._slot = slot = i % self.pool_n
        classes = self.cfg["model"]["seg_classes"]
        res = self.prog.eval_step(self.pool[slot], torch.zeros(
            (classes, classes), dtype=torch.int64, device=self.device))
        host = {k: res[k].cpu() for k in ("act_pred", "desc_pred", "confmat", "loss")}
        self.answers[slot] = (i, host)
        self.step += 1

    def window(self, seconds, profile):
        latencies = []
        session.sync(self.device)
        with trace.profiled(profile) as holder:
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                ts = time.perf_counter()
                self.request()
                latencies.append(time.perf_counter() - ts)
            session.sync(self.device)
            t1 = time.perf_counter()
        return session.Window(t0, t1 - t0, len(latencies), latencies, holder.prof)

    def outputs(self, since):
        out = {}
        for s, (i, host) in sorted(self.answers.items()):
            if i < since:
                continue
            bev, act, desc = (t.float().cpu() for t in self.captured[s])
            out[s] = {"bev": bev, "act": act, "desc": desc, "loss": float(host["loss"]),
                      "act_pred": host["act_pred"], "desc_pred": host["desc_pred"],
                      "confmat": host["confmat"]}
        return out, {s: self.pool[s] for s in out}

    def free(self):
        self.captured.clear()
        super().free()
