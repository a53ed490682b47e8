"""A whole run at a tiny size on the CPU, the look for a card skipped: the
result line's shape, and `correct` false with the timed path broken
underneath, once for each fault a one-chip cell can have: a train step that
leaves the state unchanged, a train step given half of each batch (the
mean taken over the rest), from the first step or only from the window on,
an answer altered where it is produced (the BEV logits in the model, an
action prediction after it). A one-chip cell has no exchange between chips
to leave out."""
import json
import time

import pytest
import torch

from conftest import tiny_cell

torch.set_num_threads(4)
SEED = 2 ** 31 + 3


def _run(which, mode, seconds=1.0, traced=False):
    from benchlib import session

    return session.run(tiny_cell(which, mode), SEED, seconds, traced, ["cpu"],
                       time.perf_counter())


@pytest.fixture
def steps_module():
    from lss2_multimodal_nu_tpu_torch.train import steps

    return steps


@pytest.mark.parametrize("which,mode", [("flagship", "train"), ("flagship", "eval"),
                                        ("bevtxt", "train"), ("bevtxt", "eval")])
def test_sound_run_is_correct_and_its_result_line_has_every_key(which, mode):
    r = _run(which, mode)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    rate = f"{mode}_samples_per_s" + (".host_paced" if (which, mode) == ("bevtxt", "eval") else "")
    assert set(r["metrics"]) == {"setup_s", rate}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_traced_run_on_the_cpu_reports_no_device_metric():
    r = _run("flagship", "eval", traced=True)
    assert r["correct"] is True
    assert r["metrics"] == {} and r["device"]["busy_s"] is None


def test_state_left_unchanged_fails(steps_module, monkeypatch):
    original = steps_module.train_step

    def unchanged(model, opt, sched, batch, step, mark=None):
        saved = {k: v.clone() for k, v in model.state_dict().items()}
        opt_state = {id(p): {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                     for p, s in opt.state.items()}
        out = original(model, opt, sched, batch, step, mark=mark)
        model.load_state_dict(saved)
        for p, s in opt.state.items():
            s.update(opt_state.get(id(p), {k: torch.zeros_like(v) if torch.is_tensor(v) else v
                                           for k, v in s.items()}))
        return out

    monkeypatch.setattr(steps_module, "train_step", unchanged)
    r = _run("flagship", "train")
    assert r["correct"] is False
    for name in ("change_gap", "late_change_gap"):
        assert r["checks"][name]["value"] > r["checks"][name]["limit"]


def test_half_batch_fails(steps_module, monkeypatch):
    original = steps_module.train_step

    def half(model, opt, sched, batch, step, mark=None):
        return original(model, opt, sched, {k: v[: v.shape[0] // 2] for k, v in batch.items()},
                        step, mark=mark)

    monkeypatch.setattr(steps_module, "train_step", half)
    assert _run("flagship", "train")["correct"] is False


def test_half_batch_from_the_window_on_fails_the_late_steps(steps_module, monkeypatch):
    """A fault that starts after set-up's checked steps and warm-up (as a
    plan captured after the first steps would) passes the first three steps
    and fails the three after the window."""
    from conftest import DATA

    original = steps_module.train_step
    first_window_step = 3 + json.loads((DATA / "tiny_train.json").read_text())["warmup"]

    def late_half(model, opt, sched, batch, step, mark=None):
        if step >= first_window_step:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return original(model, opt, sched, batch, step, mark=mark)

    monkeypatch.setattr(steps_module, "train_step", late_half)
    r = _run("flagship", "train")
    assert r["correct"] is False
    early = {k: c for k, c in r["checks"].items() if not k.startswith("late_")}
    assert all(c["value"] <= c["limit"] for c in early.values()), early
    assert r["checks"]["late_loss_gap"]["value"] > r["checks"]["late_loss_gap"]["limit"]


def test_bev_logit_altered_in_the_model_fails(monkeypatch):
    from lss2_multimodal_nu_tpu_torch.models.vovnet_transformer import VoVNetBEVTransformer

    forward = VoVNetBEVTransformer.forward

    def altered(self, *a):
        bev, act, desc = forward(self, *a)
        bev = bev.clone()
        bev[0, 1, 3, 3] += 0.5 * float(bev.abs().max())
        return bev, act, desc

    monkeypatch.setattr(VoVNetBEVTransformer, "forward", altered)
    r = _run("flagship", "eval")
    assert r["correct"] is False
    assert r["checks"]["bev_gap"]["value"] > r["checks"]["bev_gap"]["limit"]


def test_action_answer_altered_fails(steps_module, monkeypatch):
    original = steps_module.eval_step

    def altered(model, batch, confmat):
        res = original(model, batch, confmat)
        res["act_pred"] = res["act_pred"].clone()
        res["act_pred"][0, 0] = ~res["act_pred"][0, 0]
        return res

    monkeypatch.setattr(steps_module, "eval_step", altered)
    r = _run("flagship", "eval")
    assert r["correct"] is False and r["checks"]["pred_flips"]["value"] > 0
