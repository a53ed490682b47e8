"""The plain reference against the port at a tiny size on the CPU (this
test imports both; the reference imports nothing of the port): the eval
forward, and a train step's loss and first gradients, dropout and
drop-connect on, with the same weights and batch."""
import json

import pytest
import torch

from conftest import DATA

torch.set_num_threads(4)


def _setup(which, mode):
    from benchlib import inputs, session, weights
    from reference import train as ref_train

    cfg = json.loads((DATA / f"tiny_{which}.json").read_text())
    traffic = json.loads((DATA / f"tiny_{mode}.json").read_text())
    seed = 2 ** 31 + 77
    w = weights.make(ref_train.build(cfg, "meta"), seed, "cpu")
    prog = session.Program(cfg, seed, "cpu", w, mode == "train", traffic["pool"])
    ref = ref_train.build(cfg, "cpu")
    ref.load_state_dict(w)
    train = mode == "train"
    pool = inputs.make_pool(cfg, traffic, inputs.batch_size(cfg, traffic, train), train, seed,
                            "cpu")
    return cfg, seed, prog, ref, pool


@pytest.mark.parametrize("which", ["flagship", "bevtxt"])
def test_eval_forward_agrees(which):
    from reference import train as ref_train

    cfg, _, prog, ref, pool = _setup(which, "eval")
    batch = pool[0]
    with torch.no_grad():
        got = prog.model(*(batch[k] for k in ref_train.MODEL_INPUTS))
    want = ref_train.eval_forward(ref, cfg, batch)
    for g, w in zip(got, want[:3]):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-4


@pytest.mark.parametrize("which", ["flagship", "bevtxt"])
def test_train_step_agrees(which):
    """Step 0 through the port's `train_step` and the reference's: the loss
    and every leaf's gradient as Adam took it, with the same dropout masks
    (a mask drawn otherwise moves the loss by far more than 1e-5)."""
    from benchlib import check
    from reference import train as ref_train

    cfg, seed, prog, ref, pool = _setup(which, "train")
    loss = float(prog.train_step(pool[0], 0)["loss"])
    first = {n: m / (1 - 0.9) for n, (m, _, _) in prog.moments().items()}
    losses, ref_first, _ = ref_train.train_steps(ref, cfg, pool[:1], seed, 4)
    assert abs(loss - float(losses[0])) / abs(float(losses[0])) < 1e-5
    gaps = check._leaf_gaps(first, {k: v.float() for k, v in ref_first.items()}, sorted(ref_first))
    assert max(gaps) < 1e-3
    assert first.keys() == ref_first.keys()
