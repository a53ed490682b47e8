"""The benchmark's inputs and weights repeat by seed, and its frozen copy of
the loader's augmentation draw agrees with the port's."""
import json

import numpy as np
import pytest
import torch

from conftest import DATA


def _cfg(which):
    return json.loads((DATA / f"tiny_{which}.json").read_text())


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_pool_repeats_by_seed(mode):
    from benchlib import inputs

    cfg, traffic = _cfg("flagship"), json.loads((DATA / f"tiny_{mode}.json").read_text())
    seed = 2 ** 31 + 5
    train = mode == "train"
    b_size = inputs.batch_size(cfg, traffic, train)
    assert b_size == (cfg["train"]["batch_size"] if train else cfg["eval_batch_size"])
    a = inputs.make_pool(cfg, traffic, b_size, train, seed, "cpu")
    b = inputs.make_pool(cfg, traffic, b_size, train, seed, "cpu")
    c = inputs.make_pool(cfg, traffic, b_size, train, seed + 1, "cpu")
    assert len(a) == traffic["pool"] and a[0]["imgs"].shape[0] == b_size
    assert inputs.batch_size(cfg, traffic | {"batch": 3}, train) == 3
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["imgs"], c[0]["imgs"])
    assert not torch.equal(a[0]["post_rots"], a[1]["post_rots"]) or mode == "eval"
    shares = np.bincount(a[0]["binimg"].reshape(-1).numpy(), minlength=4) / a[0]["binimg"].numel()
    assert abs(shares[0] - traffic["label_shares"][0]) < 0.05


def test_rig_is_a_rotation_per_camera():
    from benchlib import inputs

    rots, trans, intrins = inputs.rig(6)
    for r in rots:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(r) - 1) < 1e-5
    # the cameras look out of the car: CAM_FRONT's optical axis (z) is ego +x
    assert rots[1][:, 2] @ np.array([1.0, 0, 0]) > 0.99
    assert rots[4][:, 2] @ np.array([-1.0, 0, 0]) > 0.99
    assert intrins[:, 2, 2].tolist() == [1.0] * 6 and trans.shape == (6, 3)


@pytest.mark.parametrize("train", [True, False])
def test_augmentation_is_the_loaders(train):
    """The frozen copy against the port's `core/augment.py` on one seed."""
    from benchlib import inputs
    from lss2_multimodal_nu_tpu_torch.config import AugConfig
    from lss2_multimodal_nu_tpu_torch.core import augment

    aug = _cfg("flagship")["aug"] | {"final_dim": [128, 352]}
    conf = AugConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in aug.items()})
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(20):
        got = inputs.augmentation(aug, train, r1)
        p = augment.sample_augmentation(conf, train, r2)
        want = augment.expand_to_3x3(*augment.accumulate_post_transform(p))
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], atol=1e-4)


def test_weights_repeat_by_seed_and_load_into_both():
    from benchlib import session, weights
    from reference import train as ref_train

    cfg = _cfg("flagship")
    meta = ref_train.build(cfg, "meta")
    a, b = weights.make(meta, 3, "cpu"), weights.make(meta, 3, "cpu")
    assert a.keys() == set(meta.state_dict()) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(weights.make(meta, 4, "cpu")["backbone.backbone.stem.0.conv.weight"],
                           a["backbone.backbone.stem.0.conv.weight"])
    prog = session.Program(cfg, 3, "cpu", a, False, 1)  # loads strictly, by name
    sd = prog.model.state_dict()
    assert all(torch.equal(sd[k], a[k]) for k in a)
    bn = a["backbone.backbone.stem.0.bn.running_var"]
    assert 0.5 <= float(bn.min()) and float(bn.max()) <= 1.5
    assert float(a["bev_encoder.transformer.encoder.self_attn.sampling_offsets.weight"].abs().max()) > 0
