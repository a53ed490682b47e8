"""The whole slice: the port's VoVNetBEVTransformer against the JAX
flagship at the dryrun shapes (6 cameras at 32x96, a 32x32 BEV grid,
xbound = ybound = (-8, 8, 0.5)), float32, eval, with the weights carried
JAX -> `state_dict_from_jax` -> port; and the weights' round trip through
the JAX package's torch porter.

Tolerances are those of the JAX package's full-model parity against the
original torch model: 2e-3 on the BEV logits, 1e-3 on action/desc."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu.config import AugConfig as JAug, Config as JConfig
from lss2_multimodal_nu_tpu.config import GridConfig as JGrid, ModelConfig as JModel
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.port.torch_port import port_state_dict
from lss2_multimodal_nu_tpu_torch.config import AugConfig, Config, GridConfig, ModelConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.port import state_dict_from_jax
from test_torch_modules import FINAL_DIM, XB, camera_inputs, random_variables

# ablation V3 at B=2, V1 at B=1, and LSS v1 (single-scale depth) under V2
CASES = {
    "V3": (2, dict(lss_version="v2", use_camera_attn=True, use_cross_attn=True)),
    "V1": (1, dict(lss_version="v2", use_camera_attn=False, use_cross_attn=False)),
    "V2_lss_v1": (1, dict(lss_version="v1", use_camera_attn=True, use_cross_attn=False)),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    b, flags = CASES[request.param]
    jcfg = JConfig(grid=JGrid(xbound=XB, ybound=XB), aug=JAug(final_dim=FINAL_DIM),
                   model=JModel(family="vovnet_transformer", **flags))
    cfg = Config(grid=GridConfig(xbound=XB, ybound=XB), aug=AugConfig(final_dim=FINAL_DIM),
                 model=ModelConfig(family="vovnet_transformer", **flags))
    args = camera_inputs(b, seed=b)
    jmodel = j_build_model(jcfg)
    variables = random_variables(jmodel, args, seed=7)
    return jmodel, variables, cfg, flags, args


def test_flagship_forward_matches_jax(case):
    jmodel, variables, cfg, flags, args = case
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(variables, *map(jnp.asarray, args))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"], **flags))
    imgs = torch.from_numpy(np.ascontiguousarray(args[0].transpose(0, 1, 4, 2, 3)))
    with torch.inference_mode():
        seg, action, desc = model(imgs, *map(torch.from_numpy, args[1:]))
    b = args[0].shape[0]
    assert seg.shape == (b, 4, 32, 32) and action.shape == (b, 4) and desc.shape == (b, 8)
    want_seg = np.moveaxis(np.asarray(want[0]), 3, 1)
    assert np.abs(want_seg).max() > 0.1  # the check is not vacuous
    np.testing.assert_allclose(seg.numpy(), want_seg, atol=2e-3)
    np.testing.assert_allclose(action.numpy(), np.asarray(want[1]), atol=1e-3)
    np.testing.assert_allclose(desc.numpy(), np.asarray(want[2]), atol=1e-3)


def test_weights_round_trip(case):
    """JAX tree -> state_dict_from_jax -> the JAX package's porter -> the
    same tree, key for key and bit for bit; the port's model takes exactly
    the keys that state_dict_from_jax makes."""
    _, variables, cfg, flags, _ = case
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"], **flags)
    assert set(sd) == set(build_model(cfg, device="cpu").state_dict())
    params, batch_stats, missing = port_state_dict(
        "vovnet_transformer", {k: v.numpy() for k, v in sd.items()}, **flags)
    assert not missing
    for got, want in ((params, variables["params"]), (batch_stats, variables["batch_stats"])):
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert flat_got.keys() == flat_want.keys()
        for k in flat_want:
            np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=str(k))


@pytest.mark.parametrize("family", ["vovnet_pretrain"])
def test_other_families_not_ported_yet(family):
    cfg = Config(model=dataclasses.replace(ModelConfig(), family=family))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg, device="cpu")
