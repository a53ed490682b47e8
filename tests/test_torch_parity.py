"""The port's trace-replay harness (`port/parity.py::check_parity`) against
the JAX package, on the CPU.

A trace stands in for one dumped from the original repo: a synthetic
original `state_dict` from `test_port.py::fake_torch_state` on the JAX
porter's rules (numpy seed, shapes from `jax.eval_shape`, nothing compiled
for init), carried by the JAX porter into the JAX model, whose outputs
(BEV in NCHW) become the trace's. The port loads the same `state_dict` by
name. Before that, each batch and layer norm's scale is drawn in [0.5, 1.5]
(the porter's N(0, 0.05) scales shrink every activation to the biases) and
each batch norm's running statistics are set to its batch statistics on the
trace's inputs (a train forward of the port, momentum 1, dropout off): the
outputs are then of order 1 and vary across the BEV grid, so a pass says
something.

`lss` and the flagship (vovnet39, LSS v2, V3) run at the dry-run shapes of
`test_torch_modules.py` (6 cameras at 32x96 into a 32x32 grid), passed
through `cfg`; `bev_txt` and `bev_txt_onlybev` (b0) at 128x352 into the
200x200 grid, which their BEV crop needs, with `check_parity`'s own
default config (family and variant from the trace). B=1, float32, the
harness's defaults: rtol = atol = 1e-3.
"""
import dataclasses
import pickle
import re
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lss2_multimodal_nu_tpu.config import AugConfig as JAug, Config as JConfig
from lss2_multimodal_nu_tpu.config import GridConfig as JGrid, ModelConfig as JModel
from lss2_multimodal_nu_tpu.models.factory import build_model as j_build_model
from lss2_multimodal_nu_tpu.port.torch_port import build_porter
from lss2_multimodal_nu_tpu_torch.config import AugConfig, Config, GridConfig, ModelConfig
from lss2_multimodal_nu_tpu_torch.models.factory import build_model
from lss2_multimodal_nu_tpu_torch.port.parity import INPUTS, check_parity, load_trace
from lss2_multimodal_nu_tpu_torch.train.steps import train_without_dropout
from test_port import fake_torch_state
from test_torch_modules import FINAL_DIM, XB, camera_inputs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in parallel workers, and torch's
    own threads in each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class Case:
    porter: dict  # build_porter's flags
    small: bool  # the dry-run shapes, through cfg
    bev_bias: str  # the bias of the last conv that produces `bev`
    act_bias: Optional[str] = None  # a bias that only `act` reads


CASES = {
    "lss": Case(dict(variant="b0"), True, "bevencode.up2.4.bias"),
    "bev_txt": Case(dict(variant="b0"), False, "bevencode.up2.4.bias", "predictorf2.0.bias"),
    "bev_txt_onlybev": Case(dict(variant="b0"), False, "bevencode.up2.4.bias",
                            "predictor_bev1.0.bias"),
    "vovnet_transformer": Case(dict(model_name="vovnet39", lss_version="v2"), True,
                               "bev_encoder.seg_head.6.bias",
                               "unified_predictor.action_head.bias"),
}
TEXT_HEADS = [f for f, c in CASES.items() if c.act_bias]


def _configs(family, small):
    """(JAX config, the port's config or None for check_parity's default)."""
    if not small:
        return JConfig(model=JModel(family=family, effnet_variant="b0")), None
    return (JConfig(grid=JGrid(xbound=XB, ybound=XB), aug=JAug(final_dim=FINAL_DIM),
                    model=JModel(family=family, effnet_variant="b0")),
            Config(grid=GridConfig(xbound=XB, ybound=XB), aug=AugConfig(final_dim=FINAL_DIM),
                   model=ModelConfig(family=family, effnet_variant="b0")))


def _original_state(family, case, shapes, cfg, inputs):
    """The synthetic original state_dict: fake_torch_state's, with norm
    scales in [0.5, 1.5] and batch-norm statistics calibrated on `inputs`."""
    sd = fake_torch_state(build_porter(family, **case.porter), shapes["params"],
                          shapes["batch_stats"])
    model = build_model(cfg or Config(model=ModelConfig(family=family, effnet_variant="b0")),
                        device="cpu")
    rng = np.random.default_rng(5)
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.LayerNorm)):
            sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, tuple(m.weight.shape)).astype(np.float32)
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    with torch.no_grad():
        train_without_dropout(model)(*map(torch.from_numpy, inputs))
    stats = model.state_dict()
    return {k: stats[k].numpy().copy() if k.endswith(("running_mean", "running_var")) else v
            for k, v in sd.items()}


def _write(path, trace):
    if str(path).endswith(".npz"):
        np.savez(path, **trace)
    else:
        with open(path, "wb") as f:
            pickle.dump(trace, f)
    return str(path)


def _trace(family, tmp_dir):
    """(case, port config or None, trace, its pickle's path) of `family`."""
    case = CASES[family]
    jcfg, cfg = _configs(family, case.small)
    args = camera_inputs(1, seed=1) if case.small else camera_inputs(1, h=128, w=352, seed=1)
    jmodel = j_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args)
    inputs = [np.ascontiguousarray(args[0].transpose(0, 1, 4, 2, 3))] + list(args[1:])
    sd = _original_state(family, case, shapes, cfg, inputs)
    params, batch_stats, missing = build_porter(family, **case.porter).run(sd)
    assert not missing
    out = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        {"params": params, "batch_stats": batch_stats}, *map(jnp.asarray, args))
    out = [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]
    outputs = dict(zip(("bev", "act", "desc"), [np.moveaxis(out[0], 3, 1)] + out[1:]))
    trace = {"inputs": dict(zip(INPUTS, inputs)), "outputs": outputs, "state_dict": sd,
             "family": family, "variant": "b0"}
    return case, cfg, trace, _write(tmp_dir / f"{family}.pkl", trace)


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """family -> `_trace(family)`, made at first use: one JAX compile a
    family."""
    made, tmp_dir = {}, tmp_path_factory.mktemp("traces")

    def get(family):
        if family not in made:
            made[family] = _trace(family, tmp_dir)
        return made[family]

    return get


def _shifted(trace, key, tmp_path):
    """The trace's path with `key`'s weight shifted by +1.0."""
    sd = dict(trace["state_dict"])
    sd[key] = sd[key] + 1.0
    return _write(tmp_path / "trace.pkl", dict(trace, state_dict=sd))


@pytest.mark.parametrize("family", list(CASES))
def test_trace_passes(family, traces):
    """Every output passes at the defaults and the BEV's argmax agrees
    everywhere; the BEV logits vary across the grid by far more than the
    tolerance."""
    case, cfg, trace, path = traces(family)
    report = check_parity(path, cfg=cfg, device="cpu")
    assert list(report) == ["bev", "act", "desc"][:len(trace["outputs"])], report
    assert all(r["pass"] for r in report.values()), report
    assert report["bev"]["argmax_match"] == 1.0
    assert trace["outputs"]["bev"].std(axis=(2, 3)).mean() > 0.1


@pytest.mark.parametrize("family", list(CASES))
def test_shifted_bev_bias_fails_bev(family, traces, tmp_path):
    case, cfg, trace, _ = traces(family)
    report = check_parity(_shifted(trace, case.bev_bias, tmp_path), cfg=cfg, device="cpu")
    assert not report["bev"]["pass"], report
    assert report["bev"]["max_abs"] == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("family", TEXT_HEADS)
def test_shifted_action_bias_fails_act_alone(family, traces, tmp_path):
    """A bias that only `act` reads: `act` fails, `bev` still passes."""
    case, cfg, trace, _ = traces(family)
    report = check_parity(_shifted(trace, case.act_bias, tmp_path), cfg=cfg, device="cpu")
    assert not report["act"]["pass"] and report["bev"]["pass"], report


def test_npz_and_pickle_give_one_report(traces, tmp_path):
    """One trace as `.npz` (dicts as object entries, strings as 0-d
    arrays) and as a pickle: the same trace read back, the same report."""
    case, cfg, trace, path = traces("lss")
    npz = _write(tmp_path / "trace.npz", trace)
    back = load_trace(npz)
    assert back["family"] == "lss" and isinstance(back["family"], str)
    assert back["variant"] == "b0" and isinstance(back["variant"], str)
    assert set(back["state_dict"]) == set(trace["state_dict"])
    assert check_parity(npz, cfg=cfg, device="cpu") == check_parity(path, cfg=cfg, device="cpu")


def test_parity_line_names_missing_and_unknown_keys(traces, tmp_path, capsys):
    """A key dropped from the trace and a key the model lacks are counted
    and named on the `[parity]` line; `num_batches_tracked`, which the
    porter's rules do not carry, is not."""
    case, cfg, trace, _ = traces("lss")
    sd = dict(trace["state_dict"])
    dropped = "camencode.depthnet.bias"
    del sd[dropped]
    sd["not_a_module.weight"] = np.zeros(3, np.float32)
    path = _write(tmp_path / "trace.pkl", dict(trace, state_dict=sd))
    check_parity(path, cfg=cfg, device="cpu")
    line, = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[parity]")]
    assert "1 model keys missing" in line and dropped in line, line
    assert "1 trace keys unknown" in line and "not_a_module.weight" in line, line
    assert "num_batches_tracked" not in line


def test_wrong_shape_raises_naming_the_key(traces, tmp_path):
    case, cfg, trace, _ = traces("lss")
    key = "camencode.depthnet.weight"
    sd = dict(trace["state_dict"], **{key: trace["state_dict"][key][:, :-1]})
    path = _write(tmp_path / "trace.pkl", dict(trace, state_dict=sd))
    with pytest.raises(RuntimeError, match=re.escape(f"size mismatch for {key}")):
        check_parity(path, cfg=cfg, device="cpu")


def test_check_parity_defaults_to_the_card(traces):
    """With no `device`, the replay runs on the card; without one it raises
    and names `device='cpu'`: there is no fallback to the CPU."""
    case, cfg, trace, path = traces("lss")
    if torch.cuda.is_available():
        assert all(r["pass"] for r in check_parity(path, cfg=cfg).values())
    else:
        with pytest.raises(RuntimeError, match=re.escape("device='cpu'")):
            check_parity(path, cfg=cfg)
