"""Convert a checkpoint of the JAX package (an Orbax directory) into the
PyTorch port's `.pt` file of the same kind, so that a JAX run, and its
resume, moves to the card.

    python scripts/jax_checkpoint_to_pt.py SRC DST CMD [--steps_per_epoch N] [CMD's flags]

SRC is what the JAX package's `train/checkpoint.py` wrote: `save_params`
(the weights, e.g. `model3`), `save_components` (pretrain-v2's
`best_pretrained`, `pretrained_epoch_N`) or `save_train_state`
(`state_latest`, `best_model_V3`, `checkpoint_V3_epoch_N`). DST is written
in the port's matching format (`train/checkpoint.py`): a bare state dict,
components with their epoch / mIoU / LSS version, or a full state. CMD and
its flags are the CLI subcommand and flags of the run that wrote SRC (the
model's family and sizes come from them, as in `cli.py`); a full state of a
Stack B run, whose learning rate follows the warmup-cosine schedule, also
needs `--steps_per_epoch`, the run's batches per epoch.

The weights go through `port/__init__.py::state_dict_from_jax`. A full state
also carries the optimizer: optax's Adam moments `mu` and `nu` are trees shaped
like the params, so the same rules map them to torch Adam's `exp_avg` and
`exp_avg_sq` of each parameter, and the Adam count becomes each
parameter's `step`; the scheduler stands at the state's step. Needs JAX
and Orbax (it imports the JAX package); the port itself never reads Orbax.
"""
from __future__ import annotations

import argparse
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lss2_multimodal_nu_tpu.train import checkpoint as jckpt  # noqa: E402
from lss2_multimodal_nu_tpu_torch import cli  # noqa: E402
from lss2_multimodal_nu_tpu_torch.models.factory import build_model  # noqa: E402
from lss2_multimodal_nu_tpu_torch.port import state_dict_from_jax  # noqa: E402
from lss2_multimodal_nu_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from lss2_multimodal_nu_tpu_torch.train.state import build_optimizer  # noqa: E402


def porter_flags(cfg) -> dict:
    """`state_dict_from_jax`'s flags for the config's model."""
    m = cfg.model
    if m.family in ("lss", "bev_txt", "bev_txt_onlybev"):
        return dict(effnet_variant=m.effnet_variant)
    flags = dict(model_name=m.vovnet_type, lss_version=m.lss_version)
    if m.family == "vovnet_transformer":
        flags.update(use_camera_attn=m.use_camera_attn, use_cross_attn=m.use_cross_attn)
    return flags


def _adam_states(tree):
    """Every optax `ScaleByAdamState` in a restored opt_state, as dicts
    {count, mu, nu} (Orbax gives namedtuples back as dicts and lists)."""
    if isinstance(tree, dict):
        if {"count", "mu", "nu"} <= set(tree):
            yield tree
            return
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _adam_states(t)


def _merge(trees):
    """One tree from several of the same structure in which each leaf is
    set (not None) in exactly one: multi_transform masks each group's
    moments to its own parameters."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _merge([t[k] for t in trees]) for k in first}
    set_ = [t for t in trees if t is not None]
    if len(set_) != 1:
        raise ValueError(f"a moment leaf is set in {len(set_)} optimizer groups, not one")
    return set_[0]


def _leaf_tree(tree, leaf):
    """A tree of `tree`'s structure, every leaf `leaf(original)`."""
    if isinstance(tree, dict):
        return {k: _leaf_tree(v, leaf) for k, v in tree.items()}
    return leaf(tree)


def load_optimizer(tree, cfg, model, opt, sched) -> None:
    """The JAX train state's Adam moments and counts into `opt` (over
    `model`'s parameters), and `sched` moved to the state's step."""
    states = list(_adam_states(tree["opt_state"]))
    if not states:
        raise ValueError("no Adam state in the checkpoint's opt_state")
    flags = porter_flags(cfg)
    moments = {}
    for k in ("mu", "nu"):
        moments[k] = state_dict_from_jax(_merge([s[k] for s in states]), tree["batch_stats"],
                                         family=cfg.model.family, **flags)
    # each parameter's Adam count, as a tree of the moments' shapes
    counts = [_leaf_tree(s["mu"], lambda x, c=int(np.asarray(s["count"])):
                         None if x is None else np.full(np.shape(x), c, np.float32))
              for s in states]
    count = state_dict_from_jax(_merge(counts), tree["batch_stats"], family=cfg.model.family,
                                **flags)
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count[name].reshape(-1)[0])),
                        "exp_avg": moments["mu"][name].clone(),
                        "exp_avg_sq": moments["nu"][name].clone()}
    step = int(np.asarray(tree["step"]))
    if step:
        # the rate of step `step`, as the schedule gives it after `step` steps
        sched.last_epoch = step - 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # no optimizer step came before
            sched.step()


def convert(src: str, dst: str, argv) -> str:
    """Convert SRC into DST (see the module docstring); returns the
    format written: 'bare', 'components' or 'full_state'."""
    conv = argparse.ArgumentParser(add_help=False)
    conv.add_argument("--steps_per_epoch", type=int, default=None)
    own, rest = conv.parse_known_args(argv)
    args = cli.build_parser().parse_args(rest)
    cfg = cli._build_cfg(args, cli.FAMILY[args.cmd])
    tree = jckpt.load_tree(src)
    extra = tree.get("extra", {})
    model = build_model(cfg, device="cpu", seed=0)
    model.load_state_dict(state_dict_from_jax(tree["params"], tree["batch_stats"],
                                              family=cfg.model.family, **porter_flags(cfg)))
    if "opt_state" in tree:
        if cfg.train.use_schedule and own.steps_per_epoch is None:
            raise SystemExit("a full state of a scheduled run needs --steps_per_epoch")
        opt, sched = build_optimizer(cfg, model, steps_per_epoch=own.steps_per_epoch)
        load_optimizer(tree, cfg, model, opt, sched)
        ckpt.save_train_state(dst, model, opt, sched, step=int(np.asarray(tree["step"])),
                              epoch=int(extra.get("epoch", 0)), best_miou=extra.get("best_miou"))
        return "full_state"
    if "components" in tree:
        ckpt.save_components(dst, model, list(tree["components"]),
                             epoch=int(extra.get("epoch", 0)), miou=extra.get("miou"),
                             lss_version=extra.get("lss_version"))
        return "components"
    ckpt.save_params(dst, model)
    return "bare"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 3 or argv[0].startswith("-"):
        raise SystemExit(__doc__)
    src, dst, rest = argv[0], argv[1], argv[2:]
    print(f"wrote {dst} ({convert(src, dst, rest)})")


if __name__ == "__main__":
    main()
