"""Checkpoints in the original repo's three `.pt` formats (counterpart of the
JAX package's `train/checkpoint.py`, which writes Orbax directories):

1. bare: `model.state_dict()` (`save_params`; `MODEL_FILE` each epoch in
   Stack A);
2. components: `{X}_state_dict` for each named top-level module X (the
   pretrain model's `PRETRAIN_COMPONENTS`), with `epoch` and, where given,
   `miou` and `lss_version` (`save_components`; `BEST_PRETRAINED`,
   `PRETRAINED_EPOCH`): what stage 1 hands to stage 2;
3. full state: `model_state_dict`, `optimizer_state_dict`,
   `scheduler_state_dict`, `step`, `epoch` and `best_miou`
   (`save_train_state`; `STATE_LATEST`, `BEST_MODEL`, `CHECKPOINT_EPOCH`):
   what resume reads (`restore_train_state`).

The JAX package reads all three (`port/torch_port.py::port_checkpoint_file`).
Files are written from host copies, whatever device the model is on, and
hold only tensors and plain Python numbers, strings, lists and dicts, so
`torch.load(path, weights_only=True)` reads every file written here. A
file is written under a temporary name and renamed, so a reader never sees
half of one.

In a group (`parallel/`), every rank calls the save functions, which
gather a sharded (FSDP2) model's and optimizer's tensors in full, in the
same order on every rank, and only rank 0 writes: the files are the
single-process ones, and the optimizer's keep torch's `state_dict()`
layout (integer ids in the order of the parameter groups), where
`torch.distributed.checkpoint` would key them by name.
`restore_train_state` into a sharded model reads the full file on every
rank and shards it. `PreemptionHandler.should_stop()` is agreed across
ranks: a signal on any rank stops all of them.

`load_file` also reads the original repo's files. Their metadata may hold
numpy scalars (an mIoU computed with numpy), which `weights_only` refuses:
it allows numpy's scalar reconstruction and numeric dtypes, under the
module names of numpy 1 and 2, and nothing else, so loading runs no code
from the file.

`restore_loose` is the original repo's `load_state_dict(strict=False)` warm
start: every top-level module of the model that the file holds is loaded if
its keys and shapes match the model's exactly; a module with any missing or
extra key or any other shape is dropped whole, reported and left at its
init values, as the original drops a mismatched component (the JAX
package's `merge_loose` instead takes every leaf that fits). Modules keep
the original's names in every family, so no re-rooting is needed.
"""
from __future__ import annotations

import concurrent.futures
import os
import signal
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..models.vovnet_pretrain import PRETRAIN_COMPONENTS
from ..parallel import multihost

# file names, with the original repo's suffixes (`state_latest` is the JAX
# package's own and takes the full-state suffix)
MODEL_FILE = "model{epoch}.pt"
BEST_PRETRAINED = "best_pretrained.pth"
PRETRAINED_EPOCH = "pretrained_epoch_{epoch}.pth"
STATE_LATEST = "state_latest.pth"
BEST_MODEL = "best_model_{flags}.pth"
CHECKPOINT_EPOCH = "checkpoint_{flags}_epoch_{epoch}.pth"

_NOT_COMPONENTS = ("optimizer_state_dict", "scheduler_state_dict")


def _to_host(obj: Any) -> Any:
    """A copy of obj with every tensor detached and on the CPU, a sharded
    one (DTensor) gathered in full first (a collective)."""
    if isinstance(obj, torch.Tensor):
        if hasattr(obj, "full_tensor"):
            obj = obj.full_tensor()
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path: str, payload: Any) -> None:
    """Write on rank 0 alone (every rank has gathered the payload)."""
    if not multihost.is_main():
        return
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _meta(**meta) -> Dict[str, Any]:
    """The given metadata as plain Python values (None left out)."""
    kinds = {"epoch": int, "step": int, "miou": float, "best_miou": float, "lss_version": str}
    return {k: kinds[k](v) for k, v in meta.items() if v is not None}


def save_params(path: str, model: torch.nn.Module) -> None:
    """Format 1: the bare `model.state_dict()`."""
    _write(path, _to_host(model.state_dict()))


def save_components(path: str, model: torch.nn.Module,
                    components: Sequence[str] = PRETRAIN_COMPONENTS, *, epoch: int,
                    miou: Optional[float] = None, lss_version: Optional[str] = None) -> None:
    """Format 2: `{X}_state_dict` of each named top-level module, keys
    relative to it, beside `epoch`, `miou` and `lss_version`."""
    payload = {f"{c}_state_dict": _to_host(getattr(model, c).state_dict()) for c in components}
    payload.update(_meta(epoch=epoch, miou=miou, lss_version=lss_version))
    _write(path, payload)


def save_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     scheduler: torch.optim.lr_scheduler.LRScheduler, *, step: int, epoch: int,
                     best_miou: Optional[float] = None) -> None:
    """Format 3: everything resume needs, `step` being the next step's
    index (the train step's dropout seed)."""
    payload = {"model_state_dict": model.state_dict(),
               "optimizer_state_dict": optimizer.state_dict(),
               "scheduler_state_dict": scheduler.state_dict()}
    payload = _to_host(payload)
    payload.update(_meta(step=step, epoch=epoch, best_miou=best_miou))
    _write(path, payload)


def _numpy_scalar_globals():
    """What unpickling a numpy scalar needs: the scalar constructor (under
    numpy 1's and numpy 2's module names) and the numeric dtypes."""
    import numpy as np

    core = getattr(np, "_core", None) or np.core
    scalar = core.multiarray.scalar
    dtypes = [getattr(np.dtypes, f"{n}DType") for n in (
        "Float64", "Float32", "Float16", "Int64", "Int32", "Int16", "Int8", "UInt64", "UInt32",
        "UInt16", "UInt8", "Bool")] if hasattr(np, "dtypes") else []
    return [scalar, (scalar, "numpy.core.multiarray.scalar"),
            (scalar, "numpy._core.multiarray.scalar"), np.dtype, *dtypes]


def load_file(path: str, map_location) -> Any:
    """A checkpoint file of the port's or the original repo's, its tensors
    on `map_location`, read with `weights_only=True` (numpy scalars
    allowed)."""
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        return torch.load(path, map_location=map_location, weights_only=True)


def model_state(obj: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(the model's flat state dict, metadata with "format") of a loaded
    file of any of the three formats; a component's keys get its name as
    prefix."""
    comps = [k for k in obj if k.endswith("_state_dict") and k not in _NOT_COMPONENTS]
    if not comps:
        return obj, {"format": "bare"}
    meta = {k: v for k, v in obj.items() if not k.endswith("_state_dict")}
    if "model_state_dict" in obj:
        return obj["model_state_dict"], dict(meta, format="full_state")
    sd = {f"{k[:-len('_state_dict')]}.{key}": v for k in comps for key, v in obj[k].items()}
    return sd, dict(meta, format="components")


def _by_component(keys) -> Dict[str, set]:
    out: Dict[str, set] = {}
    for k in keys:
        out.setdefault(k.split(".", 1)[0], set()).add(k)
    return out


def restore_loose(path: str, model: torch.nn.Module, map_location) -> Dict[str, Any]:
    """Warm-start `model` from a file of any format, module by top-level
    module (the module docstring). Returns {"format", "loaded" (modules
    loaded), "dropped" ({module: reason}), "absent" (the model's modules
    that the file does not hold), "unexpected" (the file's modules that the
    model lacks)} and the file's metadata."""
    sd, meta = model_state(load_file(path, map_location))
    live = model.state_dict()
    own = {k: v.full_tensor() if hasattr(v, "full_tensor") else v for k, v in live.items()}
    theirs, mine = _by_component(sd), _by_component(own)
    merged = dict(own)
    report = dict(meta, loaded=[], dropped={}, absent=[],
                  unexpected=sorted(set(theirs) - set(mine)))
    for comp, keys in mine.items():
        got = theirs.get(comp)
        if got is None:
            report["absent"].append(comp)
            continue
        shapes = sorted(k for k in keys & got if tuple(sd[k].shape) != tuple(own[k].shape))
        missing, extra = sorted(keys - got), sorted(got - keys)
        if missing or extra or shapes:
            reason = (f"{len(missing)} keys missing, {len(extra)} unexpected, "
                      f"{len(shapes)} of another shape (first: {(missing + extra + shapes)[0]})")
            report["dropped"][comp] = reason
            if multihost.is_main():
                print(f"[ckpt] {path}: dropped {comp} whole, left at its init: {reason}")
            continue
        merged.update((k, sd[k]) for k in keys)
        report["loaded"].append(comp)
    model.load_state_dict({k: _shard_like(v, live[k]) for k, v in merged.items()})
    return report


def restore_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                        scheduler: torch.optim.lr_scheduler.LRScheduler,
                        map_location) -> Dict[str, Any]:
    """Load a full-state file into the model, optimizer and scheduler
    (strictly); returns its metadata: `step` (the next step's index),
    `epoch` and, where saved, `best_miou`."""
    obj = load_file(path, map_location)
    live = model.state_dict()
    model.load_state_dict({k: _shard_like(v, live.get(k)) for k, v in
                           obj["model_state_dict"].items()})
    params = [p for g in optimizer.param_groups for p in g["params"]]
    opt_sd = obj["optimizer_state_dict"]
    state = {i: {k: v if k == "step" else _shard_like(v, params[i]) for k, v in st.items()}
             for i, st in opt_sd["state"].items()}
    # torch's Adam keeps its step counters on the host (`load_state_dict`
    # moves them to the parameters' device only for a capturable or fused
    # one): read onto the card, every step would copy them back with a
    # host sync
    for st in state.values():
        if isinstance(st.get("step"), torch.Tensor):
            st["step"] = st["step"].cpu()
    optimizer.load_state_dict({"state": state, "param_groups": opt_sd["param_groups"]})
    scheduler.load_state_dict(obj["scheduler_state_dict"])
    return {k: v for k, v in obj.items() if not k.endswith("_state_dict")}


def _shard_like(full: Any, like) -> Any:
    """A full tensor sharded as `like` is where `like` is a DTensor (an
    FSDP2 parameter), from this rank's own copy, with no communication;
    `full` itself otherwise."""
    if not hasattr(like, "placements") or not isinstance(full, torch.Tensor):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.dtype), like.device_mesh, like.placements,
                             src_data_rank=None)


class AsyncSaver:
    """Writes bare checkpoints from a background thread while training goes
    on: `save_params` copies the weights to the host on the caller's thread,
    so the caller may change the model at once; one writer thread writes the
    files in order. `wait()` blocks until every file saved so far is written
    and raises a failed write's error; `close()` waits, then stops the
    thread."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def save_params(self, path: str, model: torch.nn.Module) -> None:
        self._pending.append(self._pool.submit(_write, path, _to_host(model.state_dict())))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()


class PreemptionHandler:
    """SIGTERM- and SIGINT-aware stopping: once registered, either signal
    sets a flag (and still reaches a handler installed before); a training
    loop checks `should_stop()` each epoch and saves before it exits. In a
    group, `should_stop()` is a collective that every rank calls at the
    same point: true on all ranks where any rank got a signal.
    `close()` puts the earlier handlers back. Register from the main
    thread; elsewhere signals cannot be caught and it never stops."""

    def __init__(self):
        self._flag = threading.Event()
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev = signal.getsignal(sig)

            def handler(signum, frame, _prev=prev):
                self._flag.set()
                if callable(_prev):
                    _prev(signum, frame)

            try:
                signal.signal(sig, handler)
            except ValueError:  # not the main thread
                continue
            self._prev[sig] = prev

    def should_stop(self) -> bool:
        return multihost.any_rank(self._flag.is_set())

    def close(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}


def latest_checkpoint(logdir: str, prefix: str = "model") -> Optional[str]:
    """The file or directory in `logdir` whose name starts with `prefix`
    and carries the largest number after it (`model11.pt` over `model3.pt`),
    or None."""
    if not os.path.isdir(logdir):
        return None
    cands = []
    for name in os.listdir(logdir):
        if name.startswith(prefix) and not name.endswith(".tmp"):
            digits = "".join(c for c in name[len(prefix):] if c.isdigit())
            if digits:
                cands.append((int(digits), os.path.join(logdir, name)))
    return max(cands)[1] if cands else None
