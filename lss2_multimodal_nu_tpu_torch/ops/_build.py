"""Builds the port's CUDA kernels and loads them with ctypes.

At first use, every `csrc/*.cu` is compiled by its own `nvcc` process, all
started together, into one shared library each under `<repo>/build/kernels`
(listed in `.gitignore`):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>.so csrc/<name>.cu

Each library exports plain C entry points that take device pointers and the
stream as `void*` and return the `cudaError_t` of the launch. `check` turns a
non-zero code into an exception. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _stale(lib: Path, src: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *_CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build_all() -> Dict[str, float]:
    """Compile every stale kernel source in parallel; return seconds per
    source built (empty when all were fresh). Raises on a failed build."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for src in sorted(_CSRC.glob("*.cu")):
            lib = BUILD_DIR / f"lib{src.stem}.so"
            if not _stale(lib, src):
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, lib)
        built = {}
        errors = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            built[name] = time.perf_counter() - t0
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
                continue
            os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
        return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building all kernels first
    if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    with _LOCK:
        if name not in _LIBS:
            so = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            so.lss_error_string.argtypes = [ctypes.c_int]
            so.lss_error_string.restype = ctypes.c_char_p
            _LIBS[name] = so
        return _LIBS[name]


def bind(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    if code != 0:
        msg = library(name).lss_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} (error {code})")


def same_device(ref, *tensors) -> None:
    """Raise unless every tensor lies on `ref`'s device: a kernel given a
    pointer into another device's memory would fault."""
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(f"tensor on {t.device}, expected {ref.device}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need the gradient of an eval-only kernel's
    output: the kernel writes through raw pointers, so its result would carry
    no gradient and every parameter upstream would silently get none."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"CUDA kernel {name} is eval-only and has no backward; "
                           "run the module in training mode or under torch.no_grad()")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


P = ctypes.c_void_p
I = ctypes.c_int
F32 = ctypes.c_float
