"""The port's float32 means float32, whatever the process-wide flags say.

torch's defaults run a float32 convolution through cuDNN in one TF32 pass
(`torch.backends.cudnn.allow_tf32` is True), and a caller may set
`torch.set_float32_matmul_precision("high")`, which does the same for
matrix products. One TF32 pass keeps about three decimal digits, and the
JAX package computes in full float32. The port is a library and does not own
process state, so it does not set the flags for the caller: each entry point
pins them for its own duration with `full_float32` and restores them after.
bfloat16 computation is unaffected.

In the same way a train step pins `torch.backends.cudnn.deterministic`
(`deterministic_cudnn`): unpinned, cuDNN may pick backward convolutions
that add with atomics, and a step would not repeat bit for bit, where the
JAX package's does.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def full_float32():
    """Run the block with cuDNN's TF32 off and float32 matrix products at
    "highest" precision; restore both flags on exit, also on an exception."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(matmul)


@contextmanager
def deterministic_cudnn():
    """Run the block with cuDNN held to deterministic algorithms
    (`torch.backends.cudnn.deterministic`), its autograd backward too when
    that runs inside the block; restore the caller's value on exit, also on
    an exception."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = deterministic
