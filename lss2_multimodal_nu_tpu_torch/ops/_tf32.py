"""The float32 split of the tensor-core kernels' float32 instantiations.

Hopper's tensor cores take float32 only as TF32 (a 10-bit mantissa). The
float32 FFN tail and seg head (`csrc/ffn_ln.cu`, `csrc/seg_head.cu`) run
each product in three TF32 passes, a_hi b_hi + a_lo b_hi + a_hi b_lo, which
is as close as a float32 product (`tests/test_torch_tf32x3.py`). hi is x
rounded to TF32 to nearest with ties away from zero, as `cvt.rna.tf32.f32`
rounds; lo = x - hi is exact, and the tensor cores truncate it to TF32 where
they read it. The kernels split their weights once per call and their
activations in registers, bit for bit as `split_tf32` does
(`csrc/hopper.cuh::split_tf32`).
"""
from __future__ import annotations

import torch

# Slot s of each group of 8 along a TF32 operand's K axis takes index
# K8_ORDER[s] of the group: a float accumulator holds the column pairs
# (2t, 2t+1) of each group of 8, the TF32 A fragment wants (t, t+4), so with
# B's K axis permuted so, the accumulator's registers {d0, d2, d1, d3} are
# the A operand of the next product without a shuffle.
K8_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor: hi = t rounded to TF32 (the bit pattern
    plus 0x1000 with its low 13 bits cleared), lo = t - hi, so hi + lo == t
    exactly for every finite t that does not round to infinity."""
    if t.dtype != torch.float32:
        raise ValueError(f"split_tf32 takes float32, not {t.dtype}")
    t = t.contiguous()
    hi = round_tf32(t)
    return hi, t - hi


def permute_k8(w: torch.Tensor) -> torch.Tensor:
    """w with its last axis (a multiple of 8 long) permuted by K8_ORDER in
    each group of 8."""
    idx = torch.arange(w.shape[-1], device=w.device).view(-1, 8)[:, list(K8_ORDER)].reshape(-1)
    return w.index_select(-1, idx)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 t rounded to TF32 to nearest, ties away from zero."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_rn(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`split_tf32` with lo rounded to TF32 as well, as the trunk's conv
    kernel splits (`csrc/conv_tf32x3.cu::split_tf32_rn`): the tensor cores
    then read lo exactly, and hi + lo errs by at most 2^-22 of t (lo is at
    most 2^-11 of t), half what truncating it would."""
    hi, lo = split_tf32(t)
    return hi, round_tf32(lo)
