"""Fused LN -> FFN(GELU) -> residual -> LN tail (eval) and its CUDA kernel.

Counterpart of `ops/ffn_pallas.py::fused_ffn_ln` of the JAX package, with the
same arguments: weights in the (in, out) layout, w1 (C, F) and w2 (F, C). The
kernel (`csrc/ffn_ln.cu`) replaces the TPU kernel `_kernel` of
`ffn_pallas.py`; its source says what bounds it on the H100. Both
instantiations run on the tensor cores, whose operands are K-major: W1^T
(F, C) and W2^T (C, F). For bfloat16 the wrapper transposes the weights.
For float32 the kernel's library first runs a small kernel that writes W1^T
and W2^T split into TF32 hi and lo (`ops/_tf32.py`), W2^T's K axis permuted
by `K8_ORDER`, into scratch that the wrapper allocates; the products then
run in three TF32 passes, as close as float32 ones. The kernel has
no backward, as the TPU kernel has none: training runs the tail op by op
(`nn/transformer.py`), and the wrapper refuses a CUDA call that autograd
would have to differentiate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ..utils import profiling
from ._precision import full_float32
from ._tf32 import permute_k8, split_tf32


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    d = x - mu
    var = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(var + eps) * scale + bias


@full_float32()
def fused_ffn_ln_plain(u, w1, b1, w2, b2, scale1, bias1, scale2, bias2,
                       eps: float = 1e-6, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the kernel's arithmetic: every weight and the LN1
    output are rounded to `compute_dtype`, the products accumulate in float32
    (the rounded operands are multiplied as float32), LN and GELU run in
    float32, in full float32 precision whatever torch's TF32 flags say.
    Output in u's dtype."""
    cd = compute_dtype
    r = lambda t: t.to(cd).float()
    s = _ln(u.float(), r(scale1), r(bias1), eps)
    h = torch.matmul(r(s), r(w1)) + r(b1)
    g = F.gelu(h)  # exact erf
    y = torch.matmul(r(g), r(w2)) + r(b2)
    return _ln(s + y, r(scale2), r(bias2), eps).to(u.dtype)


_SYMBOL = {torch.float32: "ffn_ln_f32", torch.bfloat16: "ffn_ln_bf16"}
WIDTH, HIDDEN = 256, 1024  # the widths the kernel is compiled for


@profiling.op("op.ffn_ln")
def fused_ffn_ln(u, w1, b1, w2, b2, scale1, bias1, scale2, bias2,
                 eps: float = 1e-6, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """u (B, N, C) -> LN2(LN1(u) + FFN(LN1(u))).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    which needs u in `compute_dtype` (float32 or bfloat16), C = 256 and
    F = 1024; float32 runs on the tensor cores in three TF32 passes."""
    if u.device.type == "cpu":
        return fused_ffn_ln_plain(u, w1, b1, w2, b2, scale1, bias1, scale2, bias2,
                                  eps, compute_dtype)
    _build.refuse_grad("ffn_ln", u, w1, b1, w2, b2, scale1, bias1, scale2, bias2)
    if u.device.type != "cuda" or u.dtype not in _SYMBOL or u.dtype != compute_dtype:
        raise ValueError(f"no FFN kernel for {u.dtype} (compute {compute_dtype}) on {u.device}")
    b, n, c = u.shape
    if (c, w1.shape[1]) != (WIDTH, HIDDEN) or w1.shape != (c, HIDDEN) or w2.shape != (HIDDEN, c):
        raise ValueError(f"FFN kernel is built for C={WIDTH}, F={HIDDEN}")
    if b1.numel() != HIDDEN or any(t.numel() != c for t in (b2, scale1, bias1, scale2, bias2)):
        raise ValueError("FFN biases and norm parameters must have F and C entries")
    _build.same_device(u, w1, b1, w2, b2, scale1, bias1, scale2, bias2)
    u2 = u.contiguous()
    if u.dtype == torch.bfloat16:  # the tensor-core kernel takes W1^T and W2^T (K-major)
        w1, w2 = w1.t(), w2.t()
    params = [t.to(compute_dtype).contiguous()
              for t in (w1, b1, w2, b2, scale1, bias1, scale2, bias2)]
    out = torch.empty_like(u2)
    # float32: scratch for the weights' split (see the module's note)
    split = [] if u.dtype == torch.bfloat16 else _split_scratch(u.device)
    P = _build.P
    fn = _build.bind("ffn_ln", _SYMBOL[u.dtype], [P] * (10 + len(split)) + [_build.I, _build.F32, P])
    with torch.cuda.device(u.device):
        code = fn(*map(_build.ptr, (u2, *params, *split, out)), b * n, eps, _build.stream(u.device))
    fused_ffn_ln.launches += 1
    _build.check("ffn_ln", code)
    return out


fused_ffn_ln.launches = 0


def _split_scratch(device):
    f = dict(dtype=torch.float32, device=device)
    return [torch.empty(2, HIDDEN, WIDTH, **f), torch.empty(2, WIDTH, HIDDEN, **f)]


def tf32_split_weights_plain(w1, w2):
    """The float32 kernel's operands: W1^T's hi over its lo (2, F, C) and
    W2^T's, K permuted by `K8_ORDER`, (2, C, F)."""
    return (torch.stack(split_tf32(w1.float().t())),
            torch.stack(split_tf32(permute_k8(w2.float().t()))))


def tf32_split_weights(w1, w2):
    """`tf32_split_weights_plain` by the kernel that the float32 FFN call
    runs first (CUDA float32 tensors of the kernel's widths)."""
    if w1.device.type == "cpu":
        return tf32_split_weights_plain(w1, w2)
    if w1.dtype != torch.float32 or w2.dtype != torch.float32:
        raise ValueError("the TF32 split takes float32 weights")
    if w1.shape != (WIDTH, HIDDEN) or w2.shape != (HIDDEN, WIDTH):
        raise ValueError(f"FFN kernel is built for C={WIDTH}, F={HIDDEN}")
    _build.same_device(w1, w2)
    w1, w2 = w1.contiguous(), w2.contiguous()
    split = _split_scratch(w1.device)
    fn = _build.bind("ffn_ln", "ffn_ln_split_f32", [_build.P] * 5)
    with torch.cuda.device(w1.device):
        code = fn(*map(_build.ptr, (w1, w2, *split)), _build.stream(w1.device))
    _build.check("ffn_ln", code)
    return tuple(split)
