"""BEV segmentation head (eval) and its CUDA kernels.

Counterpart of `ops/seg_head_pallas.py::{fused_seg_head, fold_conv_bn}` of
the JAX package, with the same arguments: kernels in HWIO, w0 (3, 3, 256,
128), w1 (3, 3, 128, 64), w2 (64, out). The output is NCHW (B, out, h, w)
float32. The kernels (`csrc/seg_head.cu`, two launches) replace the TPU
kernel `_kernel` of `seg_head_pallas.py`; the source says what bounds them
on the H100 and why there are two. Both instantiations run on the tensor
cores and take the conv kernels as (tap, out, in), K-major. For bfloat16
the wrapper transposes them. For float32 the kernels' library first runs a
small kernel that writes them so, split into TF32 hi and lo
(`ops/_tf32.py`), into scratch that the wrapper allocates; the convs then
run in three TF32 passes, as close as float32 products. They have no
backward, as the TPU kernel
has none: training runs the seg head op by op (`nn/fusion.py`), and the
wrapper refuses a CUDA call that autograd would have to differentiate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._precision import full_float32
from ._tf32 import split_tf32


def fold_conv_bn(kernel, conv_bias, gamma, beta, mean, var, eps: float = 1e-5):
    """Eval batch norm folded into the preceding conv (kernel's last axis is
    the output channel)."""
    s = gamma / torch.sqrt(var + eps)
    kf = kernel * s
    bias = conv_bias if conv_bias is not None else 0.0
    return kf, (bias - mean) * s + beta


def _img(x, h, w):
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


@full_float32()
def fused_seg_head_plain(x, w0, b0, w1, b1, w2, b2, h: int, w: int) -> torch.Tensor:
    """Plain version of the kernels' arithmetic: the conv operands in x's
    dtype multiplied as float32, conv0's output rounded to x's dtype (it
    crosses memory in that dtype), conv1 and the head in float32, in full
    float32 precision whatever torch's TF32 flags say."""
    cd = x.dtype
    r = lambda t: t.to(cd).float()
    hwio = lambda k: r(k).permute(3, 2, 0, 1)
    y = F.relu(F.conv2d(_img(x, h, w).float(), hwio(w0), b0.float(), padding=1))
    y = F.relu(F.conv2d(r(y), hwio(w1), b1.float(), padding=1))
    return torch.einsum("bchw,co->bohw", y, w2.float()) + b2.float()[:, None, None]


_SYMBOL = {torch.float32: "seg_head_f32", torch.bfloat16: "seg_head_bf16"}


def fused_seg_head(x, w0, b0, w1, b1, w2, b2, h: int, w: int) -> torch.Tensor:
    """x (B, h*w, 256), the transformer's token layout -> (B, out, h, w)
    float32 logits. A CPU tensor takes the plain version; a CUDA tensor
    launches the two kernels (x float32 or bfloat16; float32 on the tensor
    cores in three TF32 passes)."""
    if x.device.type == "cpu":
        return fused_seg_head_plain(x, w0, b0, w1, b1, w2, b2, h, w)
    _build.refuse_grad("seg_head", x, w0, b0, w1, b1, w2, b2)
    if x.device.type != "cuda" or x.dtype not in _SYMBOL:
        raise ValueError(f"no seg-head kernel for {x.dtype} on {x.device}")
    b, hw, cin = x.shape
    nout = w2.shape[1]
    if (hw != h * w or cin != 256 or tuple(w0.shape) != (3, 3, 256, 128)
            or tuple(w1.shape) != (3, 3, 128, 64)
            or tuple(w2.shape) != (64, nout) or (b0.numel(), b1.numel(), b2.numel()) != (128, 64, nout)):
        raise ValueError("seg-head kernel is built for 256 -> 128 -> 64 -> out")
    _build.same_device(x, w0, b0, w1, b1, w2, b2)
    cd = x.dtype
    x = x.contiguous()
    w0k, w1k = w0.to(cd).reshape(9, 256, 128), w1.to(cd).reshape(9, 128, 64)
    if cd == torch.bfloat16:  # the tensor-core kernels take (tap, out, in) (K-major)
        w0k, w1k = w0k.transpose(1, 2), w1k.transpose(1, 2)
    w0k, w1k = w0k.contiguous(), w1k.contiguous()
    f32 = lambda t: t.to(torch.float32).contiguous()
    b0k, b1k, w2k, b2k = f32(b0), f32(b1), f32(w2), f32(b2)
    y0 = torch.empty(b, hw, 128, dtype=cd, device=x.device)
    out = torch.empty(b, nout, h, w, dtype=torch.float32, device=x.device)
    # float32: scratch for the conv kernels' split (see the module's note)
    split = [] if cd == torch.bfloat16 else _split_scratch(x.device)
    P, I = _build.P, _build.I
    fn = _build.bind("seg_head", _SYMBOL[cd], [P] * (9 + len(split)) + [I] * 4 + [P])
    with torch.cuda.device(x.device):
        code = fn(*map(_build.ptr, (x, w0k, b0k, w1k, b1k, w2k, b2k, *split, y0, out)), b, h, w,
                  nout, _build.stream(x.device))
    fused_seg_head.launches += 2  # conv0 kernel, then conv1 + head kernel
    _build.check("seg_head", code)
    return out


fused_seg_head.launches = 0


def _split_scratch(device):
    f = dict(dtype=torch.float32, device=device)
    return [torch.empty(2, 9, 128, 256, **f), torch.empty(2, 9, 64, 128, **f)]


def tf32_split_weights_plain(w0, w1):
    """The float32 kernels' operands from the HWIO kernels: (tap, out, in)
    hi over lo, (2, 9, 128, 256) and (2, 9, 64, 128)."""
    return tuple(torch.stack(split_tf32(k.float().reshape(9, k.shape[2], k.shape[3]).transpose(1, 2)))
                 for k in (w0, w1))


def tf32_split_weights(w0, w1):
    """`tf32_split_weights_plain` by the kernel that the float32 seg-head
    call runs first (CUDA float32 kernels (3, 3, 256, 128), (3, 3, 128, 64))."""
    if w0.device.type == "cpu":
        return tf32_split_weights_plain(w0, w1)
    if w0.dtype != torch.float32 or w1.dtype != torch.float32:
        raise ValueError("the TF32 split takes float32 kernels")
    if tuple(w0.shape) != (3, 3, 256, 128) or tuple(w1.shape) != (3, 3, 128, 64):
        raise ValueError("seg-head kernel is built for 256 -> 128 -> 64 -> out")
    _build.same_device(w0, w1)
    w0, w1 = w0.contiguous(), w1.contiguous()
    split = _split_scratch(w0.device)
    fn = _build.bind("seg_head", "seg_head_split_f32", [_build.P] * 5)
    with torch.cuda.device(w0.device):
        code = fn(*map(_build.ptr, (w0, w1, *split)), _build.stream(w0.device))
    _build.check("seg_head", code)
    return tuple(split)
