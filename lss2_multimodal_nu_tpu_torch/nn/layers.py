"""Shared building blocks (NCHW).

Parameters stay float32 and are cast to the activation's dtype where they
are used, as the JAX package does (`nn/layers.py`). In eval, batch norm is
folded into the preceding conv with the running statistics. In training
(`bn.training`) it normalises with the batch statistics, taken in float32,
and updates the running statistics with torch's momentum 0.1 (flax's 0.9)
and torch's unbiased variance (flax keeps the biased one; ROADMAP.md
fault e).

In a group of more than one rank (`parallel/multihost.py::world`), training
batch norm takes the statistics of the global batch, as the JAX package's
under GSPMD: `_GlobalBatchNorm` combines the ranks' (count, mean, M2) as Chan
does, with one all-gather in the forward and one all-reduce in the
backward, where the gradient flows through the global mean and variance;
the running variance is unbiased over the global count. At world 1 the
code is the single-process one, bit for bit.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv as conv_ops
from ..ops.sampling import resize_bilinear
from ..parallel import multihost


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d] = None,
            relu: bool = False) -> torch.Tensor:
    """conv (+ batch norm) (+ ReLU) in x's dtype. Eval batch norm is folded
    into the conv's weights; train batch norm runs after the conv."""
    if bn is not None and bn.training:
        w, b = conv.weight, conv.bias
        y = F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                     conv.stride, conv.padding, conv.dilation, conv.groups)
        return train_bn(y, bn, relu)
    w, b = fold_bn(conv, bn)
    y = F.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 conv.stride, conv.padding, conv.dilation, conv.groups)
    return F.relu(y) if relu else y


def fold_bn(conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d]):
    """(weight, bias) of `conv` with eval batch norm `bn` folded in."""
    w, b = conv.weight, conv.bias
    if bn is not None:
        g = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        shift = bn.bias - bn.running_mean * g
        w = w * g[:, None, None, None]
        b = shift if b is None else shift + b * g
    return w, b


def train_bn(y: torch.Tensor, bn: nn.BatchNorm2d, relu: bool = False) -> torch.Tensor:
    """Training batch norm (+ ReLU) of a conv's output y, statistics in
    float32, the result in y's dtype; over the group's global batch at
    world > 1."""
    bn.num_batches_tracked.add_(1)
    if multihost.world() > 1:
        z = global_batch_norm(y.float(), bn).to(y.dtype)
    else:
        z = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=True, momentum=bn.momentum, eps=bn.eps).to(y.dtype)
    return F.relu(z) if relu else z


class _GlobalBatchNorm(torch.autograd.Function):
    """Training batch norm of float32 (N, C, H, W) over the group's global
    batch. Forward: each rank's (count, mean, M2) per channel, all-gathered
    and combined as Chan does (a single-pass sum of squares cancels at
    activations of 1e3); backward: the global sums of dy and dy * xhat in
    one all-reduce. The weight's and bias's gradients are the rank's own
    share: the train step sums gradients over the group."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        c = x.shape[1]
        n = x.numel() // c
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        m2 = var * n
        stats = torch.cat([mean, m2, mean.new_full((1,), float(n))])
        gathered = multihost.all_gather_cat(stats[None]).double()
        means, m2s, counts = gathered[:, :c], gathered[:, c:2 * c], gathered[:, 2 * c:]
        total = counts.sum()
        gmean = (counts * means).sum(0) / total
        gm2 = m2s.sum(0) + (counts * (means - gmean).square()).sum(0)
        var = (gm2 / total).float()
        gmean = gmean.float()
        # the normalisation itself as torch's batch norm applies it, from
        # the global statistics
        y = F.batch_norm(x, gmean, var, weight, bias, training=False, eps=eps)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, gmean, invstd)
        ctx.total = total.float()
        unbiased = (gm2 / (total - 1).clamp(min=1)).float()
        ctx.mark_non_differentiable(gmean, unbiased)
        return y, gmean, unbiased

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        xhat = (x - mean[None, :, None, None]) * invstd[None, :, None, None]
        c = dy.shape[1]
        sum_dy = dy.sum(dim=(0, 2, 3))
        sum_dy_xhat = (dy * xhat).sum(dim=(0, 2, 3))
        glob = multihost.all_reduce_sum(torch.cat([sum_dy, sum_dy_xhat]))
        n = ctx.total
        dx = (dy - glob[None, :c, None, None] / n - xhat * glob[None, c:, None, None] / n) \
            * (weight * invstd)[None, :, None, None]
        return dx, sum_dy_xhat, sum_dy, None


def global_batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Training batch norm of float32 x over the group's global batch,
    updating bn's running statistics with torch's momentum and the
    variance unbiased over the global count."""
    y, mean, var = _GlobalBatchNorm.apply(x, bn.weight, bn.bias, bn.eps)
    with torch.no_grad():
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var, bn.momentum)
    return y


@contextmanager
def cudnn_off_for_float32(x: torch.Tensor):
    """cuDNN off for the block where x is a float32 CUDA tensor: PyTorch's
    own conv (im2col and a cuBLAS product, full float32 under the pin) runs
    instead, and the flag is restored after. A conv's backward picks its
    backend when it runs, after the block: cuDNN's again. For the float32
    convs at 200x200 where cuDNN's heuristic, with TF32 off, takes FFT
    tiling that is many times slower (`nn/lss_modules.py::BevEncode`,
    `nn/fusion.py::BEVEncoderTransformer`)."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        yield
        return
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype))


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with float32 statistics, result in x's dtype."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps).to(x.dtype)


def max_pool_ceil(x: torch.Tensor) -> torch.Tensor:
    """VoVNet's 3x3 / stride-2 ceil-mode pool (a last window that would start
    in the padding is dropped, as torch does)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


def max_pool(x: torch.Tensor, window: Tuple[int, int], stride: Tuple[int, int]) -> torch.Tensor:
    """`nn.MaxPool2d(window, stride)` without padding or ceil mode (BevPost's
    (5, 4) pool)."""
    return F.max_pool2d(x, window, stride)


def global_avg_pool(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=keepdim)


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def conv2d(cin: int, cout: int, k: int, dilation: int = 1, stride: int = 1,
           bias: bool = True) -> nn.Conv2d:
    """Conv with torch's symmetric padding dilation*(k-1)//2."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k - 1) // 2,
                     dilation=dilation, bias=bias)


class ConvBnAct(nn.Module):
    """timm's ConvBnAct naming (`.conv`, `.bn`): conv without bias, BN, ReLU.
    A float32 conv that no gradient flows through (eval, and training's
    stage 4, run for its batch-norm statistics), of a shape that kernel 8
    takes (`ops/conv.py::takes`), runs through `conv2d_tf32x3` (the plain
    version on the CPU), the eval ReLU in its epilogue; every other conv
    through `conv_bn`."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.conv = conv2d(cin, cout, k, stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        c = self.conv
        if (x.dtype != torch.float32
                or (torch.is_grad_enabled() and (x.requires_grad or c.weight.requires_grad))
                or not conv_ops.takes(c.in_channels, c.out_channels, c.kernel_size, c.stride,
                                      c.padding, x.shape[-2] * x.shape[-1], c.dilation,
                                      c.groups)):
            return conv_bn(x, c, self.bn, relu=True)
        if self.bn.training:
            y = conv_ops.conv2d_tf32x3(x, c.weight, c.bias, c.stride[0], c.padding[0])
            return train_bn(y, self.bn, relu=True)
        w, b = fold_bn(c, self.bn)
        return conv_ops.conv2d_tf32x3(x, w, b, c.stride[0], c.padding[0], relu=True)


class ConvBNReLU(nn.Sequential):
    """Sequential(conv, bn, ReLU), the original repo's naming (`.0`, `.1`)."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int = 1, bias: bool = True):
        super().__init__(conv2d(cin, cout, k, dilation, bias=bias), nn.BatchNorm2d(cout),
                         nn.ReLU(inplace=True))

    def forward(self, x):
        return conv_bn(x, self[0], self[1], relu=True)


class DropConnect(nn.Module):
    """Per-sample stochastic depth (efficientnet_pytorch's `drop_connect`):
    in training, each sample's branch is kept with probability 1 - rate and
    scaled by 1 / (1 - rate), the mask drawn from torch's default generator
    on x's device (the train step seeds it per step); the identity in
    eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), device=x.device) < keep
        return x / keep * mask.to(x.dtype)


class Up(nn.Module):
    """Bilinear resize of x1 to the skip x2's size (align_corners=True; the
    original's x`scale` upsampling where sizes divide), concat [x2, x1],
    then two conv-BN-ReLU (`conv.0/1`, `conv.3/4`, the original's names)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            conv2d(cin, cout, 3, bias=False), nn.BatchNorm2d(cout), nn.ReLU(inplace=True),
            conv2d(cout, cout, 3, bias=False), nn.BatchNorm2d(cout), nn.ReLU(inplace=True))

    def forward(self, x1, x2):
        x1 = resize_bilinear(x1, x2.shape[-2:], align_corners=True)
        x = torch.cat([x2, x1], dim=1)
        x = conv_bn(x, self.conv[0], self.conv[1], relu=True)
        return conv_bn(x, self.conv[3], self.conv[4], relu=True)
