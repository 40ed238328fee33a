"""Layer primitives (NHWC), the port of ``jpdse_tpu/models/layers.py``.

Parameters live in ``nn.Conv2d`` / ``nn.ConvTranspose2d`` submodules nested
as the Flax modules nest (``head.conv.conv.weight`` is Flax's
``head/conv/conv/kernel``), so ``convert.from_jax_params`` is a rename plus
a layout change. Activations stay NHWC; each conv permutes to PyTorch's NCHW
view, which on an NHWC-contiguous tensor is the channels-last layout cuDNN
takes without a copy. Weights are cast to the activation's dtype at the call,
as Flax's ``dtype=`` does.

``remat`` on a block (``ConvNormAct``, ``ConvTransposeNormAct``,
``ResnetBlock``) recomputes its forward in the backward instead of keeping
its activations, the twin of the JAX package's block-granular ``nn.remat``
(``jpdse_tpu/models/generator.py:58-68``); it acts only where autograd
records the call.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from jpdse_tpu_torch.ops.instance_norm import fused_instance_norm


def conv_nhwc(x, w, b=None, stride: int = 1, padding: int = 0):
    """F.conv2d on an NHWC tensor with an OIHW weight; returns NHWC."""
    b = None if b is None else b.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, stride, padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose_nhwc(x, w, b=None):
    """ConvTranspose2d(k3, s2, p1, output_padding=1) on NHWC with the
    (in, out, kh, kw) weight; equals Flax's input-dilated correlation with
    the flipped kernel."""
    b = None if b is None else b.to(x.dtype)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, 2, 1, output_padding=1)
    return y.permute(0, 2, 3, 1)


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of a reflection pad (edge not repeated) of length n."""
    i = torch.arange(-before, n + after, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def reflect_pad_hw(x, top: int, bottom: int, left: int, right: int):
    """Reflection pad of an NHWC tensor's H and W axes."""
    if max(top, bottom) >= x.shape[1] or max(left, right) >= x.shape[2]:
        raise ValueError(f"reflect pad larger than the input {tuple(x.shape)}")
    x = x.index_select(1, reflect_index(x.shape[1], top, bottom, x.device))
    return x.index_select(2, reflect_index(x.shape[2], left, right, x.device))


def reflect_pad(x, pad: int):
    """nn.ReflectionPad2d(pad), NHWC."""
    return reflect_pad_hw(x, pad, pad, pad, pad)


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d(affine=False): fp32 statistics (float64 for a float64
    input) over (H, W), biased variance."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(x32, dim=(1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


@functools.lru_cache(maxsize=64)
def _pool_valid_counts(h: int, w: int) -> np.ndarray:
    """Valid-element counts of a 3x3 / stride-2 / pad-1 window over an (h, w)
    grid."""
    oh, ow = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    ch = np.array([min(2 * i + 2, h) - max(2 * i - 1, 0) for i in range(oh)], np.float32)
    cw = np.array([min(2 * j + 2, w) - max(2 * j - 1, 0) for j in range(ow)], np.float32)
    return np.outer(ch, cw)


def avg_pool_3s2(x):
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) of an NHWC
    tensor: the window sums over the valid-element counts, as the JAX
    package computes it."""
    sums = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1, divisor_override=1).permute(0, 2, 3, 1)
    counts = torch.from_numpy(_pool_valid_counts(x.shape[1], x.shape[2])).to(x.device, x.dtype)
    return sums / counts[None, :, :, None]


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` is set and
    autograd records the call."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _fused_norm(x, relu: bool = False, residual=None):
    """InstanceNorm [+ReLU] [+residual] as one call to kernel K3
    (ops/instance_norm.py)."""
    return fused_instance_norm(
        x.contiguous(), None if residual is None else residual.contiguous(), relu=relu)


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """weights_init of the reference: conv kernels normal(0, 0.02), biases 0."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return module


class Conv(nn.Module):
    """torch-style Conv2d (zero padding), NHWC."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=bias)

    def forward(self, x):
        c = self.conv
        return conv_nhwc(x, c.weight, c.bias, c.stride, c.padding)


class ConvNormAct(nn.Module):
    """[reflect pad] -> conv -> InstanceNorm -> ReLU; with ``fused`` the
    norm and ReLU are one call to kernel K3."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, reflect: int = 0, fused: bool = False, remat: bool = False):
        super().__init__()
        self.reflect, self.fused, self.remat = reflect, fused, remat
        self.conv = Conv(in_ch, out_ch, kernel_size, stride, padding)

    def forward(self, x):
        return remat_call(self.remat, self._forward, x)

    def _forward(self, x):
        if self.reflect:
            x = reflect_pad(x, self.reflect)
        if self.fused:
            return _fused_norm(self.conv(x), relu=True)
        return torch.relu(instance_norm(self.conv(x)))


class ConvTransposeNormAct(nn.Module):
    """ConvTranspose2d(k3, s2, p1, op1) -> InstanceNorm -> ReLU (one K3 call
    with ``fused``). Also serves as the Encoder's
    ``GroupedConvTransposeNormAct`` at groups=1, the only grouping ported."""

    def __init__(self, in_ch: int, out_ch: int, fused: bool = False, remat: bool = False):
        super().__init__()
        self.fused, self.remat = fused, remat
        self.deconv = nn.ConvTranspose2d(in_ch, out_ch, 3, 2, 1, output_padding=1)

    def forward(self, x):
        return remat_call(self.remat, self._forward, x)

    def _forward(self, x):
        h = conv_transpose_nhwc(x, self.deconv.weight, self.deconv.bias)
        if self.fused:
            return _fused_norm(h, relu=True)
        return torch.relu(instance_norm(h))


class ResnetBlock(nn.Module):
    """pix2pixHD residual block: [pad1 conv3 norm relu pad1 conv3 norm] + x.
    With ``fused`` each norm is one K3 call, the second taking the skip as
    its residual."""

    def __init__(self, dim: int, fused: bool = False, remat: bool = False):
        super().__init__()
        self.fused, self.remat = fused, remat
        self.conv1 = Conv(dim, dim, 3)
        self.conv2 = Conv(dim, dim, 3)

    def forward(self, x):
        return remat_call(self.remat, self._forward, x)

    def _forward(self, x):
        if self.fused:
            h = _fused_norm(self.conv1(reflect_pad(x, 1)), relu=True)
            return _fused_norm(self.conv2(reflect_pad(h, 1)), residual=x)
        h = torch.relu(instance_norm(self.conv1(reflect_pad(x, 1))))
        return x + instance_norm(self.conv2(reflect_pad(h, 1)))


def build(make, device, generator: Optional[torch.Generator]) -> nn.Module:
    """Construct ``make()`` without initialising on the host, then fill its
    weights on ``device`` from ``generator`` (zeros if None)."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    if generator is None:
        with torch.no_grad():
            for p in module.parameters():
                p.zero_()
        return module
    return init_weights(module, generator)
