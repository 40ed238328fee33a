"""Layer primitives (NHWC), the port of ``jpdse_tpu/models/layers.py``.

Parameters live in ``nn.Conv2d`` / ``nn.ConvTranspose2d`` submodules nested
as the Flax modules nest (``head.conv.conv.weight`` is Flax's
``head/conv/conv/kernel``), so ``convert.from_jax_params`` is a rename plus
a layout change. Activations stay NHWC; each conv permutes to PyTorch's NCHW
view, which on an NHWC-contiguous tensor is the channels-last layout cuDNN
takes without a copy. Weights are cast to the activation's dtype at the call,
as Flax's ``dtype=`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


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
    """InstanceNorm2d(affine=False): fp32 statistics over (H, W), biased
    variance."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


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
    """[reflect pad] -> conv -> InstanceNorm -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, reflect: int = 0):
        super().__init__()
        self.reflect = reflect
        self.conv = Conv(in_ch, out_ch, kernel_size, stride, padding)

    def forward(self, x):
        if self.reflect:
            x = reflect_pad(x, self.reflect)
        return torch.relu(instance_norm(self.conv(x)))


class ConvTransposeNormAct(nn.Module):
    """ConvTranspose2d(k3, s2, p1, op1) -> InstanceNorm -> ReLU. Also serves
    as the Encoder's ``GroupedConvTransposeNormAct`` at groups=1, the only
    grouping ported."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_ch, out_ch, 3, 2, 1, output_padding=1)

    def forward(self, x):
        return torch.relu(instance_norm(conv_transpose_nhwc(x, self.deconv.weight, self.deconv.bias)))


class ResnetBlock(nn.Module):
    """pix2pixHD residual block: [pad1 conv3 norm relu pad1 conv3 norm] + x."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3)
        self.conv2 = Conv(dim, dim, 3)

    def forward(self, x):
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
