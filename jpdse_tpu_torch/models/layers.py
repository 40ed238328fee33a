"""Layer primitives (NHWC), the port of ``jpdse_tpu/models/layers.py``.

Parameters live in ``nn.Conv2d`` / ``nn.ConvTranspose2d`` submodules nested
as the Flax modules nest (``head.conv.conv.weight`` is Flax's
``head/conv/conv/kernel``), so ``convert.from_jax_params`` is a rename plus
a layout change. Activations stay NHWC; each conv permutes to PyTorch's NCHW
view, which on an NHWC-contiguous tensor is the channels-last layout cuDNN
takes without a copy. Weights are cast to the activation's dtype at the call,
as Flax's ``dtype=`` does.

``norm`` is 'instance' or 'identity' (``Norm``, ``layers.py:41-62``); the
batch norm raises ``NotPorted``. Convolutions take ``groups`` as Flax's
``feature_group_count``. ``remat`` on a block (``ConvNormAct``,
``ConvTransposeNormAct``, ``ResnetBlock``) recomputes its forward in the
backward instead of keeping its activations, the twin of the JAX package's
block-granular ``nn.remat`` (``jpdse_tpu/models/generator.py:58-68``); it
acts only where autograd records the call.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from jpdse_tpu_torch.config import NotPorted
from jpdse_tpu_torch.ops.instance_norm import fused_instance_norm
from jpdse_tpu_torch.parallel.mesh import draw_rows


def conv_nhwc(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """F.conv2d on an NHWC tensor with an OIHW weight; returns NHWC."""
    b = None if b is None else b.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, stride, padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv_transpose_nhwc(x, w, b=None, groups: int = 1):
    """ConvTranspose2d(k3, s2, p1, output_padding=1) on NHWC with the
    (in, out/groups, kh, kw) weight; equals Flax's input-dilated correlation
    with the flipped kernel."""
    b = None if b is None else b.to(x.dtype)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, 2, 1, output_padding=1,
                           groups=groups)
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


def replicate_pad(x, pad: int):
    """nn.ReplicationPad2d(pad), NHWC: the edge row and column repeated."""
    x = x.index_select(1, torch.arange(-pad, x.shape[1] + pad, device=x.device)
                       .clamp(0, x.shape[1] - 1))
    return x.index_select(2, torch.arange(-pad, x.shape[2] + pad, device=x.device)
                          .clamp(0, x.shape[2] - 1))


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm2d(affine=False): fp32 statistics (float64 for a float64
    input) over (H, W), biased variance."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(x32, dim=(1, 2), keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_fn(kind: str):
    """The norm of ``Norm(kind)`` as a function of the activation:
    InstanceNorm or the identity; the batch norm raises ``NotPorted``."""
    if kind == "instance":
        return instance_norm
    if kind == "identity":
        return lambda x: x
    if kind == "batch":
        raise NotPorted("the batch norm (running statistics through the step, checkpoints "
                        "and eval) is ROADMAP Queue 1 item 10's remainder")
    raise NotImplementedError(f"norm [{kind}] not found")


def instance_wise_avg_pool(feats, inst, num_segments: int):
    """Every pixel's features replaced by the mean features of its instance
    (``layers.py:323-349``): ids clipped to [0, num_segments - 1], segment
    sums and counts in fp32 by ``index_add_``, one cast to feats' dtype.
    feats (B, H, W, C); inst (B, H, W) or (B, H, W, 1) integer ids."""
    if inst.ndim == 4:
        inst = inst[..., 0]
    b, h, w, c = feats.shape
    acc = torch.promote_types(feats.dtype, torch.float32)
    ids = inst.reshape(b, h * w).long().clamp(0, num_segments - 1)
    flat = feats.reshape(b, h * w, c).to(acc)
    out = []
    for f, i in zip(flat, ids):
        sums = f.new_zeros((num_segments, c)).index_add_(0, i, f)
        counts = f.new_zeros(num_segments).index_add_(0, i, f.new_ones(h * w))
        out.append((sums / counts.clamp_min(1.0)[:, None]).index_select(0, i))
    return torch.stack(out).reshape(b, h, w, c).to(feats.dtype)


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


@functools.lru_cache(maxsize=64)
def _pool_counts(h: int, w: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`_pool_valid_counts` on ``device``, made once per shape: a
    table as large as the pooled map, not copied to the card each call.
    Made outside inference mode, so autograd may save it later."""
    with torch.inference_mode(False):
        return torch.from_numpy(_pool_valid_counts(h, w)).to(device, dtype)


def avg_pool_3s2(x):
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) of an NHWC
    tensor: the window sums over the valid-element counts, as the JAX
    package computes it."""
    sums = F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1, divisor_override=1).permute(0, 2, 3, 1)
    return sums / _pool_counts(x.shape[1], x.shape[2], x.device, x.dtype)[None, :, :, None]


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
                 padding: int = 0, bias: bool = True, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, padding, bias=bias,
                              groups=groups)

    def forward(self, x):
        c = self.conv
        return conv_nhwc(x, c.weight, c.bias, c.stride, c.padding, c.groups)


class ConvNormAct(nn.Module):
    """[reflect pad] -> conv -> norm -> ReLU; with ``fused`` an instance
    norm and the ReLU are one call to kernel K3."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, reflect: int = 0, fused: bool = False, remat: bool = False,
                 groups: int = 1, norm: str = "instance"):
        super().__init__()
        self.reflect, self.remat, self.norm = reflect, remat, norm_fn(norm)
        self.fused = fused and norm == "instance"
        self.conv = Conv(in_ch, out_ch, kernel_size, stride, padding, groups=groups)

    def forward(self, x):
        return remat_call(self.remat, self._forward, x)

    def _forward(self, x):
        if self.reflect:
            x = reflect_pad(x, self.reflect)
        if self.fused:
            return _fused_norm(self.conv(x), relu=True)
        return torch.relu(self.norm(self.conv(x)))


class ConvTransposeNormAct(nn.Module):
    """ConvTranspose2d(k3, s2, p1, op1) -> norm -> ReLU (one K3 call with
    ``fused`` and an instance norm); with ``groups`` it is also the
    Encoder's ``GroupedConvTransposeNormAct`` (``generator.py:394-411``)."""

    def __init__(self, in_ch: int, out_ch: int, fused: bool = False, remat: bool = False,
                 groups: int = 1, norm: str = "instance"):
        super().__init__()
        self.remat, self.norm = remat, norm_fn(norm)
        self.fused = fused and norm == "instance"
        self.deconv = nn.ConvTranspose2d(in_ch, out_ch, 3, 2, 1, output_padding=1, groups=groups)

    def forward(self, x):
        return remat_call(self.remat, self._forward, x)

    def _forward(self, x):
        d = self.deconv
        h = conv_transpose_nhwc(x, d.weight, d.bias, d.groups)
        if self.fused:
            return _fused_norm(h, relu=True)
        return torch.relu(self.norm(h))


def dropout_mask(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The kept positions of Dropout(0.5): True where a uniform draw from
    ``generator`` is below 1/2, as ``jax.random.bernoulli`` keeps (drawn
    for the global batch in a data-parallel step,
    ``parallel/mesh.py::draw_rows``)."""
    return draw_rows(shape, lambda s: torch.rand(s, generator=generator, device=device)) < 0.5


class ResnetBlock(nn.Module):
    """pix2pixHD residual block: [pad1 conv3 norm relu [dropout] pad1 conv3
    norm] + x, the pad by ``padding_type``: 'reflect', 'replicate' or 'zero'
    (the convs' own padding). With ``fused`` and an instance norm each norm
    is one K3 call, the second taking the skip as its residual.
    ``use_dropout`` (``layers.py:292-311``): in training (``deterministic``
    False) Dropout(0.5) after the first norm's ReLU, the kept values scaled
    by 2; its mask is drawn from the explicit ``generator`` before the block
    runs, so a remat recompute applies the same mask. In evaluation the
    block is as without it."""

    def __init__(self, dim: int, fused: bool = False, remat: bool = False,
                 padding_type: str = "reflect", norm: str = "instance",
                 use_dropout: bool = False):
        super().__init__()
        self.remat, self.norm, self.use_dropout = remat, norm_fn(norm), use_dropout
        self.fused = fused and norm == "instance"
        pads = {"reflect": reflect_pad, "replicate": replicate_pad, "zero": None}
        if padding_type not in pads:
            raise NotImplementedError(f"padding [{padding_type}]")
        self.pad = pads[padding_type]
        p = 1 if self.pad is None else 0
        self.conv1 = Conv(dim, dim, 3, padding=p)
        self.conv2 = Conv(dim, dim, 3, padding=p)

    def forward(self, x, deterministic: bool = True, generator=None):
        mask = None
        if self.use_dropout and not deterministic:
            if generator is None:
                raise ValueError("dropout in training needs an explicit torch.Generator")
            mask = dropout_mask(x.shape, generator, x.device)  # conv1 keeps x's shape
        return remat_call(self.remat, self._forward, x, mask)

    def _padded(self, x):
        return x if self.pad is None else self.pad(x, 1)

    def _forward(self, x, mask=None):
        if self.fused:
            h = _fused_norm(self.conv1(self._padded(x)), relu=True)
        else:
            h = torch.relu(self.norm(self.conv1(self._padded(x))))
        if mask is not None:
            h = torch.where(mask, h * 2.0, torch.zeros_like(h))
        if self.fused:
            return _fused_norm(self.conv2(self._padded(h)), residual=x)
        return x + self.norm(self.conv2(self._padded(h)))


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
