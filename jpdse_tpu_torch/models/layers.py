"""Layer primitives (NHWC), the port of ``jpdse_tpu/models/layers.py``.

Parameters live in ``nn.Conv2d`` / ``nn.ConvTranspose2d`` submodules nested
as the Flax modules nest (``head.conv.conv.weight`` is Flax's
``head/conv/conv/kernel``), so ``convert.from_jax_params`` is a rename plus
a layout change. Activations stay NHWC; each conv permutes to PyTorch's NCHW
view, which on an NHWC-contiguous tensor is the channels-last layout cuDNN
takes without a copy. Weights are cast to the activation's dtype at the call,
as Flax's ``dtype=`` does.

``norm`` is 'instance', 'identity' or 'batch' (:class:`Norm`,
``layers.py:51-70``). The batch norm is Flax's ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)`` (:class:`BatchNorm`): its scale and bias are parameters,
its running mean and variance buffers, and which statistics it reads is the
norm mode of :func:`norm_mode`, set by the caller (the codec's ``decode``,
the discriminator's ``mode``) and never by ``nn.Module.train()``: the
running averages (``RUNNING``, evaluation and serving, the default), the
batch's (``BATCH``: G's reads of D) or the batch's with the running update
(``UPDATE``: G's decode and D's own loss in the training step). Inside a
training step of a process group (:func:`norm_context` ``world``) the batch
statistics are the global batch's. Convolutions take ``groups`` as Flax's
``feature_group_count``. ``remat`` on a block (``ConvNormAct``,
``ConvTransposeNormAct``, ``ResnetBlock``) recomputes its forward in the
backward instead of keeping its activations, the twin of the JAX package's
block-granular ``nn.remat`` (``jpdse_tpu/models/generator.py:58-68``); it
acts only where autograd records the call, and the recompute runs in the
norm mode of the first forward without the running update, which that
forward made (:func:`replayable`): JAX's remat updates once.

Under the spatial axis (``parallel/spatial.py``'s ``sharding``) an
activation is this rank's rows of H, and the convolutions (a reflect or
replicate pad with its conv through :func:`padded_conv`), the transposed
conv, both norms, the pools and the instance-wise pool compute this rank's
output rows, exchanging halos and reducing statistics over the group.
Outside it every function runs as on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from jpdse_tpu_torch.ops.instance_norm import fused_instance_norm, instance_norm_stats_plain, \
    merge_parts
from jpdse_tpu_torch.parallel import distributed, spatial
from jpdse_tpu_torch.parallel.mesh import draw_rows
from jpdse_tpu_torch.parallel.spatial import reflect_index


def _one(v) -> int:
    """A conv's stride or padding, equal on H and W, as one int."""
    return v[0] if isinstance(v, (tuple, list)) else v


def conv_rows(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """F.conv2d on an NHWC tensor with an OIHW weight, on the rows it is
    given (no halo exchange, also under the spatial axis); returns NHWC."""
    b = None if b is None else b.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, stride, padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def conv_nhwc(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """F.conv2d on an NHWC tensor with an OIHW weight; returns NHWC. Under
    the spatial axis, this rank's output rows (a 1x1 conv needs no other
    rank's)."""
    if spatial.current() is not None and not (w.shape[2] == 1 and _one(stride) == 1
                                              and _one(padding) == 0):
        return spatial.conv2d(x, w.to(x.dtype), None if b is None else b.to(x.dtype),
                              _one(stride), _one(padding), "zero", groups)
    return spatial.like(conv_rows(x, w, b, stride, padding, groups), x)


def conv_transpose_nhwc(x, w, b=None, groups: int = 1):
    """ConvTranspose2d(k3, s2, p1, output_padding=1) on NHWC with the
    (in, out/groups, kh, kw) weight; equals Flax's input-dilated correlation
    with the flipped kernel. Under the spatial axis, this rank's output
    rows."""
    b = None if b is None else b.to(x.dtype)
    if spatial.current() is not None:
        return spatial.conv_transpose2d(x, w.to(x.dtype), b, groups)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b, 2, 1, output_padding=1,
                           groups=groups)
    return y.permute(0, 2, 3, 1)


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
    input) over (H, W), biased variance. Under the spatial axis each rank's
    (count, mean, M2) per (b, c), gathered and merged in rank order: the
    merged count is the global slab's, a rank without rows adding none."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    if spatial.current() is not None:
        n, mean, m2 = merge_parts(spatial.gather(instance_norm_stats_plain(x)))
        mean, var = mean[:, None, None, :], (m2 / n)[:, None, None, :]
    else:
        var, mean = torch.var_mean(x32, dim=(1, 2), keepdim=True, unbiased=False)
    return spatial.like(((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype), x)


# -- the norms' modes -----------------------------------------------------------------
RUNNING, BATCH, UPDATE = "running", "batch", "update"
MOMENTUM, BN_EPS = 0.9, 1e-5


@dataclasses.dataclass(frozen=True)
class NormContext:
    """What a batch norm reads: ``mode`` (:data:`RUNNING`, :data:`BATCH` or
    :data:`UPDATE`); ``world``, batch statistics summed over the process
    group (a training step under a mesh); ``replay``, a remat recompute,
    which reads the batch but leaves the running averages as the first
    forward left them."""

    mode: str = RUNNING
    world: bool = False
    replay: bool = False


_NORM = NormContext()


@contextlib.contextmanager
def norm_context(**changes):
    """While active, the norm context with ``changes`` (fields of
    :class:`NormContext`)."""
    global _NORM
    saved, _NORM = _NORM, dataclasses.replace(_NORM, **changes)
    try:
        yield
    finally:
        _NORM = saved


def norm_state() -> NormContext:
    """The active norm context."""
    return _NORM


def norm_mode(mode: str):
    """:func:`norm_context` with the batch norm's ``mode``."""
    if mode not in (RUNNING, BATCH, UPDATE):
        raise ValueError(f"unknown norm mode {mode!r}")
    return norm_context(mode=mode)


def replayable(fn):
    """``fn`` for ``torch.utils.checkpoint``: its first call runs in the
    current norm context and records it; a recompute in the backward runs
    in that context (whatever the backward's is) with ``replay`` set, so
    the running averages advance once per forward, as under JAX's remat."""
    first = []

    def run(*args):
        if not first:
            first.append(_NORM)
            return fn(*args)
        with norm_context(**dict(dataclasses.asdict(first[0]), replay=True)):
            return fn(*args)

    return run


def batch_stats(x, world: bool = False):
    """(mean, var) per channel of an NHWC tensor over (N, H, W), as Flax's
    ``_compute_stats`` with its fast variance: in at least fp32 (float64
    for a float64 input), ``var = max(E[x^2] - E[x]^2, 0)``, biased. With
    ``world`` the sums and the count are summed over the process group
    (each rank's own rows: the spatial axis's uneven rows count as they
    fall), one differentiable all-reduce whose backward sums the
    gradients, as GSPMD's mean over the sharded batch does."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    s1, s2 = x32.sum(dim=(0, 1, 2)), (x32 * x32).sum(dim=(0, 1, 2))
    n = float(x.shape[0] * x.shape[1] * x.shape[2])
    if world:
        c = s1.shape[0]
        parts = distributed.sum_over_world(torch.cat([s1, s2, s1.new_full((1,), n)]))
        s1, s2, n = parts[:c], parts[c:2 * c], parts[2 * c]
    mean = s1 / n
    return mean, torch.clamp_min(s2 / n - mean * mean, 0.0)


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over the last axis: ``scale`` and ``bias``
    parameters (Flax's ``params``), ``mean`` and ``var`` buffers (its
    ``batch_stats``), read by the norm mode. :data:`UPDATE` moves them
    ``mean <- 0.9 mean + 0.1 batch_mean`` and ``var`` likewise with the
    biased batch variance (not ``nn.BatchNorm2d``'s unbiased one). The
    output is Flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in the statistics' type, one cast to x's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_running_stats(self):
        with torch.no_grad():
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x):
        ctx = _NORM
        if ctx.mode == RUNNING:
            mean, var = self.mean, self.var
            acc = torch.promote_types(x.dtype, mean.dtype)
            mean, var = mean.to(acc), var.to(acc)
        else:
            mean, var = batch_stats(x, ctx.world)
            if ctx.mode == UPDATE and not ctx.replay:
                with torch.no_grad():
                    for buf, new in ((self.mean, mean), (self.var, var)):
                        buf.copy_(MOMENTUM * buf + (1 - MOMENTUM) * new.to(buf.dtype))
        acc = mean.dtype
        mul = torch.rsqrt(var + BN_EPS) * self.scale.to(acc)
        return spatial.like(((x.to(acc) - mean) * mul + self.bias.to(acc)).to(x.dtype), x)


class Norm(nn.Module):
    """``Norm(kind)`` (``layers.py:51-70``) over ``features`` channels: the
    InstanceNorm or the identity, stateless, or the batch norm, held as
    ``BatchNorm_0`` as Flax names it (so ``.../norm/BatchNorm_0/scale`` is
    ``...norm.BatchNorm_0.scale``)."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind not in ("instance", "identity", "batch"):
            raise NotImplementedError(f"norm [{kind}] not found")
        self.kind = kind
        if kind == "batch":
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        if self.kind == "instance":
            return instance_norm(x)
        if self.kind == "batch":
            return self.BatchNorm_0(x)
        return x


def instance_wise_avg_pool(feats, inst, num_segments: int):
    """Every pixel's features replaced by the mean features of its instance
    (``layers.py:323-349``): ids clipped to [0, num_segments - 1], segment
    sums and counts in fp32 by ``index_add_``, one cast to feats' dtype.
    feats (B, H, W, C); inst (B, H, W) or (B, H, W, 1) integer ids. Under
    the spatial axis the sums and counts are summed over the group."""
    if inst.ndim == 4:
        inst = inst[..., 0]
    b, h, w, c = feats.shape
    acc = torch.promote_types(feats.dtype, torch.float32)
    ids = inst.reshape(b, h * w).long().clamp(0, num_segments - 1)
    flat = feats.reshape(b, h * w, c).to(acc)
    sums = torch.stack([f.new_zeros((num_segments, c)).index_add_(0, i, f)
                        for f, i in zip(flat, ids)])
    counts = torch.stack([f.new_zeros(num_segments).index_add_(0, i, f.new_ones(h * w))
                          for f, i in zip(flat, ids)])
    if spatial.current() is not None:
        sums, counts = spatial.sum_over(sums), spatial.sum_over(counts)
    means = sums / counts.clamp_min(1.0)[..., None]
    out = [m.index_select(0, i) for m, i in zip(means, ids)]
    return spatial.like(torch.stack(out).reshape(b, h, w, c).to(feats.dtype), feats)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


def relu(x):
    """ReLU, the output keeping x's global height (``spatial.like``)."""
    return spatial.like(torch.relu(x), x)


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


@functools.lru_cache(maxsize=64)
def _pool_count_rows(hg: int, w: int, lo: int, hi: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """Rows [lo, hi) of the count table of an (hg, w) grid: a rank's rows
    count only at the global edges."""
    with torch.inference_mode(False):
        return torch.from_numpy(_pool_valid_counts(hg, w)[lo:hi].copy()).to(device, dtype)


def _window_sums(x, padding):
    """3x3 / stride-2 window sums of an NHWC tensor, NHWC. On the card the
    pool takes x in the NCHW layout: there F.avg_pool2d's backward of a
    channels-last input is wrong (PyTorch 2.11, cu128: 0.79 of the
    gradient's max-abs against the CPU's in float64; its forward is
    right). The CPU's kernel is right in either layout and keeps the
    channels-last view: there the copy would add a pass and move the fp32
    rounding, which the data-parallel step's fp32 parity at the tiny
    config sits on the edge of (CHANGES.md)."""
    x = x.permute(0, 3, 1, 2)
    if x.is_cuda:
        x = x.contiguous()
    return F.avg_pool2d(x, 3, 2, padding, divisor_override=1).permute(0, 2, 3, 1)


def avg_pool_3s2(x):
    """AvgPool2d(3, stride=2, padding=1, count_include_pad=False) of an NHWC
    tensor: the window sums over the valid-element counts, as the JAX
    package computes it. Under the spatial axis this rank's output rows,
    marked with their global height."""
    shard = spatial.current()
    if shard is not None:
        hg = spatial.global_h(x)
        rows, hout, n = spatial.window_rows(x, hg, 3, 2, 1, "zero")
        sums = _window_sums(rows, (0, 1))[:, :n]
        lo, hi = shard.owned(hout)
        counts = _pool_count_rows(hg, x.shape[2], lo, hi, x.device, x.dtype)
        return spatial.mark(sums / counts[None, :, :, None], hout)
    sums = _window_sums(x, 1)
    return sums / _pool_counts(x.shape[1], x.shape[2], x.device, x.dtype)[None, :, :, None]


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` is set and
    autograd records the call (in the first call's norm mode, without the
    running update: :func:`replayable`)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(replayable(fn), *args, use_reentrant=False)
    return fn(*args)


def _fused_norm(x, relu: bool = False, residual=None):
    """InstanceNorm [+ReLU] [+residual] as one call to kernel K3
    (ops/instance_norm.py), in its partial-statistics form under the
    spatial axis: the group's statistics gathered in rank order, over the
    global slab's count (the backward's divisor; the forward merges the
    ranks' counts), on every rank, one with no rows included."""
    shard, part = spatial.current(), {}
    if shard is not None:
        part = dict(gather=functools.partial(spatial.gather_, shard=shard),
                    count=float(spatial.global_h(x, shard) * x.shape[2]))
    return spatial.like(fused_instance_norm(
        x.contiguous(), None if residual is None else residual.contiguous(), relu=relu, **part),
        x)


PADS = {"reflect": reflect_pad, "replicate": replicate_pad}


def padded_conv(conv: "Conv", x, pad: int, mode: str = "reflect"):
    """``conv`` (a :class:`Conv` without padding of its own) of ``x`` padded
    by ``pad`` rows and columns of ``mode`` ('reflect' or 'replicate');
    under the spatial axis the H pad is the halo exchange, padded at the
    global edges only."""
    if spatial.current() is not None:
        c = conv.conv
        return spatial.conv2d(x, c.weight.to(x.dtype), None if c.bias is None
                              else c.bias.to(x.dtype), _one(c.stride), pad, mode, c.groups)
    return conv(PADS[mode](x, pad))


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """weights_init of the reference: conv kernels normal(0, 0.02), biases 0,
    batch-norm scales normal(1, 0.02) (``batchnorm_gamma_init``,
    ``layers.py:27-31``)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif name.endswith("BatchNorm_0.scale"):
                p.normal_(1.0, 0.02, generator=generator)
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
        self.reflect, self.remat = reflect, remat
        self.fused = fused and norm == "instance"
        self.conv = Conv(in_ch, out_ch, kernel_size, stride, padding, groups=groups)
        self.norm = Norm(norm, out_ch)

    def forward(self, x):
        return remat_call(self.remat, self._forward, x)

    def _forward(self, x):
        h = padded_conv(self.conv, x, self.reflect) if self.reflect else self.conv(x)
        if self.fused:
            return _fused_norm(h, relu=True)
        return relu(self.norm(h))


class ConvTransposeNormAct(nn.Module):
    """ConvTranspose2d(k3, s2, p1, op1) -> norm -> ReLU (one K3 call with
    ``fused`` and an instance norm); with ``groups`` it is also the
    Encoder's ``GroupedConvTransposeNormAct`` (``generator.py:394-411``)."""

    def __init__(self, in_ch: int, out_ch: int, fused: bool = False, remat: bool = False,
                 groups: int = 1, norm: str = "instance"):
        super().__init__()
        self.remat = remat
        self.fused = fused and norm == "instance"
        self.deconv = nn.ConvTranspose2d(in_ch, out_ch, 3, 2, 1, output_padding=1, groups=groups)
        self.norm = Norm(norm, out_ch)

    def forward(self, x):
        return remat_call(self.remat, self._forward, x)

    def _forward(self, x):
        d = self.deconv
        h = conv_transpose_nhwc(x, d.weight, d.bias, d.groups)
        if self.fused:
            return _fused_norm(h, relu=True)
        return relu(self.norm(h))


def dropout_mask(shape, generator: torch.Generator, device, hg: Optional[int] = None
                 ) -> torch.Tensor:
    """The kept positions of Dropout(0.5): True where a uniform draw from
    ``generator`` is below 1/2, as ``jax.random.bernoulli`` keeps (drawn
    for the global batch in a data-parallel step, and at the global height
    ``hg`` under the spatial axis, ``parallel/mesh.py::draw_rows``)."""
    return draw_rows(shape, lambda s: torch.rand(s, generator=generator, device=device),
                     hg) < 0.5


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
        self.remat, self.use_dropout = remat, use_dropout
        self.fused = fused and norm == "instance"
        if padding_type not in ("reflect", "replicate", "zero"):
            raise NotImplementedError(f"padding [{padding_type}]")
        self.pad = None if padding_type == "zero" else padding_type
        p = 1 if self.pad is None else 0
        self.conv1 = Conv(dim, dim, 3, padding=p)
        self.norm1 = Norm(norm, dim)
        self.conv2 = Conv(dim, dim, 3, padding=p)
        self.norm2 = Norm(norm, dim)

    def forward(self, x, deterministic: bool = True, generator=None):
        mask = None
        if self.use_dropout and not deterministic:
            if generator is None:
                raise ValueError("dropout in training needs an explicit torch.Generator")
            # conv1 keeps x's shape
            mask = dropout_mask(x.shape, generator, x.device, hg=spatial.global_h(x))
        return remat_call(self.remat, self._forward, x, mask)

    def _conv(self, conv, x):
        return conv(x) if self.pad is None else padded_conv(conv, x, 1, self.pad)

    def _forward(self, x, mask=None):
        if self.fused:
            h = _fused_norm(self._conv(self.conv1, x), relu=True)
        else:
            h = relu(self.norm1(self._conv(self.conv1, x)))
        if mask is not None:
            h = spatial.like(torch.where(mask, h * 2.0, torch.zeros_like(h)), x)
        if self.fused:
            return _fused_norm(self._conv(self.conv2, h), residual=x)
        return spatial.like(x + self.norm2(self._conv(self.conv2, h)), x)


def build(make, device, generator: Optional[torch.Generator]) -> nn.Module:
    """Construct ``make()`` without initialising on the host, then fill its
    weights on ``device`` from ``generator`` (zeros if None); batch-norm
    running statistics start at mean 0, variance 1."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device=device)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.reset_running_stats()
    if generator is None:
        with torch.no_grad():
            for p in module.parameters():
                p.zero_()
        return module
    return init_weights(module, generator)
