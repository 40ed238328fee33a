"""Fused InstanceNorm (+ReLU) (+residual) (kernel K3) and its backward, the
port of ``jpdse_tpu/ops/pallas/instance_norm.py::fused_instance_norm`` and
its custom VJP ``_fused_in_bwd``.

With ``model.fused_instance_norm`` on, every norm site of the standard
path's modules (``models/layers.py``, ``models/generator.py``) runs as one
call: fp32 statistics over H x W (mean, then the biased variance about it,
eps 1e-5, no affine), then ReLU if asked, then the residual added in fp32,
then one cast to the input's dtype. The CUDA kernel
(``csrc/instance_norm.cu``) is one cooperative launch that splits each slab
across the blocks resident on the card (:func:`plan`), so it takes a slab
of any size; :func:`fused_instance_norm_plain` is its plain PyTorch
version, which the wrapper takes for CPU tensors.

Under autograd the call is :class:`FusedInstanceNorm`: its forward keeps x
and, on the card, K3's fp32 per-(b, c) mean and rstd; its backward is a
second kernel of the same file (``instance_norm_bwd_kernel``, one
cooperative launch on the forward's partition that keeps the first
:func:`bwd_cache_iters` loop iterations of each block's x and g in shared
memory, streams the rest through a ring of ``RING`` slots, and walks its
second pass in reverse, :func:`bwd_walk`), wrapped by
:func:`fused_instance_norm_bwd`, whose plain version
:func:`fused_instance_norm_bwd_plain` recomputes the statistics from x as
JAX's ``_fused_in_bwd`` does. The residual's gradient is the output's.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from jpdse_tpu_torch.ops import build

THREADS = 512  # csrc/instance_norm.cu kThreads
MAX_CHUNKS = 1024  # bounds the partials' workspace; the launcher keeps to it
SMEM_OPTIN = 232448  # shared memory a block may opt in to on an H100 (227 KiB)
RING = 3  # csrc/instance_norm.cu kRing: the backward's cp.async ring, in slots


def _acc(x: torch.Tensor) -> torch.dtype:
    """The type the plain versions compute in: fp32, or float64 for a
    float64 input (the gradient check)."""
    return torch.promote_types(x.dtype, torch.float32)


def fused_instance_norm_plain(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                              relu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm(x) [+ReLU] [+residual] over (H, W) of an NHWC tensor:
    two-pass fp32 statistics, the residual added in fp32, one cast."""
    x32 = x.to(_acc(x))
    mean = x32.mean(dim=(1, 2), keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=(1, 2), keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y.to(x.dtype)


def fused_instance_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor, relu: bool = False,
                                  eps: float = 1e-5,
                                  stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx of :func:`fused_instance_norm_plain` for the output's gradient g,
    the mirror of JAX's ``_fused_in_bwd``: statistics recomputed from x in
    fp32, g masked by xhat > 0 under ReLU, dx = rstd * (g - mean(g) - xhat
    * mean(g * xhat)), one cast to x's dtype. Given ``stats``, the
    forward's fp32 (b, c, 2) mean and rstd, it uses them as the kernel
    does: the same xhat, so the same side of the ReLU's kink where xhat is
    0 to rounding."""
    acc = _acc(x)
    x32, g32 = x.to(acc), g.to(acc)
    if stats is None:
        mean = x32.mean(dim=(1, 2), keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=(1, 2), keepdim=True)
        rstd = torch.rsqrt(var + eps)
    else:
        mean, rstd = (stats[..., i, None, None].transpose(1, 3).to(acc) for i in (0, 1))
    xhat = (x32 - mean) * rstd
    if relu:
        g32 = torch.where(xhat > 0, g32, torch.zeros((), dtype=acc))
    gm = g32.mean(dim=(1, 2), keepdim=True)
    gx = (g32 * xhat).mean(dim=(1, 2), keepdim=True)
    return (rstd * (g32 - gm - xhat * gx)).to(x.dtype)


def vector_width(c: int, elt_size: int, aligned: bool = True) -> int:
    """Channels a thread moves as one word: 16 bytes' worth when C divides
    into them and the pointers are 16-byte aligned, else 1."""
    v = 16 // elt_size
    return v if aligned and c % v == 0 else 1


def _tiling(c: int, vec: int):
    """(channel groups, groups per item, channel tiles, pixel lanes), as
    the kernel's ``Plan`` derives them."""
    groups = c // vec
    tile = min(groups, THREADS)
    return groups, tile, -(-groups // tile), THREADS // tile


def max_chunks(hw: int, c: int, vec: int) -> int:
    """The most chunks :func:`plan` cuts a slab into, on any card: the
    partials' workspace is sized by it."""
    return min(MAX_CHUNKS, -(-hw // _tiling(c, vec)[3]))


def plan(b: int, hw: int, c: int, vec: int, max_blocks: int):
    """(grid, chunks, rows_per_chunk) of one launch on a card that holds
    ``max_blocks`` resident blocks (SM count x blocks per SM), the mirror
    of the launcher's ``make_plan``. Each slab, a batch element's rows for
    one channel tile, is cut into ``chunks`` chunks of ``rows_per_chunk``
    rows, one block item each; with more slabs than blocks, a block takes
    whole slabs in turn (:func:`block_items`)."""
    _, _, tiles, _ = _tiling(c, vec)
    slabs = b * tiles
    chunks = 1 if slabs >= max_blocks else min(max_blocks // slabs, max_chunks(hw, c, vec))
    rows = -(-hw // chunks)
    chunks = -(-hw // rows)
    return min(max_blocks, slabs * chunks), chunks, rows


def block_items(b: int, hw: int, c: int, vec: int, grid: int, chunks: int, rows: int):
    """Block k's items in the kernel's order, as (batch element, first and
    end channel, first and end row): the numpy-free mirror of the kernel's
    ``item`` and its loop ``q = blockIdx.x; q < items; q += gridDim.x``."""
    groups, tile, tiles, _ = _tiling(c, vec)
    out = [[] for _ in range(grid)]
    for k in range(grid):
        for q in range(k, b * tiles * chunks, grid):
            slab, chunk = divmod(q, chunks)
            bi, t = divmod(slab, tiles)
            g0, g1 = t * tile, min((t + 1) * tile, groups)
            out[k].append((bi, g0 * vec, g1 * vec, chunk * rows, min((chunk + 1) * rows, hw)))
    return out


def bwd_cache_iters(vec: int, elt_size: int, smem: int = SMEM_OPTIN) -> int:
    """Cache slots of a block of the backward kernel, as its launcher
    ``run_bwd`` sets ``cache_iters``: the slots of one x word and one g word
    a thread that the opt-in budget ``smem`` holds after the ``RING`` ring
    slots (which the reduction area, 2 V fp32 sums a thread, lies over)."""
    return smem // (THREADS * 2 * vec * elt_size) - RING


def bwd_walk(b: int, hw: int, c: int, vec: int, grid: int, chunks: int, rows: int,
             cache_iters: int, phase: int):
    """Each block's steps in phase 1 or phase 3 (``phase``) of the backward
    kernel, the mirror of its loops: a step is (item, k, slot), the item as
    :func:`block_items` gives it, k the loop iteration whose rows are
    r0 + lane + k * pix for the block's pixel lanes, and slot the
    shared-memory slot its x and g words pass through: ("cache", i) or
    ("ring", i). In phase 1 a block takes its items in order and each
    item's iterations in order; the first ``cache_iters`` iterations it
    meets stay in cache slots 0, 1, ..., and the others pass through the
    ring in turn. In phase 3 it takes its items from the last, each one's
    uncached iterations from the last down, through the ring in turn, then
    its cached ones from the last down. The kernel copies a step into its
    slot ``RING`` steps ahead of summing it (every cached step of an item
    at once, with its first ``RING`` ring steps)."""
    pix = _tiling(c, vec)[3]
    out = []
    for items in block_items(b, hw, c, vec, grid, chunks, rows):
        iters = [-(-(it[4] - it[3]) // pix) for it in items]
        steps = []
        count = 0 if phase == 1 else sum(iters)
        walk = list(zip(items, iters))
        for w, n in walk if phase == 1 else walk[::-1]:
            if phase != 1:
                count -= n
            kc = min(max(cache_iters - count, 0), n)
            if phase == 1:
                steps += [(w, k, ("cache", count + k) if k < kc else ("ring", (k - kc) % RING))
                          for k in range(n)]
                count += n
            else:
                steps += [(w, n - 1 - t, ("ring", t % RING)) for t in range(n - kc)]
                steps += [(w, k, ("cache", count + k)) for k in range(kc - 1, -1, -1)]
        out.append(steps)
    return out


@functools.cache
def _launcher():
    return build.c_function("instance_norm", "instance_norm_launch", "pppppliiiiiif")


@functools.cache
def _bwd_launcher():
    return build.c_function("instance_norm", "instance_norm_bwd_launch", "ppppppliiiiii")


def _check_shapes(x: torch.Tensor, other: Optional[torch.Tensor], what: str) -> None:
    if x.ndim != 4:
        raise ValueError(f"expected (B, H, W, C), got shape {tuple(x.shape)}")
    if other is not None and other.shape != x.shape:
        raise ValueError(f"{what} {tuple(other.shape)} differs from x {tuple(x.shape)}")


def _aligned_vec(c: int, *tensors: torch.Tensor) -> int:
    return vector_width(c, tensors[0].element_size(),
                        all(t.data_ptr() % 16 == 0 for t in tensors))


def _forward(x: torch.Tensor, residual: Optional[torch.Tensor], relu: bool, eps: float):
    """(y, statistics): the plain version and None for a CPU tensor; on the
    card K3's output and its fp32 (b, c, 2) mean and rstd."""
    if x.device.type == "cpu":
        return fused_instance_norm_plain(x, residual, relu, eps), None
    build.check_operand("fused_instance_norm", x)
    if residual is not None:
        build.check_operand("fused_instance_norm", residual, (x.dtype,))
    b, h, w, c = x.shape
    hw = h * w
    y = x.new_empty(x.shape)
    vec = _aligned_vec(c, x, y, *([] if residual is None else [residual]))
    cap = max_chunks(hw, c, vec)
    partial = x.new_empty(b * cap * c * 3, dtype=torch.float32)
    stats = x.new_empty((b, c, 2), dtype=torch.float32)
    build.launch("fused_instance_norm", _launcher(), x, x.data_ptr(),
                 0 if residual is None else residual.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), hw, b, c, cap,
                 int(relu), int(vec > 1), x.element_size(), eps)
    fused_instance_norm.launches += 1
    return y, stats


def fused_instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, stats: Optional[torch.Tensor],
                            relu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """dx of :func:`fused_instance_norm` for the output's gradient g. A CUDA
    tensor runs the backward kernel on the forward's statistics ``stats``
    (fp32 (b, c, 2) mean and rstd) or raises; a CPU tensor takes the plain
    version, which recomputes them. ``fused_instance_norm_bwd.launches``
    counts kernel launches."""
    _check_shapes(x, g, "g")
    if x.device.type == "cpu":
        return fused_instance_norm_bwd_plain(x, g, relu, eps)
    build.check_operand("fused_instance_norm_bwd", x)
    build.check_operand("fused_instance_norm_bwd", g, (x.dtype,))
    b, h, w, c = x.shape
    if stats is None or stats.shape != (b, c, 2):
        raise ValueError(f"fused_instance_norm_bwd: statistics of shape {(b, c, 2)} expected")
    build.check_operand("fused_instance_norm_bwd", stats, (torch.float32,))
    hw = h * w
    dx = x.new_empty(x.shape)
    vec = _aligned_vec(c, x, g, dx)
    cap = max_chunks(hw, c, vec)
    partial = x.new_empty(b * cap * c * 2, dtype=torch.float32)
    means = x.new_empty((b, c, 2), dtype=torch.float32)
    build.launch("fused_instance_norm_bwd", _bwd_launcher(), x, x.data_ptr(), g.data_ptr(),
                 stats.data_ptr(), dx.data_ptr(), partial.data_ptr(), means.data_ptr(), hw, b,
                 c, cap, int(relu), int(vec > 1), x.element_size())
    fused_instance_norm_bwd.launches += 1
    return dx


fused_instance_norm_bwd.launches = 0


class FusedInstanceNorm(torch.autograd.Function):
    """K3 under autograd, the twin of JAX's ``_fused_in`` custom VJP: the
    forward keeps x and the statistics, the backward launches
    :func:`fused_instance_norm_bwd` for x and hands the output's gradient
    to the residual. ``grad_copies`` counts the output gradients that came
    in strided and were copied before the launch."""

    grad_copies = 0

    @staticmethod
    def forward(ctx, x, residual, relu: bool, eps: float):
        y, stats = _forward(x, residual, relu, eps)
        ctx.save_for_backward(x, stats)
        ctx.relu, ctx.eps, ctx.has_res = relu, eps, residual is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        dx = dres = None
        if ctx.needs_input_grad[0]:
            if not g.is_contiguous():
                FusedInstanceNorm.grad_copies += 1
                g = g.contiguous()
            dx = fused_instance_norm_bwd(x, g, stats, ctx.relu, ctx.eps)
        if ctx.has_res and ctx.needs_input_grad[1]:
            dres = g
        return dx, dres, None, None


def fused_instance_norm(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm(x) [+ReLU] [+residual] of an NHWC tensor (B, H, W, C),
    in x's dtype. A CUDA tensor runs the kernel (or raises); a CPU tensor
    takes the plain version. Differentiable: where autograd needs a
    gradient the call is :class:`FusedInstanceNorm`.
    ``fused_instance_norm.launches`` counts kernel launches."""
    _check_shapes(x, residual, "residual")
    if torch.is_grad_enabled() and (
            x.requires_grad or (residual is not None and residual.requires_grad)):
        return FusedInstanceNorm.apply(x, residual, relu, eps)
    return _forward(x, residual, relu, eps)[0]


fused_instance_norm.launches = 0
