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

Under the spatial axis the call takes the partial-statistics form: two
launches each way (stats then apply; sums then dx), the ranks' statistics
gathered between them. The stats and sums launches are ordinary launches
of one CTA per chunk of rows (:func:`partial_plan` asks the built library
for their partition and workspace, ``csrc/part_plan.h``) that merge their
chunks through ticket counters kept per device and stream, in a fixed
order, so two runs give the same bits. The apply and dx launches need no
workspace: their partition (``part_plan.h``'s ``make_apply_plan``, 264
to 1056 CTAs by the slab's size, each merging the ranks' statistics once)
lives in the library alone.
"""

from __future__ import annotations

import ctypes
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
    partials' workspace is sized by it (one for a slab of no rows)."""
    return max(1, min(MAX_CHUNKS, -(-hw // _tiling(c, vec)[3])))


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
    rows = max(1, -(-hw // chunks))
    chunks = max(1, -(-hw // rows))  # a slab of no rows: one chunk of none
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



# -- the partial-statistics form (the spatial axis) ------------------------------------
@functools.lru_cache(maxsize=256)
def partial_plan(b: int, hw: int, c: int, vec: int):
    """(grid, chunks a slab, rows a chunk, words a tile, rows a stage, fp32
    workspace, int counters) of the stats and sums launches on (b, hw, c)
    with ``vec`` channels a word: ``instance_norm_part_plan`` of
    ``csrc/part_plan.h``, the partition the launchers use, from the built
    library."""
    fn = build.load_library("instance_norm").instance_norm_part_plan
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 7)()
    if fn(hw, b, c, vec, out) != 0:
        raise ValueError(f"no partial launch takes (b, hw, c, vec) = {(b, hw, c, vec)}")
    return tuple(out)


# the ticket counters of the stats and sums launches, by (device, stream):
# zeroed when made, left zeroed by every launch (the CTA that takes a
# counter's last ticket resets it), so launches on one stream share them
_TICKETS: dict = {}


def _tickets(x: torch.Tensor, n: int) -> torch.Tensor:
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=x.device)
        _TICKETS[key] = t
    return t


def instance_norm_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """This rank's (count, mean, M2) per (b, c) of an NHWC slab, (B, C, 3)
    in the plain versions' type: M2 the sum of squares about the mean."""
    acc = _acc(x)
    x32 = x.to(acc)
    n = x.shape[1] * x.shape[2]
    mean = x32.sum(dim=(1, 2)) / max(n, 1)
    m2 = ((x32 - mean[:, None, None, :]) ** 2).sum(dim=(1, 2))
    return torch.stack([torch.full_like(mean, n), mean, m2], dim=-1)


def merge_parts(parts: torch.Tensor):
    """(count, mean, M2), each (B, C), of the ranks' (S, B, C, 3) merged by
    Chan's formula in rank order, as the apply kernel merges them."""
    n = mean = m2 = torch.zeros_like(parts[0, ..., 0])
    for part in parts:
        nb, mb, m2b = part.unbind(-1)
        nt = n + nb
        wb = torch.where(nt > 0, nb / torch.where(nt > 0, nt, 1.0), 0.0)
        delta = mb - mean
        mean = mean + delta * wb
        m2 = m2 + m2b + delta * delta * n * wb
        n = nt
    return n, mean, m2


def instance_norm_apply_plain(x: torch.Tensor, residual: Optional[torch.Tensor],
                              parts: torch.Tensor, relu: bool = False, eps: float = 1e-5):
    """(y, (B, C, 2) mean and rstd): the ranks' statistics ``parts`` merged
    in rank order, x normalized [+ReLU] [+residual in fp32], one cast."""
    acc = _acc(x)
    n, mean, m2 = merge_parts(parts.to(acc))
    rstd = torch.rsqrt(m2 / n + eps)
    y = (x.to(acc) - mean[:, None, None, :]) * rstd[:, None, None, :]
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.to(acc)
    return y.to(x.dtype), torch.stack([mean, rstd], dim=-1)


def _xhat_g(x, g, ms, relu):
    acc = _acc(x)
    mean, rstd = (ms[..., i].to(acc)[:, None, None, :] for i in (0, 1))
    xhat = (x.to(acc) - mean) * rstd
    g32 = g.to(acc)
    if relu:
        g32 = torch.where(xhat > 0, g32, torch.zeros((), dtype=acc))
    return xhat, g32, rstd


def instance_norm_bwd_sums_plain(x: torch.Tensor, g: torch.Tensor, ms: torch.Tensor,
                                 relu: bool = False) -> torch.Tensor:
    """This rank's sums of g' and g' * xhat per (b, c), (B, C, 2), from the
    forward's mean and rstd ``ms``."""
    xhat, g32, _ = _xhat_g(x, g, ms, relu)
    return torch.stack([g32.sum(dim=(1, 2)), (g32 * xhat).sum(dim=(1, 2))], dim=-1)


def instance_norm_bwd_dx_plain(x: torch.Tensor, g: torch.Tensor, ms: torch.Tensor,
                               parts: torch.Tensor, count: float,
                               relu: bool = False) -> torch.Tensor:
    """dx from the ranks' sums ``parts`` (S, B, C, 2), added in rank order
    and divided by the global slab's ``count``."""
    xhat, g32, rstd = _xhat_g(x, g, ms, relu)
    total = parts[0].to(g32.dtype)
    for part in parts[1:]:
        total = total + part.to(g32.dtype)
    gm, gx = (total[..., i][:, None, None, :] / count for i in (0, 1))
    return (rstd * (g32 - gm - xhat * gx)).to(x.dtype)


@functools.cache
def _stats_launcher():
    return build.c_function("instance_norm", "instance_norm_stats_launch", "ppppliiii")


@functools.cache
def _apply_launcher():
    return build.c_function("instance_norm", "instance_norm_apply_launch", "ppppplii" "iiiif")


@functools.cache
def _sums_launcher():
    return build.c_function("instance_norm", "instance_norm_bwd_sums_launch", "ppppppliiiii")


@functools.cache
def _dx_launcher():
    return build.c_function("instance_norm", "instance_norm_bwd_dx_launch", "pppppl" "iiiiiif")


def instance_norm_stats(x: torch.Tensor) -> torch.Tensor:
    """This rank's (count, mean, M2) per (b, c), (B, C, 3): the stats launch
    on the card (fp32), the plain version on the CPU. A slab of no rows (a
    rank that owns none of an uneven split) launches too and gives
    (0, 0, 0); so do the apply, sums and dx launches take it.
    ``instance_norm_stats.launches`` counts kernel launches."""
    _check_shapes(x, None, "")
    if x.device.type == "cpu":
        return instance_norm_stats_plain(x)
    build.check_operand("instance_norm_stats", x)
    b, h, w, c = x.shape
    vec = _aligned_vec(c, x)
    floats, counters = partial_plan(b, h * w, c, vec)[5:]
    partial = x.new_empty(floats, dtype=torch.float32)
    out = x.new_empty((b, c, 3), dtype=torch.float32)
    build.launch("instance_norm_stats", _stats_launcher(), x, x.data_ptr(), partial.data_ptr(),
        _tickets(x, counters).data_ptr(), out.data_ptr(), h * w, b, c, int(vec > 1),
        x.element_size())
    instance_norm_stats.launches += 1
    return out


instance_norm_stats.launches = 0


def instance_norm_apply(x: torch.Tensor, residual: Optional[torch.Tensor], parts: torch.Tensor,
                        relu: bool = False, eps: float = 1e-5):
    """(y, (B, C, 2) mean and rstd) from the ranks' statistics ``parts``
    (S, B, C, 3): the apply launch on the card, the plain version on the
    CPU. ``instance_norm_apply.launches`` counts kernel launches."""
    _check_shapes(x, residual, "residual")
    if x.device.type == "cpu":
        return instance_norm_apply_plain(x, residual, parts, relu, eps)
    build.check_operand("instance_norm_apply", x)
    if residual is not None:
        build.check_operand("instance_norm_apply", residual, (x.dtype,))
    build.check_operand("instance_norm_apply", parts, (torch.float32,))
    b, h, w, c = x.shape
    if parts.shape[1:] != (b, c, 3):
        raise ValueError(f"instance_norm_apply: statistics of shape (S, {b}, {c}, 3) expected")
    y = x.new_empty(x.shape)
    ms = x.new_empty((b, c, 2), dtype=torch.float32)
    vec = _aligned_vec(c, x, y, *([] if residual is None else [residual]))
    build.launch("instance_norm_apply", _apply_launcher(), x, x.data_ptr(),
        0 if residual is None else residual.data_ptr(), y.data_ptr(), parts.data_ptr(),
        ms.data_ptr(), h * w, b, c, parts.shape[0], int(relu), int(vec > 1), x.element_size(),
        eps)
    instance_norm_apply.launches += 1
    return y, ms


instance_norm_apply.launches = 0


def instance_norm_bwd_sums(x: torch.Tensor, g: torch.Tensor, ms: torch.Tensor,
                           relu: bool = False) -> torch.Tensor:
    """This rank's sums of g' and g' * xhat per (b, c), (B, C, 2): the sums
    launch on the card, the plain version on the CPU.
    ``instance_norm_bwd_sums.launches`` counts kernel launches."""
    _check_shapes(x, g, "g")
    if x.device.type == "cpu":
        return instance_norm_bwd_sums_plain(x, g, ms, relu)
    build.check_operand("instance_norm_bwd_sums", x)
    build.check_operand("instance_norm_bwd_sums", g, (x.dtype,))
    build.check_operand("instance_norm_bwd_sums", ms, (torch.float32,))
    b, h, w, c = x.shape
    vec = _aligned_vec(c, x, g)
    floats, counters = partial_plan(b, h * w, c, vec)[5:]
    partial = x.new_empty(floats, dtype=torch.float32)
    out = x.new_empty((b, c, 2), dtype=torch.float32)
    build.launch("instance_norm_bwd_sums", _sums_launcher(), x, x.data_ptr(), g.data_ptr(),
        ms.data_ptr(), partial.data_ptr(), _tickets(x, counters).data_ptr(), out.data_ptr(),
        h * w, b, c, int(relu), int(vec > 1), x.element_size())
    instance_norm_bwd_sums.launches += 1
    return out


instance_norm_bwd_sums.launches = 0


def instance_norm_bwd_dx(x: torch.Tensor, g: torch.Tensor, ms: torch.Tensor,
                         parts: torch.Tensor, count: float, relu: bool = False) -> torch.Tensor:
    """dx from the ranks' sums ``parts`` (S, B, C, 2) and the global slab's
    ``count``: the dx launch on the card, the plain version on the CPU.
    ``instance_norm_bwd_dx.launches`` counts kernel launches."""
    _check_shapes(x, g, "g")
    if x.device.type == "cpu":
        return instance_norm_bwd_dx_plain(x, g, ms, parts, count, relu)
    build.check_operand("instance_norm_bwd_dx", x)
    build.check_operand("instance_norm_bwd_dx", g, (x.dtype,))
    for t in (ms, parts):
        build.check_operand("instance_norm_bwd_dx", t, (torch.float32,))
    b, h, w, c = x.shape
    dx = x.new_empty(x.shape)
    vec = _aligned_vec(c, x, g, dx)
    build.launch("instance_norm_bwd_dx", _dx_launcher(), x, x.data_ptr(), g.data_ptr(),
        ms.data_ptr(), parts.data_ptr(), dx.data_ptr(), h * w, b, c, parts.shape[0], int(relu),
        int(vec > 1), x.element_size(), float(count))
    instance_norm_bwd_dx.launches += 1
    return dx


instance_norm_bwd_dx.launches = 0


def _partial_forward(x, residual, relu, eps, gather):
    """(y, mean and rstd) of this rank's rows: stats, the ranks' statistics
    gathered in rank order, apply."""
    return instance_norm_apply(x, residual, gather(instance_norm_stats(x)), relu, eps)


class FusedInstanceNorm(torch.autograd.Function):
    """K3 under autograd, the twin of JAX's ``_fused_in`` custom VJP: the
    forward keeps x and the statistics, the backward launches
    :func:`fused_instance_norm_bwd` for x and hands the output's gradient
    to the residual. ``grad_copies`` counts the output gradients that came
    in strided and were copied before the launch. Given ``gather`` and
    ``count`` (see :func:`fused_instance_norm`), both directions take the
    partial-statistics form."""

    grad_copies = 0

    @staticmethod
    def forward(ctx, x, residual, relu: bool, eps: float, gather=None, count=None):
        if gather is None:
            y, stats = _forward(x, residual, relu, eps)
        else:
            y, stats = _partial_forward(x, residual, relu, eps, gather)
        ctx.save_for_backward(x, stats)
        ctx.relu, ctx.eps, ctx.has_res = relu, eps, residual is not None
        ctx.gather, ctx.count = gather, count
        return y

    @staticmethod
    def backward(ctx, g):
        x, stats = ctx.saved_tensors
        dx = dres = None
        if ctx.needs_input_grad[0]:
            if not g.is_contiguous():
                FusedInstanceNorm.grad_copies += 1
                g = g.contiguous()
            if ctx.gather is None:
                dx = fused_instance_norm_bwd(x, g, stats, ctx.relu, ctx.eps)
            else:
                parts = ctx.gather(instance_norm_bwd_sums(x, g, stats, ctx.relu))
                dx = instance_norm_bwd_dx(x, g, stats, parts, ctx.count, ctx.relu)
        if ctx.has_res and ctx.needs_input_grad[1]:
            dres = g
        return dx, dres, None, None, None, None


def fused_instance_norm(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = False, eps: float = 1e-5, gather=None,
                        count: Optional[float] = None) -> torch.Tensor:
    """InstanceNorm(x) [+ReLU] [+residual] of an NHWC tensor (B, H, W, C),
    in x's dtype. A CUDA tensor runs the kernel (or raises); a CPU tensor
    takes the plain version. Differentiable: where autograd needs a
    gradient the call is :class:`FusedInstanceNorm`. Given ``gather``, x
    is some rows of a slab of ``count`` elements per (b, c), and the call
    takes the partial-statistics form: ``gather`` maps this caller's
    (B, C, k) statistics to every part's (S, B, C, k), stacked in one fixed
    order (under the spatial axis, the group's ranks in rank order).
    ``fused_instance_norm.launches`` counts launches of the one-launch
    form."""
    _check_shapes(x, residual, "residual")
    if torch.is_grad_enabled() and (
            x.requires_grad or (residual is not None and residual.requires_grad)):
        return FusedInstanceNorm.apply(x, residual, relu, eps, gather, count)
    if gather is not None:
        return _partial_forward(x, residual, relu, eps, gather)[0]
    return _forward(x, residual, relu, eps)[0]


fused_instance_norm.launches = 0
