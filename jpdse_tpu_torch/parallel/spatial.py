"""The spatial axis: activations sharded over H across a group of processes,
the port of what GSPMD writes for ``jpdse_tpu/parallel/mesh.py``'s
``spatial`` axis (its halo exchanges and cross-shard reductions), written
by hand.

A tensor of global height ``hg`` is held by the group's ``S`` ranks in
consecutive row ranges, rank ``s`` owning ``[s hg // S, (s + 1) hg // S)``
(:meth:`SpatialShard.owned`): equal blocks where ``S`` divides ``hg``, and
one owner for every row where it does not (the discriminator's layers give
``hg / 2 + 1`` and ``hg + 1`` rows). A layer computes the output rows its
rank owns from :func:`take_rows`, the global input rows it needs, fetched
from their owners, with the reflect, replicate or zero padding applied at
the global edges only; the padding rows of a rank that holds fewer rows
than the pad come from whichever rank owns their source.

Every exchange is one all-reduce over the group of a zero-filled buffer of
slots, each slot written by the one rank that owns its row (a sum that
adds only zeros to each value, as gloo runs it on CUDA tensors, which its
send/recv and all-gather refuse). Every rank computes the whole group's
plan from the shapes alone and makes every call, a rank that needs nothing
included: a skipped collective would deadlock the group. The backward of
:func:`take_rows` returns each fetched row's gradient to its owner, which
adds it to its own. :func:`gather` (the ranks' tensors stacked in rank
order) and :func:`sum_over` are collectives whose every rank uses the
result for its own rows: an all-reduce forward and an all-reduce of the
gradients backward.

A tensor's global height is its local height times ``S`` unless it
carries another (:func:`mark`): the generator's and encoders' activations
split evenly, the discriminator's are marked. The fast path's s2d stages
take their halos by :func:`halo_rows` and convolve the rows they are
given. Nothing here is active outside :func:`sharding`, so the
single-process path runs as it did.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

HG_ATTR = "_jpdse_global_h"
# the group's collectives so far on this rank (set to 0 to count a step): the
# all-reduces of the exchanges and reductions, and the bytes each reduced
traffic = {"calls": 0, "bytes": 0}


@dataclass(frozen=True)
class SpatialShard:
    """This rank's place in its spatial group: member ``index`` of ``size``
    consecutive ranks, all-reducing over ``group``."""

    index: int
    size: int
    group: object = field(default=None, compare=False, repr=False)

    def bounds(self, hg: int) -> Tuple[int, ...]:
        return bounds(hg, self.size)

    def owned(self, hg: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a tensor of global height ``hg``."""
        b = self.bounds(hg)
        return b[self.index], b[self.index + 1]

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole tensor (H on dim 1)."""
        lo, hi = self.owned(x.shape[1])
        return x[:, lo:hi]

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group in place, counted in :data:`traffic`. An
        integer tensor (an id map, a code) goes through float64, exact for
        its values, which every backend sums on the card as on the CPU."""
        traffic["calls"] += 1
        traffic["bytes"] += t.numel() * (t.element_size() if t.is_floating_point() else 8)
        if t.is_floating_point():
            dist.all_reduce(t, group=self.group)
            return t
        wide = t.double()
        dist.all_reduce(wide, group=self.group)
        return t.copy_(wide)


@functools.lru_cache(maxsize=1024)
def bounds(hg: int, size: int) -> Tuple[int, ...]:
    """Row bounds of the ``size`` ranks for a global height ``hg``."""
    return tuple((s * hg) // size for s in range(size + 1))


_ACTIVE: Optional[SpatialShard] = None


@contextlib.contextmanager
def sharding(shard: Optional[SpatialShard]):
    """While active, the layers (``models/layers.py``) compute this rank's
    rows of H-sharded activations (a no-op for None)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, shard
    try:
        yield
    finally:
        _ACTIVE = saved


def current() -> Optional[SpatialShard]:
    """The active shard, or None on the single-process path."""
    return _ACTIVE


def mark(t: torch.Tensor, hg: int) -> torch.Tensor:
    """Record that ``t`` holds this rank's rows of a tensor of global height
    ``hg``; returns ``t``."""
    setattr(t, HG_ATTR, hg)
    return t


def global_h(t: torch.Tensor, shard: Optional[SpatialShard] = None) -> int:
    """The global height of the tensor whose rows ``t`` holds: its mark, or
    its local height times the group's size."""
    hg = getattr(t, HG_ATTR, None)
    if hg is not None:
        return hg
    shard = shard or _ACTIVE
    return t.shape[1] * (1 if shard is None else shard.size)


def numel(t: torch.Tensor) -> int:
    """The elements of the whole tensor whose rows ``t`` holds."""
    n = 1
    for i, d in enumerate(t.shape):
        n *= global_h(t) if i == 1 else d
    return n


def mean(t: torch.Tensor) -> torch.Tensor:
    """This rank's share of the whole tensor's mean: its sum over the whole
    count; the group's shares add up to the mean (``train/step.py`` sums
    them with the gradients). ``t.mean()`` outside :func:`sharding`."""
    if _ACTIVE is None:
        return t.mean()
    return t.sum() / numel(t)


# -- the row exchange ---------------------------------------------------------------
def source_row(r: int, hg: int, mode: str) -> int:
    """The global row that padded row ``r`` copies (-1: a zero row)."""
    if 0 <= r < hg:
        return r
    if mode == "zero":
        return -1
    if mode == "replicate":
        return min(max(r, 0), hg - 1)
    if mode == "reflect":
        i = abs(r)
        i = 2 * (hg - 1) - i if i > hg - 1 else i
        if not 0 <= i < hg:
            raise ValueError(f"reflect pad of row {r} larger than the input's {hg} rows")
        return i
    raise NotImplementedError(f"padding [{mode}]")


@dataclass(frozen=True)
class Plan:
    """One exchange, seen from one rank: its output rows copied from its own
    rows (``local_j`` <- ``local_src``, local indices), the slots it fills
    (``send_k`` <- its rows ``send_src``) and the slots it reads
    (``recv_j`` <- ``recv_k``), of ``n_slots`` in all."""

    n_out: int
    local_j: Tuple[int, ...]
    local_src: Tuple[int, ...]
    send_k: Tuple[int, ...]
    send_src: Tuple[int, ...]
    recv_j: Tuple[int, ...]
    recv_k: Tuple[int, ...]
    n_slots: int


@functools.lru_cache(maxsize=4096)
def plan(hg: int, size: int, index: int, wants: Tuple[Tuple[int, ...], ...]) -> Plan:
    """The exchange that gives every rank ``s`` the global rows ``wants[s]``
    (-1 for a zero row), seen from rank ``index``. The slots are every
    rank's rows owned by another, in rank order, then row order."""
    b = bounds(hg, size)
    lo, hi = b[index], b[index + 1]
    local_j, local_src, send_k, send_src, recv_j, recv_k = [], [], [], [], [], []
    k = 0
    for s, want in enumerate(wants):
        for j, r in enumerate(want):
            if r < 0:
                continue
            if b[s] <= r < b[s + 1]:
                if s == index:
                    local_j.append(j)
                    local_src.append(r - lo)
                continue
            if s == index:
                recv_j.append(j)
                recv_k.append(k)
            if lo <= r < hi:
                send_k.append(k)
                send_src.append(r - lo)
            k += 1
    return Plan(len(wants[index]), *map(tuple, (local_j, local_src, send_k, send_src, recv_j,
                                                recv_k)), k)


@functools.lru_cache(maxsize=4096)
def _index(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An index tensor on ``device``, made once per plan and device."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.long, device=device)


def _exchange(x: torch.Tensor, p: Plan, shard: SpatialShard) -> torch.Tensor:
    dev = x.device
    out = x.new_zeros((x.shape[0], p.n_out) + tuple(x.shape[2:]))
    if p.local_j:
        out.index_copy_(1, _index(p.local_j, dev), x.index_select(1, _index(p.local_src, dev)))
    if p.n_slots:
        buf = x.new_zeros((x.shape[0], p.n_slots) + tuple(x.shape[2:]))
        if p.send_k:
            buf.index_copy_(1, _index(p.send_k, dev), x.index_select(1, _index(p.send_src, dev)))
        shard.all_reduce_(buf)
        if p.recv_j:
            out.index_copy_(1, _index(p.recv_j, dev), buf.index_select(1, _index(p.recv_k, dev)))
    return out


def _give_back(g: torch.Tensor, p: Plan, shard: SpatialShard, shape) -> torch.Tensor:
    dev = g.device
    g = g.contiguous()
    dx = g.new_zeros(shape)
    if p.local_j:
        dx.index_add_(1, _index(p.local_src, dev), g.index_select(1, _index(p.local_j, dev)))
    if p.n_slots:
        buf = g.new_zeros((g.shape[0], p.n_slots) + tuple(g.shape[2:]))
        if p.recv_j:
            buf.index_copy_(1, _index(p.recv_k, dev), g.index_select(1, _index(p.recv_j, dev)))
        shard.all_reduce_(buf)
        if p.send_k:
            dx.index_add_(1, _index(p.send_src, dev), buf.index_select(1, _index(p.send_k, dev)))
    return dx


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p: Plan, shard: SpatialShard):
        ctx.p, ctx.shard, ctx.shape = p, shard, x.shape
        return _exchange(x, p, shard)

    @staticmethod
    def backward(ctx, g):
        return _give_back(g, ctx.p, ctx.shard, ctx.shape), None, None


def take_rows(x: torch.Tensor, hg: int, want: Callable[[int], Sequence[int]],
              mode: str = "zero", shard: Optional[SpatialShard] = None) -> torch.Tensor:
    """The global rows ``want(s)`` of the H-sharded tensor of ``hg`` rows
    whose rows this rank holds in ``x`` (H on dim 1), for this rank ``s``;
    rows outside [0, hg) padded by ``mode`` ('zero', 'reflect',
    'replicate'). ``want`` is asked for every rank of the group, which all
    make the same exchange. Differentiable in ``x``."""
    shard = shard or _ACTIVE
    wants = tuple(tuple(source_row(r, hg, mode) for r in want(s)) for s in range(shard.size))
    p = plan(hg, shard.size, shard.index, wants)
    if torch.is_grad_enabled() and x.requires_grad:
        return _TakeRows.apply(x, p, shard)
    return _exchange(x, p, shard)


# -- reductions over the group -------------------------------------------------------
def gather_(x: torch.Tensor, shard: SpatialShard) -> torch.Tensor:
    """The ranks' ``x`` stacked in rank order (S, *x.shape), on every rank."""
    buf = x.new_zeros((shard.size,) + tuple(x.shape))
    buf[shard.index] = x
    return shard.all_reduce_(buf)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard: SpatialShard):
        ctx.shard = shard
        return gather_(x, shard)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce_(g.contiguous().clone())[ctx.shard.index], None


def gather(x: torch.Tensor, shard: Optional[SpatialShard] = None) -> torch.Tensor:
    """:func:`gather_` under autograd: each rank's ``x`` gets the sum of
    every rank's gradient of its slot."""
    shard = shard or _ACTIVE
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, shard)
    return gather_(x, shard)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard: SpatialShard):
        ctx.shard = shard
        return shard.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce_(g.contiguous().clone()), None


def sum_over(x: torch.Tensor, shard: Optional[SpatialShard] = None) -> torch.Tensor:
    """The sum of the ranks' ``x``, on every rank, differentiable (each rank
    uses it for its own rows)."""
    shard = shard or _ACTIVE
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sum.apply(x, shard)
    return shard.all_reduce_(x.clone())


def gather_rows(x: torch.Tensor, shard: Optional[SpatialShard] = None,
                hg: Optional[int] = None) -> torch.Tensor:
    """The whole tensor whose rows the ranks hold (H on dim 1), on every
    rank: for outputs that leave the sharded path (an evaluation's image and
    codes). Not differentiable."""
    shard = shard or _ACTIVE
    hg = global_h(x, shard) if hg is None else hg
    lo, hi = shard.owned(hg)
    full = x.new_zeros((x.shape[0], hg) + tuple(x.shape[2:]))
    full[:, lo:hi] = x
    return shard.all_reduce_(full)


# -- layers on sharded rows ----------------------------------------------------------
def _at_least(rows: torch.Tensor, n: int) -> torch.Tensor:
    """``rows`` with zero rows appended up to ``n`` (a rank that owns no
    output row still runs the layer, on zeros, so every rank's graph is
    alike)."""
    if rows.shape[1] >= n:
        return rows
    pad = rows.new_zeros((rows.shape[0], n - rows.shape[1]) + tuple(rows.shape[2:]))
    return torch.cat([rows, pad], dim=1)


def out_rows(hg: int, k: int, stride: int, pad: int) -> int:
    """The global height of a conv's (or pool's) output."""
    return (hg + 2 * pad - k) // stride + 1


def window_rows(x: torch.Tensor, hg: int, k: int, stride: int, pad: int, mode: str):
    """(rows, hout, n_out): the input rows a k-row window of ``stride`` and
    H pad ``pad`` (padded by ``mode``) reads for this rank's output rows,
    at least ``k`` of them, the output's global height and this rank's
    output rows."""
    shard = _ACTIVE
    hout = out_rows(hg, k, stride, pad)
    b = bounds(hout, shard.size)

    def want(s):
        lo, hi = b[s], b[s + 1]
        return range(lo * stride - pad, (hi - 1) * stride - pad + k) if hi > lo else range(0)

    rows = take_rows(x, hg, want, mode, shard)
    return _at_least(rows, k), hout, b[shard.index + 1] - b[shard.index]


def halo_rows(x: torch.Tensor, before: int, after: int, mode: str = "zero",
              hg: Optional[int] = None) -> torch.Tensor:
    """This rank's rows [lo - before, hi + after) of the H-sharded tensor
    whose rows [lo, hi) it holds in ``x`` (global height ``hg``, default
    :func:`global_h`), padded by ``mode`` beyond the global edges only: the
    halos of the fast path's s2d stages (``models/fast_trunk.py``), whose
    own convolutions then run on the rows given. Differentiable in ``x``
    (the backward is :func:`take_rows`')."""
    shard = _ACTIVE
    hg = global_h(x, shard) if hg is None else hg
    b = bounds(hg, shard.size)
    return take_rows(x, hg, lambda s: range(b[s] - before, b[s + 1] + after), mode, shard)


def reflect_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of a reflection pad (edge not repeated) of length n."""
    i = torch.arange(-before, n + after, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def pad_w(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """The W pad of an NHWC tensor by ``mode`` (reflect or replicate)."""
    if not pad:
        return x
    w = x.shape[2]
    if mode == "reflect":
        if pad >= w:
            raise ValueError(f"reflect pad larger than the input {tuple(x.shape)}")
        return x.index_select(2, reflect_index(w, pad, pad, x.device))
    return x.index_select(2, torch.arange(-pad, w + pad, device=x.device).clamp(0, w - 1))


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int = 1,
           pad: int = 0, mode: str = "zero", groups: int = 1) -> torch.Tensor:
    """This rank's output rows of a conv over the whole padded tensor: H
    and W padded by ``pad`` rows and columns of ``mode`` (the conv's own
    zero padding for 'zero'), NHWC in and out, the output marked with its
    global height."""
    hg = global_h(x)
    k = w.shape[2]
    rows, hout, n_out = window_rows(x, hg, k, stride, pad, mode)
    pw = pad if mode == "zero" else 0
    rows = rows if mode == "zero" else pad_w(rows, pad, mode)
    y = torch.nn.functional.conv2d(rows.permute(0, 3, 1, 2), w, b, stride, (0, pw),
                                   groups=groups)
    return mark(y.permute(0, 2, 3, 1)[:, :n_out], hout)


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                     groups: int = 1) -> torch.Tensor:
    """This rank's output rows of ConvTranspose2d(k3, s2, p1, op1) on an
    evenly split tensor: output rows 2i and 2i + 1 read input rows i and
    i + 1, so one row below the rank's own, zero beyond the global bottom."""
    shard = _ACTIVE
    hg = global_h(x)
    bd = bounds(hg, shard.size)
    if bounds(2 * hg, shard.size) != tuple(2 * v for v in bd):
        raise ValueError(f"a transposed conv of {hg} rows does not split evenly over "
                         f"{shard.size} ranks")
    rows = take_rows(x, hg, lambda s: range(bd[s], bd[s + 1] + 1), "zero", shard)
    y = torch.nn.functional.conv_transpose2d(rows.permute(0, 3, 1, 2), w, b, 2, 1,
                                             output_padding=1, groups=groups)
    return y.permute(0, 2, 3, 1)[:, :2 * x.shape[1]]
