"""The spatial axis: activations sharded over H across a group of processes,
the port of what GSPMD writes for ``jpdse_tpu/parallel/mesh.py``'s
``spatial`` axis (its halo exchanges and cross-shard reductions), written
by hand.

A tensor of global height ``hg`` is held by the group's ``S`` ranks in
consecutive row ranges, rank ``s`` owning ``[s hg // S, (s + 1) hg // S)``
(:meth:`SpatialShard.owned`): equal blocks where ``S`` divides ``hg``, and
one owner for every row where it does not (a generator's fourth down of an
H of 1376 rows has 43, the discriminator's layers give ``hg / 2 + 1`` and
``hg + 1``). A layer computes the output rows its
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

Every H-sharded tensor carries its global height (:func:`mark`): the
batch's rows from :meth:`SpatialShard.rows`, each sharded layer's output
from the layer, each element-wise output from its input (:func:`like`).
The split need not be even: at the deeper layers the ranks hold unequal
row counts, and a rank may hold none (it still runs every layer, on zero
rows, and makes every collective). A rank's own row count does not say
the global height, so :func:`global_h` of an unmarked tensor raises rather
than guess. The fast path's s2d stages take the fine rows their s2d rows
cover by :func:`take_rows` with the ownership that the s2d split gives
(``owners``). Nothing here is active outside :func:`sharding`, so the
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
        """This rank's rows of a whole tensor (H on dim 1), marked with its
        height."""
        lo, hi = self.owned(x.shape[1])
        return mark(x[:, lo:hi], x.shape[1])

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


def like(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``t`` marked with ``src``'s global height where ``src`` carries one:
    for an output whose rows are ``src``'s rows (an element-wise op, a
    cast, a concat over channels); returns ``t``."""
    hg = getattr(src, HG_ATTR, None)
    if hg is not None:
        setattr(t, HG_ATTR, hg)
    return t


class UnknownHeight(ValueError):
    """A sharded tensor whose global height nothing records."""


def global_h(t: torch.Tensor, shard: Optional[SpatialShard] = None) -> int:
    """The global height of the tensor whose rows ``t`` holds: its mark;
    its own height outside a group of more than one rank. An unmarked
    tensor of a group raises :class:`UnknownHeight`: a rank's row count
    does not fix the height (21 rows on rank 0 of 2 are 42 or 43), and
    ranks that guessed apart would build different exchanges."""
    hg = getattr(t, HG_ATTR, None)
    if hg is not None:
        return hg
    shard = shard or _ACTIVE
    if shard is None or shard.size == 1:
        return t.shape[1]
    raise UnknownHeight(f"a tensor of {t.shape[1]} rows on rank {shard.index} of {shard.size} "
                        f"carries no global height (spatial.mark / spatial.like)")


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
def plan(owners: Tuple[int, ...], index: int, wants: Tuple[Tuple[int, ...], ...]) -> Plan:
    """The exchange that gives every rank ``s`` the global rows ``wants[s]``
    (-1 for a zero row), seen from rank ``index``, rank ``s`` owning rows
    ``[owners[s], owners[s + 1])``. The slots are every rank's rows owned by
    another, in rank order, then row order: the same count on every rank."""
    b = owners
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
              mode: str = "zero", shard: Optional[SpatialShard] = None,
              owners: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """The global rows ``want(s)`` of the H-sharded tensor of ``hg`` rows
    whose rows this rank holds in ``x`` (H on dim 1), for this rank ``s``;
    rows outside [0, hg) padded by ``mode`` ('zero', 'reflect',
    'replicate'). Rank ``s`` holds rows ``[owners[s], owners[s + 1])``,
    by default :func:`bounds`. ``want`` is asked for every rank of the
    group, which all make the same exchange. Differentiable in ``x``."""
    shard = shard or _ACTIVE
    wants = tuple(tuple(source_row(r, hg, mode) for r in want(s)) for s in range(shard.size))
    p = plan(owners or bounds(hg, shard.size), shard.index, wants)
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
def at_least(rows: torch.Tensor, n: int) -> torch.Tensor:
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
    return at_least(rows, k), hout, b[shard.index + 1] - b[shard.index]


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
    """This rank's output rows ``[o0, o1)`` of ConvTranspose2d(k3, s2, p1,
    op1), marked with their global height ``2 hg``: output rows 2i and
    2i + 1 read input rows i and i + 1, so the rank takes input rows
    ``o0 // 2`` to ``(o1 - 1) // 2 + 1`` (zero beyond the global bottom),
    whose transposed conv starts at output row ``2 (o0 // 2)``, and keeps
    its own."""
    shard = _ACTIVE
    hg = global_h(x)
    ob = bounds(2 * hg, shard.size)

    def want(s):
        return range(ob[s] // 2, (ob[s + 1] - 1) // 2 + 2) if ob[s + 1] > ob[s] else range(0)

    rows = at_least(take_rows(x, hg, want, "zero", shard), 1)
    y = torch.nn.functional.conv_transpose2d(rows.permute(0, 3, 1, 2), w, b, 2, 1,
                                             output_padding=1, groups=groups)
    o0, o1 = ob[shard.index], ob[shard.index + 1]
    first = o0 - 2 * (o0 // 2)
    return mark(y.permute(0, 2, 3, 1)[:, first:first + o1 - o0], 2 * hg)
