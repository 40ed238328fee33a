"""K3's partial-statistics stats and sums launches
(jpdse_tpu_torch/csrc/instance_norm.cu, instance_norm_stats_kernel and
instance_norm_bwd_sums_kernel): their partition, as ``csrc/part_plan.h``
computes it for the launchers and the wrapper's workspace, built here with
the host's C++ compiler and checked on the CPU (which rows and channels
each CTA reads, the workspace and counters it sizes, the merge's runs); and
a float32 replay of the order in which the launch merges its chunks (each
chunk's partial, numpy's mean and M2 or sums over the chunk's rows, then
the slab's chunks merged in the kernel's runs) through the ranks of uneven
splits, held against the plain versions and, with the port's plain apply
and dx on the replayed parts, against the JAX package's Pallas kernel and
its custom VJP run in interpret mode. The replay checks the chunk and run
partition and the cross-chunk merge order only, not the kernel's order
within a chunk (its threads' batched folds and pixel-lane tree); the card
holds the kernels themselves against the plain versions
(tests/test_torch_port_cuda.py, chip_smoke.py).

Tolerances: the count exact; means, M2 and sums within 1e-5 relative to
max(1, |value|) or of their max-abs (fp32 sums in another order); outputs
within 1e-5 of their max-abs (as the forward and backward are held).
"""

import ctypes
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdse_tpu.ops.pallas import instance_norm as pin
from jpdse_tpu_torch.ops import build
from jpdse_tpu_torch.ops import instance_norm as k3
from jpdse_tpu_torch.parallel.spatial import bounds
from test_torch_port_threads import port_test_threads  # noqa: F401

LEVELS = [(512, 1024, 64), (256, 512, 128), (128, 256, 256), (64, 128, 512), (32, 64, 1024)]
# part_plan.h's defaults
THREADS, BATCH, MAX_CTAS, MIN_STAGES, TILE_MIN, MERGE_BYTES = 256, 4, 132, 3, 4, 36864


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """csrc/part_plan.h built alone into a shared library by the host's C++
    compiler (the header the CUDA source includes)."""
    out = tmp_path_factory.mktemp("part_plan") / "libpart_plan.so"
    subprocess.run([build.gxx_path(), *build.GXX_FLAGS, "-I", str(build.CSRC_DIR), "-x", "c++",
                    "-", "-o", str(out)], input='#include "part_plan.h"\n', text=True,
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.instance_norm_part_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    lib.instance_norm_part_plan.restype = ctypes.c_int
    lib.instance_norm_part_runs.argtypes = [ctypes.c_int]
    lib.instance_norm_part_runs.restype = ctypes.c_int
    return lib


def part_plan(lib, b, hw, c, vec):
    """(grid, chunks, rows a chunk, words a tile, rows a stage, workspace
    floats, counters) as the launchers and the wrapper take them."""
    out = (ctypes.c_longlong * 7)()
    assert lib.instance_norm_part_plan(hw, b, c, vec, out) == 0
    return tuple(out)


def part_items(lib, b, hw, c, vec):
    """Each CTA's (batch element, first and end channel, first and end row),
    by block index, as part_item reads the plan: CTA q is chunk q % chunks of
    slab q // chunks = (b, tile)."""
    grid, chunks, rows, tile = part_plan(lib, b, hw, c, vec)[:4]
    groups = c // vec
    tiles = -(-groups // tile)
    out = []
    for q in range(grid):
        slab, chunk = divmod(q, chunks)
        bi, t = divmod(slab, tiles)
        g0, g1 = t * tile, min((t + 1) * tile, groups)
        out.append((bi, g0 * vec, g1 * vec, chunk * rows, min((chunk + 1) * rows, hw)))
    return out


def merge_runs(lib, chunks, channels):
    """The runs [k0, k1) in which the merging CTA takes a slab's chunks for
    ``channels`` channels: part_runs of them, cut as merge_slab cuts them."""
    runs = lib.instance_norm_part_runs(channels)
    return [(chunks * r // runs, chunks * (r + 1) // runs) for r in range(runs)]


def _ranks(shape, size):
    """The rank slabs of ``shape`` split over ``size`` ranks as the spatial
    axis splits it, as (batch, rows, channels)."""
    b, h, w, c = shape
    cut = bounds(h, size)
    return [(b, (cut[s + 1] - cut[s]) * w, c) for s in range(size)]


# (batch, rows, channels, channels a word, bytes a channel): the spatial
# step's rank slabs at spatial 2 (training: batch 2, fp32; serving: batch 1,
# bf16), the hires recipe's rows at spatial 2, the uneven splits' ranks
# (chip_smoke.py UNEVEN_SPLITS; ranks of none among them), one-word slabs
UNEVEN_SPLITS = [((1, 43, 64, 1024), 2), ((1, 86, 128, 512), 4), ((1, 3, 64, 1024), 4),
                 ((2, 7, 12, 6), 3)]
CASES = ([(2, h // 2 * w, c, 4, 4) for h, w, c in LEVELS]
         + [(1, h // 2 * w, c, 8, 2) for h, w, c in LEVELS]
         + [(1, 512 * 2048, 32, 4, 4)]
         + [(b, hw, c, k3.vector_width(c, 4), 4) for shape, size in UNEVEN_SPLITS
            for b, hw, c in _ranks(shape, size)]
         + [(2, 96, 6, 1, 2), (1, 0, 64, 1, 4), (3, 5000, 48, 8, 2)])


@pytest.mark.parametrize("b,hw,c,vec,elt", CASES)
def test_partial_plan_covers_every_row_once(plan_lib, b, hw, c, vec, elt):
    """Every (batch element, channel, row) is read by exactly one CTA: each
    slab's channel tile is one range, the slabs of a batch element tile its
    channels, and its chunks tile its rows in chunk order, every chunk whole
    stages that fit a ring slot, and the launch keeps within 132 CTAs where
    chunks can grow. A slab of no rows is one chunk of none, one CTA per
    slab. The tile is of at least 4 words (or the row's) and keeps a slab's
    partials within what the merging CTA reads in one batch, unless it
    leaves no merge at all. Every partial and counter a CTA touches lies inside the workspace
    the wrapper sizes, and the partials are a small part of x."""
    grid, chunks, rows, tile, stage_rows, floats, counters = part_plan(plan_lib, b, hw, c, vec)
    items = part_items(plan_lib, b, hw, c, vec)
    slabs = grid // chunks
    assert len(items) == grid and 1 <= chunks <= max(1, MAX_CTAS // slabs)
    assert rows % stage_rows == 0 and rows // stage_rows >= MIN_STAGES
    assert stage_rows == BATCH * (THREADS // tile)
    assert stage_rows * tile <= THREADS * BATCH  # a stage fills one slot
    assert tile >= min(TILE_MIN, c // vec) or vec == 1
    if vec > 1 and chunks > 1 and tile >= 2 * TILE_MIN:
        assert chunks * tile * vec * 8 <= MERGE_BYTES
    seen = {}
    for q, (bi, c0, c1, r0, r1) in enumerate(items):
        assert (c1 - c0) % vec == 0 and 0 < (c1 - c0) // vec <= tile
        seen.setdefault((bi, c0, c1), []).append((q % chunks, r0, r1))
    assert len(seen) == slabs == counters
    for bi in range(b):
        ranges = sorted((c0, c1) for bj, c0, c1 in seen if bj == bi)
        assert ranges[0][0] == 0 and ranges[-1][1] == c
        assert all(a[1] == z[0] for a, z in zip(ranges, ranges[1:]))
    for parts in seen.values():
        assert [k for k, _, _ in parts] == list(range(chunks))
        assert parts[0][1] == 0 and parts[-1][2] == hw
        assert all(a[2] == z[1] for a, z in zip(parts, parts[1:]))
        assert all(r1 > r0 for _, r0, r1 in parts) or (hw == 0 and parts == [(0, 0, 0)])
    for q, (bi, c0, c1, _, _) in enumerate(items):
        assert ((bi * chunks + q % chunks) * c + c1 - 1) * 2 + 1 < floats
        assert q // chunks < counters
    if b * hw * c * elt >= 2**20:
        assert floats * 4 * 4 <= b * hw * c * elt


@pytest.mark.parametrize("items", [1, 2, 5, 16, 33, 131])
@pytest.mark.parametrize("channels", [6, 64, 128, 256])
def test_merge_runs_take_each_chunk_once_in_order(plan_lib, items, channels):
    runs = merge_runs(plan_lib, items, channels)
    assert len(runs) == max(1, THREADS // channels)
    assert len(runs) * channels <= THREADS
    assert runs[0][0] == 0 and runs[-1][1] == items
    assert all(a[1] == z[0] and a[0] <= a[1] for a, z in zip(runs, runs[1:]))


# -- the kernels' order, replayed in float32 ----------------------------------------------

F32 = np.float32


def _chan(a, z):
    """The kernels' Chan merge of two float32 (count, mean, M2) partials, a
    count and two arrays over channels."""
    n = F32(a[0] + z[0])
    if n == 0:
        return a
    delta = z[1] - a[1]
    wb = F32(z[0] / n)
    return n, a[1] + delta * wb, a[2] + z[2] + delta * delta * F32(a[0]) * wb


def _add(a, z):
    return F32(0), a[1] + z[1], a[2] + z[2]


def _merge(lib, partials, counts, combine):
    """merge_slab: a slab's (a, b) chunk partials merged in the kernel's
    runs, each from zero in chunk order, then the runs from zero in order."""
    cs = partials[0][0].shape[0]
    zero = (F32(0), np.zeros(cs, F32), np.zeros(cs, F32))
    out = zero
    for k0, k1 in merge_runs(lib, len(partials), cs):
        t = zero
        for k in range(k0, k1):
            t = combine(t, (F32(counts[k]), partials[k][0], partials[k][1]))
        out = combine(out, t)
    return out


def _replay(lib, shape, chunk_part, combine, width):
    """The stats or sums launch on one rank's (b, rows, c) slab, float32:
    chunk_part(b, c0, c1, r0, r1) gives one CTA's chunk partial, two arrays
    over its channels; the slab's merge as merge_slab takes it. Returns (b,
    c, 3) (count, mean, M2) or (b, c, 2) sums."""
    b, hw, c = shape
    vec = k3.vector_width(c, 4)
    chunks = part_plan(lib, b, hw, c, vec)[1]
    items = part_items(lib, b, hw, c, vec)
    out = np.zeros((b, c, width), F32)
    for q in range(0, len(items), chunks):
        slab = items[q:q + chunks]
        parts = [chunk_part(*it) for it in slab]
        counts = [r1 - r0 for *_, r0, r1 in slab]
        if chunks == 1:  # the CTA's tree is the slab's result
            t = (F32(counts[0]),) + parts[0]
        else:
            t = _merge(lib, parts, counts, combine)
        bi, c0, c1 = slab[0][:3]
        out[bi, c0:c1] = np.stack([np.full(c1 - c0, t[0], F32), t[1], t[2]][3 - width:], -1)
    return out


def replay_stats(lib, x4):
    """The stats launch's float32 replay on one rank's NHWC slab: a chunk's
    partial is its (mean, M2) about its own mean."""
    b, h, w, c = x4.shape
    x = x4.float().numpy().reshape(b, h * w, c)

    def part(bi, c0, c1, r0, r1):
        rows = x[bi, r0:r1, c0:c1]
        if r1 == r0:
            return np.zeros(c1 - c0, F32), np.zeros(c1 - c0, F32)
        mean = rows.mean(0, dtype=F32)
        return mean, ((rows - mean) ** 2).sum(0, dtype=F32)

    return torch.from_numpy(_replay(lib, (b, h * w, c), part, _chan, 3))


def replay_sums(lib, x4, g4, ms, relu):
    """The sums launch's float32 replay on one rank's NHWC slab: a chunk's
    partial is its sums of g' and g' * xhat."""
    b, h, w, c = x4.shape
    x, g = (t.float().numpy().reshape(b, h * w, c) for t in (x4, g4))
    msn = ms.numpy()

    def part(bi, c0, c1, r0, r1):
        xh = (x[bi, r0:r1, c0:c1] - msn[bi, c0:c1, 0]) * msn[bi, c0:c1, 1]
        gg = g[bi, r0:r1, c0:c1]
        if relu:
            gg = np.where(xh > 0, gg, F32(0))
        return gg.sum(0, dtype=F32), (gg * xh).sum(0, dtype=F32)

    return torch.from_numpy(_replay(lib, (b, h * w, c), part, _add, 2))


# (slab, ranks): uneven splits, ranks of none among them, slabs of many
# chunks and several channel tiles, one-word channels
REPLAY_SPLITS = [((2, 43, 24, 16), 2), ((1, 3, 24, 16), 4), ((2, 7, 12, 6), 3),
                 ((1, 96, 512, 16), 2), ((2, 21, 64, 256), 3)]


def _slab(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * 3 + 1).astype(np.float32))


def _split(x, size):
    cut = bounds(x.shape[1], size)
    return [x[:, cut[s]:cut[s + 1]].contiguous() for s in range(size)]


@pytest.mark.parametrize("shape,size", REPLAY_SPLITS)
def test_replayed_stats_and_sums_match_the_plain_versions(plan_lib, shape, size):
    """Each rank's stats and sums, replayed in the kernels' order in float32,
    against instance_norm_stats_plain / instance_norm_bwd_sums_plain on the
    same slab: counts exact, an empty rank's parts exactly 0."""
    x, g = _slab(shape, 0), _slab(shape, 1)
    stats = []
    for xs in _split(x, size):
        got, want = replay_stats(plan_lib, xs), k3.instance_norm_stats_plain(xs)
        assert torch.equal(got[..., 0], want[..., 0])
        assert ((got[..., 1:] - want[..., 1:]).abs()
                <= 1e-5 * want[..., 1:].abs().clamp_min(1.0)).all()
        if xs.shape[1] == 0:
            assert torch.equal(got, torch.zeros_like(got))
        stats.append(got)
    _, ms = k3.instance_norm_apply_plain(x, None, torch.stack(stats), True)
    for xs, gs in zip(_split(x, size), _split(g, size)):
        for relu in (True, False):
            got, want = replay_sums(plan_lib, xs, gs, ms, relu), k3.instance_norm_bwd_sums_plain(
                xs, gs, ms, relu)
            assert (got - want).abs().max() <= 1e-5 * max(1.0, want.abs().max().item())
            if xs.shape[1] == 0:
                assert torch.equal(got, torch.zeros_like(got))


@pytest.fixture
def force_interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


# small enough for the Pallas kernel's VMEM slab rule (1 MiB of fp32)
JAX_SPLITS = [((2, 43, 24, 16), 2), ((1, 3, 24, 16), 4), ((2, 7, 12, 6), 3),
              ((1, 128, 128, 16), 2)]


@pytest.mark.parametrize("relu,has_res", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("shape,size", JAX_SPLITS)
def test_replayed_partial_form_matches_jax(plan_lib, force_interpret, shape, size, relu,
                                           has_res):
    """The ranks' replayed stats stacked in rank order, the port's plain
    apply on each rank, against JAX's fused_instance_norm of the whole slab
    (its Pallas kernel in interpret mode); the replayed sums and the plain
    dx against jax.vjp of its custom VJP: fp32 within 1e-5 of the output's
    max-abs."""
    x, g = _slab(shape, 2), _slab(shape, 3)
    res = _slab(shape, 4) if has_res else None
    xs, gs = _split(x, size), _split(g, size)
    rs = _split(res, size) if has_res else [None] * size
    parts = torch.stack([replay_stats(plan_lib, p) for p in xs])
    outs = [k3.instance_norm_apply_plain(p, r, parts, relu) for p, r in zip(xs, rs)]
    y = torch.cat([o[0] for o in outs], 1)
    ms = outs[0][1]
    assert all(torch.equal(o[1], ms) for o in outs)
    jx, jr = jnp.asarray(x.numpy()), None if res is None else jnp.asarray(res.numpy())
    want = np.asarray(pin.fused_instance_norm(jx, jr, relu=relu, force_pallas=True))
    assert np.abs(y.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    sums = torch.stack([replay_sums(plan_lib, p, q, ms, relu) for p, q in zip(xs, gs)])
    count = float(shape[1] * shape[2])
    dx = torch.cat([k3.instance_norm_bwd_dx_plain(p, q, ms, sums, count, relu)
                    for p, q in zip(xs, gs)], 1)
    if res is None:
        _, vjp = jax.vjp(lambda a: pin._fused_in(a, None, relu, 1e-5), jx)
    else:
        _, vjp = jax.vjp(lambda a: pin._fused_in(a, jr, relu, 1e-5), jx)
    want_dx = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    assert np.abs(dx.numpy() - want_dx).max() <= 1e-5 * np.abs(want_dx).max()
