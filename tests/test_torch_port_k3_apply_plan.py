"""K3's partial-statistics apply and dx launches
(jpdse_tpu_torch/csrc/instance_norm.cu, instance_norm_apply_kernel and
instance_norm_bwd_dx_kernel): their partition, as ``csrc/part_plan.h``
computes it for the launchers (``make_apply_plan``, ``apply_item``), built
here with the host's C++ compiler and queried through
``instance_norm_apply_plan`` and ``instance_norm_apply_item``; and a
float32 replay of the apply's merge of the ranks' statistics, once a CTA in
rank order, against the port's plain apply, bit for bit. The card holds the
kernels themselves against their plain versions
(tests/test_torch_port_cuda.py -k partial, chip_smoke.py).

``apply_plan_lib``, ``apply_plan`` and ``apply_items`` serve the spatial
tests' checks of the same partition too.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from jpdse_tpu_torch.ops import build
from jpdse_tpu_torch.ops import instance_norm as k3
from jpdse_tpu_torch.parallel.spatial import bounds
from test_torch_port_threads import port_test_threads  # noqa: F401

# part_plan.h's defaults: threads a CTA, words a tile, rows a step a pixel lane, the
# target's least and most CTAs, words a CTA of the target, steps a chunk at the least
THREADS, TILE_WORDS, BATCH, CTAS, MAX_CTAS, CTA_WORDS, MIN_STEPS = 256, 64, 4, 264, 1056, 8192, 1
LEVELS = [(512, 1024, 64), (256, 512, 128), (128, 256, 256), (64, 128, 512), (32, 64, 1024)]


@pytest.fixture(scope="module")
def apply_plan_lib(tmp_path_factory):
    """csrc/part_plan.h built alone into a shared library by the host's C++
    compiler (the header the CUDA source includes)."""
    out = tmp_path_factory.mktemp("apply_plan") / "libpart_plan.so"
    subprocess.run([build.gxx_path(), *build.GXX_FLAGS, "-I", str(build.CSRC_DIR), "-x", "c++",
                    "-", "-o", str(out)], input='#include "part_plan.h"\n', text=True,
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.instance_norm_apply_plan.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_void_p]
    lib.instance_norm_apply_plan.restype = ctypes.c_int
    lib.instance_norm_apply_item.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    lib.instance_norm_apply_item.restype = ctypes.c_int
    return lib


def apply_plan(lib, b, hw, c, vec):
    """(grid, chunks a slab, rows a chunk at the most, words a tile, the
    CTAs' target, rows a step) of an apply or dx launch."""
    out = (ctypes.c_longlong * 6)()
    assert lib.instance_norm_apply_plan(hw, b, c, vec, out) == 0
    return tuple(out)


def apply_items(lib, b, hw, c, vec):
    """Each CTA's (batch element, first and end channel, first and end
    row), by block index, as the kernels' ``apply_item`` gives it."""
    out = (ctypes.c_longlong * 5)()
    items = []
    for q in range(apply_plan(lib, b, hw, c, vec)[0]):
        assert lib.instance_norm_apply_item(hw, b, c, vec, q, out) == 0
        items.append(tuple(out))
    return items


def check_cover(lib, b, hw, c, vec):
    """Every (batch element, row, channel) lies in exactly one CTA: a
    slab's CTAs in chunk order share one channel range and tile its rows
    in order, the ranges of a batch element tile its channels, each range
    whole words of at most one tile. Returns the plan."""
    plan = apply_plan(lib, b, hw, c, vec)
    grid, chunks, rows, tile = plan[:4]
    items = apply_items(lib, b, hw, c, vec)
    assert len(items) == grid and grid % chunks == 0
    assert grid == b * -(-(c // vec) // tile) * chunks
    for q0 in range(0, grid, chunks):
        slab = items[q0:q0 + chunks]
        assert len({it[:3] for it in slab}) == 1
        bi, c0, c1 = slab[0][:3]
        assert (c1 - c0) % vec == 0 and 0 < (c1 - c0) // vec <= tile
        assert slab[0][3] == 0 and slab[-1][4] == hw
        assert all(a[4] == z[3] for a, z in zip(slab, slab[1:]))
        assert all(0 <= it[4] - it[3] <= rows for it in slab)
        assert all(it[4] > it[3] for it in slab) or (hw == 0 and chunks == 1)
    for bi in range(b):
        ranges = sorted({it[1:3] for it in items if it[0] == bi})
        assert ranges[0][0] == 0 and ranges[-1][1] == c
        assert all(a[1] == z[0] for a, z in zip(ranges, ranges[1:]))
    return plan


def _rank_rows(shape, size):
    """(batch, rows, channels) of each rank's slab of ``shape`` split over
    ``size`` ranks as the spatial axis splits it."""
    b, h, w, c = shape
    cut = bounds(h, size)
    return [(b, (cut[s + 1] - cut[s]) * w, c) for s in range(size)]


# (batch, rows, channels, channels a word): the spatial step's rank slabs at
# spatial 2 (chip_smoke.STEP_RANK_SLABS: training at batch 2 in fp32,
# serving at batch 1 in bf16), a rank's 21 of 43 rows (fp32) and the
# other's 22, the hires rows, uneven splits with ranks of none, one-word
# channels, a slab of fewer rows than a step, one row
STEP_CASES = ([(2, h // 2 * w, c, 4) for h, w, c in LEVELS]
              + [(1, h // 2 * w, c, 8) for h, w, c in LEVELS]
              + [(1, 21 * 64, 1024, 4), (1, 22 * 64, 1024, 4), (1, 512 * 2048, 32, 4)])
EDGE_CASES = ([(b, hw, c, k3.vector_width(c, 4)) for b, hw, c in
               _rank_rows((1, 86, 128, 512), 4) + _rank_rows((1, 3, 64, 1024), 4)
               + _rank_rows((2, 7, 12, 6), 3)]
              + [(3, 5000, 48, 8), (2, 5, 1024, 4), (1, 1, 64, 4), (2, 96, 6, 1)])


@pytest.mark.parametrize("b,hw,c,vec", STEP_CASES + EDGE_CASES)
def test_apply_plan_covers_every_value_once_at_the_step_slabs(apply_plan_lib, b, hw, c, vec):
    """check_cover at every slab the step and its uneven splits give the
    apply and dx launches; a step is kApplyBatch rows of each pixel lane."""
    grid, chunks, rows, tile, target, step_rows = check_cover(apply_plan_lib, b, hw, c, vec)
    assert step_rows == BATCH * (THREADS // tile) and tile == min(c // vec, TILE_WORDS)


def _target(b, hw, words):
    """A CTA for each CTA_WORDS words, between CTAS and MAX_CTAS."""
    return min(MAX_CTAS, max(CTAS, -(-b * hw * words // CTA_WORDS)))


@pytest.mark.parametrize("b,hw,c,vec", STEP_CASES + EDGE_CASES + [(1, 10**6, 8, 4),
                                                                  (16, 64, 2048, 8),
                                                                  (4, 2**20, 256, 8)])
def test_apply_grid_reaches_the_target_and_keeps_under_the_cap(apply_plan_lib, b, hw, c, vec):
    """The launch's target is a CTA for each 8192 words, at least 264 (two
    an SM) and at most 1056; a slab takes ceil(target / slabs) chunks where
    its rows give each a step (kApplyMinSteps), so the launch has at least
    the target's CTAs; the grid stays below the target plus one CTA a slab,
    so within the cap of 1056 and a CTA a slab; a slab of fewer steps takes
    one chunk a step."""
    grid, chunks, _, tile, target, step_rows = apply_plan(apply_plan_lib, b, hw, c, vec)
    slabs = b * -(-(c // vec) // tile)
    steps = -(-hw // step_rows)
    want = -(-target // slabs)
    assert target == _target(b, hw, c // vec)
    assert grid == slabs * chunks
    assert grid < target + slabs <= MAX_CTAS + slabs
    if steps // MIN_STEPS >= want:
        assert chunks == want and grid >= target
    else:
        assert chunks == max(1, steps // MIN_STEPS)


@pytest.mark.parametrize("b,c,vec", [(1, 1024, 4), (2, 64, 4), (1, 1024, 8), (2, 6, 1),
                                     (1, 512, 1)])
def test_apply_plan_gives_an_empty_slab_one_cta_per_slab(apply_plan_lib, b, c, vec):
    """An empty slab (hw 0, a rank that owns no rows of an uneven split):
    one CTA of no rows per (batch element, channel tile), which the apply
    launch needs to write the merged mean and rstd for every (b, c)."""
    grid, chunks, rows = check_cover(apply_plan_lib, b, 0, c, vec)[:3]
    items = apply_items(apply_plan_lib, b, 0, c, vec)
    assert chunks == 1 and rows == 0 and grid == len(items)
    assert all(it[3] == it[4] == 0 for it in items)
    assert sorted((bi, c0) for bi, c0, *_ in items) == [
        (bi, c0) for bi in range(b) for c0 in sorted({it[1] for it in items})]


# -- the apply's merge, replayed in float32 ------------------------------------------------

F32 = np.float32


def replay_merge(parts: np.ndarray, eps: float = 1e-5):
    """The apply kernel's ``apply_stats`` in float32 on the ranks' (S, B, C,
    3) parts: each channel's ranks folded in rank order by ``merge`` (a
    count of 0 after the fold keeps the running summary), then mean and
    rstd = 1 / sqrt(M2 / n + eps). Returns (B, C, 2)."""
    n = np.zeros(parts.shape[1:3], F32)
    mean = np.zeros_like(n)
    m2 = np.zeros_like(n)
    for part in parts.astype(F32):
        nb, mb, m2b = part[..., 0], part[..., 1], part[..., 2]
        nt = n + nb
        wb = np.where(nt > 0, nb / np.where(nt > 0, nt, F32(1)), F32(0)).astype(F32)
        delta = mb - mean
        keep = nt == 0
        mean = np.where(keep, mean, mean + delta * wb)
        m2 = np.where(keep, m2, m2 + m2b + delta * delta * n * wb)
        n = nt
    rstd = F32(1) / np.sqrt(m2 / n + F32(eps))
    return np.stack([mean, rstd], -1)


# (slab, ranks): uneven heights, an empty rank among four, one-word
# channels, a slab of more than one channel tile
MERGE_SPLITS = [((2, 9, 16, 64), 1), ((1, 43, 8, 256), 2), ((2, 7, 12, 6), 2),
                ((1, 3, 16, 48), 4), ((2, 21, 8, 1024), 4)]


@pytest.mark.parametrize("shape,size", MERGE_SPLITS)
def test_replayed_merge_gives_the_plain_apply_bit_for_bit(shape, size):
    """The ranks' plain stats of an uneven split, merged as the kernel
    merges them once a CTA, give instance_norm_apply_plain's mean and rstd
    bit for bit, for S = 1, 2 and 4 (the kernel's fp32 fused multiply-adds
    aside: the card holds it within 1e-5)."""
    rng = np.random.default_rng(size)
    x = torch.from_numpy((rng.normal(size=shape) * 3 + 1).astype(np.float32))
    cut = bounds(shape[1], size)
    parts = torch.stack([k3.instance_norm_stats_plain(x[:, cut[s]:cut[s + 1]])
                         for s in range(size)])
    _, ms = k3.instance_norm_apply_plain(x[:, cut[0]:cut[1]], None, parts, True)
    got = replay_merge(parts.numpy())
    assert np.array_equal(got.view(np.uint32), ms.numpy().view(np.uint32))
