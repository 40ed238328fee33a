"""The backward of kernel K3 (jpdse_tpu_torch/csrc/instance_norm.cu,
instance_norm_bwd_kernel), its partition and its shared-memory cache
emulated on the CPU: which rows each block reads in phase 1, which loop
iterations it keeps in which shared-memory slot, and the order in which
phase 3 walks them again (``instance_norm.plan``, ``block_items``,
``bwd_cache_iters``, ``bwd_walk``). A numpy emulation of the kernel's loads,
cache and order computes dx and is held against
``fused_instance_norm_bwd_plain`` on the same statistics. The kernel has
no CPU mode; the card checks the kernel itself (tests/test_torch_port_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from jpdse_tpu_torch.ops import instance_norm

# (batch, rows, channels, channels a word, bytes a channel)
FLAGSHIP = [(1, 512 * 1024, 64), (1, 256 * 512, 128), (1, 128 * 256, 256),
            (1, 64 * 128, 512), (1, 32 * 64, 1024)]
CASES = ([(b, hw, c, 8, 2) for b, hw, c in FLAGSHIP]            # serving, bf16
         + [(2, hw, c, 4, 4) for _, hw, c in FLAGSHIP]          # the training step, fp32
         + [(1, 512 * 1024, 64, 4, 4),  # the largest slab in fp32 at batch 1
            (2, 96, 6, 1, 2),           # channels that fill no word
            (300, 64, 16, 8, 2),        # more slabs than blocks: whole slabs in turn
            (2, 40, 8192, 8, 2)])       # two channel tiles


def _walks(b, hw, c, vec, sms, cache_iters):
    grid, chunks, rows = instance_norm.plan(b, hw, c, vec, sms)
    args = (b, hw, c, vec, grid, chunks, rows, cache_iters)
    return instance_norm.bwd_walk(*args, phase=1), instance_norm.bwd_walk(*args, phase=3)


def _rows(step, pix):
    """The rows [lo, hi) of one step: its iteration's pixel lanes in the item."""
    (bi, c0, c1, r0, r1), k, _ = step
    return r0 + k * pix, min(r0 + (k + 1) * pix, r1)


def _schedule(steps, phase):
    """The kernel's copies and sums of one block's walk, in its order, as
    ("copy", step) and ("sum", step): for each item, in phase 1 the copies of
    its cached steps and of its first RING ring steps first; a ring step's
    sum is followed by the copy of the ring step RING further on. Phase 3
    copies only ring steps (its cached steps are still in their slots)."""
    events, i = [], 0
    while i < len(steps):
        j = i
        while j < len(steps) and steps[j][0] == steps[i][0]:
            j += 1
        item = steps[i:j]
        ring = [st for st in item if st[2][0] == "ring"]
        first = [st for st in item if st[2][0] == "cache"] if phase == 1 else []
        events += [("copy", st) for st in first + ring[:instance_norm.RING]]
        nxt = instance_norm.RING
        for st in item:
            events.append(("sum", st))
            if st[2][0] == "ring" and nxt < len(ring):
                events.append(("copy", ring[nxt]))
                nxt += 1
        i = j
    return events


def _check_slots(events, cache=None):
    """Every slot is copied to only when it holds nothing unsummed (a ring
    slot) or nothing at all (a cache slot, in phase 1), and every sum reads
    the step last copied to its slot. Returns the cache slots' contents."""
    cache = {} if cache is None else cache
    ring = {}
    for what, step in events:
        kind, i = step[2]
        if what == "copy":
            if kind == "ring":
                assert ring.get(i) is None, step
                ring[i] = step[:2]
            else:
                assert i not in cache, step
                cache[i] = step[:2]
        elif kind == "ring":
            assert ring.get(i) == step[:2], step
            ring[i] = None
        else:
            assert cache.get(i) == step[:2], step
    assert not any(ring.values())
    return cache


@pytest.mark.parametrize("sm_count", [114, 132])
@pytest.mark.parametrize("b,hw,c,vec,elt", CASES)
def test_bwd_walk_covers_once_and_phase3_reverses_it(sm_count, b, hw, c, vec, elt):
    """For an H100 PCIe (114 SMs) and SXM (132), one block per SM: phase 1
    reads every (batch element, row, channel group) exactly once; phase 3
    takes phase 1's steps in reverse; each block's cache slots are 0, 1,
    ... in phase 1's order, one iteration each, its first ones, as many as
    the shared memory holds or the block has iterations; every slot, cache
    or ring, is copied to before it is summed and not overwritten before,
    and phase 3 reads each cache slot for the iteration phase 1 wrote to
    it; the ring and the cache fit the shared memory a block may opt in to,
    with no room for one more slot, and the ring covers the reduction
    area."""
    cache_iters = instance_norm.bwd_cache_iters(vec, elt)
    slot_bytes = instance_norm.THREADS * 2 * vec * elt
    assert (cache_iters + instance_norm.RING) * slot_bytes <= instance_norm.SMEM_OPTIN
    assert (cache_iters + instance_norm.RING + 1) * slot_bytes > instance_norm.SMEM_OPTIN
    assert instance_norm.RING * slot_bytes >= instance_norm.THREADS * 2 * vec * 4
    pix = instance_norm._tiling(c, vec)[3]
    phase1, phase3 = _walks(b, hw, c, vec, sm_count, cache_iters)
    assert 1 <= len(phase1) <= sm_count
    spans = {}
    for steps, back in zip(phase1, phase3):
        assert [st[:2] for st in back] == [st[:2] for st in steps[::-1]]
        cached = [slot[1] for _, _, slot in steps if slot[0] == "cache"]
        assert cached == list(range(min(cache_iters, len(steps))))
        assert all(slot[0] == "ring" for _, _, slot in steps[len(cached):])
        written = _check_slots(_schedule(steps, 1))
        assert _check_slots(_schedule(back, 3), dict(written)) == written
        for step in steps:
            bi, c0, c1, _, _ = step[0]
            spans.setdefault((bi, c0 // vec, c1 // vec), []).append(_rows(step, pix))
    groups = c // vec
    tiles = {(bi, g0, g1) for bi, g0, g1 in spans}
    assert {bi for bi, _, _ in tiles} == set(range(b))
    for bi in range(b):  # the channel tiles of each batch element cover its groups once
        edges = sorted((g0, g1) for b2, g0, g1 in tiles if b2 == bi)
        assert edges[0][0] == 0 and edges[-1][1] == groups
        assert all(a[1] == n[0] for a, n in zip(edges, edges[1:]))
    for key, rows in spans.items():  # and each tile's rows, once
        rows.sort()
        assert rows[0][0] == 0 and rows[-1][1] == hw
        assert all(lo < hi for lo, hi in rows)
        assert all(a[1] == n[0] for a, n in zip(rows, rows[1:])), key


def test_bwd_cache_holds_the_small_slabs():
    """On an H100 (132 SMs) the cache holds every row of the serving path's
    two smallest norm slabs in bf16, so there each byte of x and g is read
    from device memory once; at the largest it holds the first 11 of each
    block's at most 63 iterations."""
    for (b, hw, c), whole in zip(FLAGSHIP, (False, False, False, True, True)):
        phase1, _ = _walks(b, hw, c, 8, 132, instance_norm.bwd_cache_iters(8, 2))
        assert all(slot[0] == "cache" for steps in phase1 for _, _, slot in steps) == whole
    phase1, _ = _walks(1, 512 * 1024, 64, 8, 132, instance_norm.bwd_cache_iters(8, 2))
    assert max(len(steps) for steps in phase1) == 63
    assert {sum(slot[0] == "cache" for _, _, slot in steps) for steps in phase1} == {11}
    assert instance_norm.bwd_cache_iters(8, 2) == 11 and instance_norm.bwd_cache_iters(4, 4) == 11


def _stats(x: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """The forward's fp32 (b, c, 2) mean and rstd, two-pass."""
    mean = x.mean(axis=(1, 2), dtype=np.float32)
    var = ((x - mean[:, None, None]) ** 2).mean(axis=(1, 2), dtype=np.float32)
    return np.stack([mean, (1.0 / np.sqrt(var + np.float32(eps))).astype(np.float32)], -1)


def _emulate(x, g, stats, relu, vec, max_blocks, cache_iters):
    """dx as the backward kernel computes it, event by event through
    ``bwd_walk`` and the kernel's copy order (``_schedule``): a copy reads a
    step's rows of x and g from device memory into its slot (cache or ring)
    of its block's shared memory; a sum reads them from the slot. Phase 1
    sums g' and g' * xhat per (b, chunk, channel); phase 2 adds the chunks
    in order; phase 3 writes dx. Asserts that phase 1 reads each element
    from device memory once, that phase 3 reads from device memory only
    what the cache does not hold, that each sum reads the rows of its own
    step, and that dx is written once."""
    b, h, w, c = x.shape
    hw = h * w
    grid, chunks, rows = instance_norm.plan(b, hw, c, vec, max_blocks)
    args = (b, hw, c, vec, grid, chunks, rows, cache_iters)
    pix = instance_norm._tiling(c, vec)[3]
    xf, gf = x.reshape(b, hw, c), g.reshape(b, hw, c)
    mean, rstd = stats[..., 0], stats[..., 1]
    reads = {1: np.zeros((b, hw, c), np.int32), 3: np.zeros((b, hw, c), np.int32)}
    cached = np.zeros((b, hw, c), bool)
    written = np.zeros((b, hw, c), np.int32)
    partial = np.zeros((b, chunks, c, 2), np.float32)
    means = None
    dx = np.zeros((b, hw, c), np.float32)

    def terms(bi, c0, c1, xs, gs):
        xh = (xs - mean[bi, c0:c1]) * rstd[bi, c0:c1]
        gg = np.where(xh > 0, gs, np.float32(0)) if relu else gs
        return xh, gg

    smem = [{} for _ in range(grid)]  # each block's slots: ("cache" | "ring", i) -> words
    for phase in (1, 3):
        if phase == 3:
            means = partial.sum(axis=1, dtype=np.float32) / np.float32(hw)  # (b, c, 2)
        for blk, steps in enumerate(instance_norm.bwd_walk(*args, phase=phase)):
            for what, ((bi, c0, c1, r0, r1), k, slot) in _schedule(steps, phase):
                lo, hi = r0 + k * pix, min(r0 + (k + 1) * pix, r1)
                where = (bi, c0, c1, lo, hi)
                if what == "copy":
                    smem[blk][slot] = (where, xf[bi, lo:hi, c0:c1].copy(),
                                       gf[bi, lo:hi, c0:c1].copy())
                    reads[phase][bi, lo:hi, c0:c1] += 1
                    if slot[0] == "cache":
                        assert 0 <= slot[1] < cache_iters
                        cached[bi, lo:hi, c0:c1] = True
                    continue
                got, xs, gs = smem[blk][slot]
                assert got == where
                xh, gg = terms(bi, c0, c1, xs, gs)
                if phase == 1:
                    acc = partial[bi, r0 // rows, c0:c1]
                    acc[:, 0] += gg.sum(axis=0, dtype=np.float32)
                    acc[:, 1] += (gg * xh).sum(axis=0, dtype=np.float32)
                else:
                    gm, gx = means[bi, c0:c1, 0], means[bi, c0:c1, 1]
                    dx[bi, lo:hi, c0:c1] = rstd[bi, c0:c1] * (gg - gm - xh * gx)
                    written[bi, lo:hi, c0:c1] += 1
    assert (reads[1] == 1).all() and (written == 1).all()
    assert (reads[3] == ~cached).all()
    return dx.reshape(x.shape), cached.mean()


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape,vec,max_blocks,cache_iters", [
    ((2, 64, 40, 16), 4, 5, 2),     # two slabs in chunks: 2 of 10 iterations cached
    ((7, 16, 20, 8), 4, 3, 3),      # blocks take 2-3 whole slabs; later items through the ring
    ((2, 9, 11, 6), 1, 2, 1),       # channels that fill no word; one slab a block
    ((1, 24, 32, 64), 4, 6, 64),    # the whole slab in the cache: one read
    ((2, 12, 10, 1024), 4, 4, 0),   # no cache: every step through the ring
])
def test_bwd_emulation_matches_plain(shape, vec, max_blocks, cache_iters, relu):
    """The emulated kernel's dx equals the plain version's on the forward's
    statistics (fp32 sums in another order: 1e-5, as on the card)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    stats = _stats(x)
    got, share = _emulate(x, g, stats, relu, vec, max_blocks, cache_iters)
    assert (share == 1.0) == (cache_iters == 64)
    assert (share == 0.0) == (cache_iters == 0)
    want = instance_norm.fused_instance_norm_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(g), relu, stats=torch.from_numpy(stats))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)
