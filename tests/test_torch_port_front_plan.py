"""Kernel K2's block plan (jpdse_tpu_torch/csrc/realign.cu,
s2d_pad3_front_kernel), emulated in numpy on the CPU: which source
elements each block stages in shared memory with which loads, and what
each of its stores writes, held against ``s2d_pad3_plain`` over small and
odd shapes at the largest ``extra_rows`` the wrapper accepts. The kernel
has no CPU mode, so this is where its arithmetic is tested here; the card
checks the kernel itself (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from jpdse_tpu_torch.ops import realign

SMEM_LIMIT = 227 * 1024  # shared memory a block may use on Hopper


def _emulate(x: np.ndarray, hp: int, x_off: int, out_off: int) -> np.ndarray:
    """K2's output for x (B, H, W, C) as the kernel computes it, with x and
    the output placed ``x_off`` and ``out_off`` elements past a 16-byte
    boundary. Asserts that every 16-byte load lies inside x, every 16-byte
    store is aligned, every gather hits a staged element, and every output
    element is written once."""
    bsz, h, w, c = x.shape
    es = x.dtype.itemsize
    ke = 16 // es
    wp = w // 2 + 3
    tk, ntiles, buf = realign._front_plan(w, c, es)
    assert 2 * buf * es <= SMEM_LIMIT
    flat = x.reshape(-1)
    out = np.zeros(bsz * hp * wp * 4 * c, x.dtype)
    written = np.zeros(out.size, np.int64)
    for block in range(bsz * hp * ntiles):
        b, j, k0, n, s0, s1, rows = realign._front_block(h, w, hp, tk, ntiles, block)
        span = (s1 - s0) * c
        staged, shifts = [], []
        for fm in rows:  # the two source rows, staged by 16-byte words
            src = ((b * h + fm) * w + s0) * c
            shift = (x_off + src) % ke  # elements from the 16-byte boundary below
            words = -(-(shift + span) // ke)
            assert words * ke <= buf
            smem = np.full(buf, -1, np.int64)  # source index of each staged element
            pos = np.arange(words * ke)
            inside = (pos >= shift) & (pos < shift + span)
            full = np.repeat([(i * ke >= shift) and (i * ke + ke <= shift + span)
                              for i in range(words)], ke)
            loaded = src - shift + pos[full | inside]
            assert loaded.min() >= 0 and loaded.max() < flat.size  # loads stay inside x
            smem[pos[full | inside]] = loaded
            staged.append(smem)
            shifts.append(shift)
        dst = ((b * hp + j) * wp + k0) * 4 * c
        m = n * 4 * c
        head = min(m, ((16 - ((out_off + dst) * es) % 16) % 16) // es)
        body = (m - head) // ke
        e0 = head + np.arange(body) * ke  # each 16-byte store's first element
        assert (((out_off + dst + e0) * es) % 16 == 0).all()
        t0 = realign._fast_div(e0, 2 * c)
        o0 = e0 - t0 * 2 * c
        # within a store, (t, o) step on one element at a time
        q = np.arange(ke)
        t = (t0[:, None] + (o0[:, None] + q) // (2 * c)).reshape(-1)
        o = ((o0[:, None] + q) % (2 * c)).reshape(-1)
        e = (e0[:, None] + q).reshape(-1)
        # a word the kernel reads as one run: ke consecutive staged elements of one row
        wide = realign._front_wide(w, c, k0, ke, t0, o0)
        pw, offw = realign._front_gather(w, c, k0, s0, t.reshape(body, ke)[wide],
                                         o.reshape(body, ke)[wide])
        assert (pw == pw[:, :1]).all() and (np.diff(offw, axis=1) == 1).all()
        edge = np.concatenate([np.arange(head), head + body * ke + np.arange(m - head - body * ke)])
        te = realign._fast_div(edge, 2 * c)
        t, o, e = np.concatenate([t, te]), np.concatenate([o, edge - te * 2 * c]), \
            np.concatenate([e, edge])
        p, off = realign._front_gather(w, c, k0, s0, t, o)
        assert ((off >= 0) & (off < span)).all()  # every gather reads a staged element
        src = np.where(p == 0, staged[0][shifts[0] + off], staged[1][shifts[1] + off])
        assert (src >= 0).all()
        out[dst + e] = flat[src]
        written[dst + e] += 1
    assert (written == 1).all()
    return out.reshape(bsz, hp, wp, 4 * c)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("w", [4, 6, 1024])
@pytest.mark.parametrize("c", [1, 3, 5, 36, 39])
def test_block_plan_equals_plain(c, w, dtype):
    """B=2, H=8 at its largest extra_rows (2): the plan's output equals the
    plain version bit for bit. 2-byte elements stand in for bf16, whose
    bits the kernel only moves."""
    h, extra = 8, 2
    x = np.random.default_rng(c * 7 + w).normal(size=(2, h, w, c)).astype(dtype)
    hp = h // 2 + 3 + extra
    with pytest.raises(ValueError):
        realign.s2d_pad3_plain(torch.from_numpy(x.astype(np.float32)), extra + 1)
    want = realign.s2d_pad3_plain(torch.from_numpy(x.astype(np.float32)), extra).numpy()
    for x_off, out_off in ((0, 0), (1, 3)):  # aligned and unaligned placements
        got = _emulate(x, hp, x_off, out_off)
        np.testing.assert_array_equal(got.astype(np.float32), want)


@pytest.mark.parametrize("c,es,smem_kb,tiles", [(3, 2, 12.2, 1), (36, 2, 16.3, 10),
                                                (39, 2, 16.5, 10), (3, 4, 16.1, 2),
                                                (39, 4, 17.1, 20)])
def test_block_plan_at_the_fronts(c, es, smem_kb, tiles):
    """At (1, 512, 1024, C): at most 16 KB of output a block (a whole row
    at C=3 in bf16) and as much shared memory (two source rows of two
    pixels' taps per output pixel), so eight 256-thread blocks fit an SM;
    the tiles of a row."""
    tk, ntiles, buf = realign._front_plan(1024, c, es)
    assert ntiles == tiles and tk * 4 * c * es <= realign.FRONT_TILE_BYTES
    assert abs(2 * buf * es / 1024 - smem_kb) < 0.1


def test_fast_div_equals_integer_division():
    rng = np.random.default_rng(0)
    n = np.concatenate([np.arange(5000), rng.integers(0, 2**31, 20000), [2**31 - 1]])
    for d in list(range(1, 300)) + [1023, 1024, 1025, 2**20 + 7, 2**30, 2**31 - 1]:
        np.testing.assert_array_equal(realign._fast_div(n, d), n // d)
