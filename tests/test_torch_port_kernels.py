"""Kernels K2-K4 of the PyTorch port (jpdse_tpu_torch/ops/realign.py
``s2d_pad3``, ops/instance_norm.py, ops/head_conv.py): each plain PyTorch
version against the JAX package's Pallas kernel run on the CPU, and the
wrappers' rule (a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises, any other device raises).

Tolerances: K2 moves elements only, so it is bit-exact. K3, fp32: atol
1e-5, the tolerance tests/test_pallas_instance_norm.py holds the kernel to
(fp32 statistics summed in another order); bf16: equal up to one bf16 ulp
(a last-bit rounding of the normalized value). K4, fp32: atol 1e-5 at the
model's weight scale (normal(0, 0.02), as the reference initialises
convolutions): float reassociation of the 16-tap sum.

The mirrors of what the Hopper designs add are checked here too: K1's
zero-padded channels (bit-exact), K4's wgmma tile addressing (the TMA
boxes it loads and the epilogue's pixel map) emulated in numpy against the
plain conv, K4 on the padded operands against the Pallas kernel on the
unpadded ones, and K3's partition of each slab across the resident blocks
of one cooperative launch.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdse_tpu.ops import s2d as js2d
from jpdse_tpu.ops.pallas import instance_norm as pin
from jpdse_tpu.ops.pallas.head_conv import head_conv_extra_rows as jax_extra_rows
from jpdse_tpu.ops.pallas.head_conv import head_conv_s2d_pallas
from jpdse_tpu.ops.pallas.realign import s2d_pad3_pallas, s2d_realign_pad3_pallas
from jpdse_tpu_torch.ops import build, head_conv, instance_norm, realign
from jpdse_tpu_torch.ops import s2d as ts2d
from test_torch_port_threads import port_test_threads  # noqa: F401


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))


def _np(a):
    """A JAX or torch array as fp32 numpy (bf16 -> fp32 is exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


# -- K2: s2d_pad3 --------------------------------------------------------------

@pytest.mark.parametrize("extra_rows", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [3, 5, 39])
def test_s2d_pad3_plain_matches_pallas_interpret(c, dtype, extra_rows):
    x = _x((2, 12, 10, c))
    want = s2d_pad3_pallas(_jax(x, dtype), interpret=True, extra_rows=extra_rows)
    got = realign.s2d_pad3_plain(_torch(x, dtype), extra_rows)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("h,w,c,extra_rows", [
    (8, 6, 3, 0), (8, 6, 3, 2), (12, 10, 39, 0), (12, 10, 39, 3), (4, 8, 36, 0), (16, 4, 5, 1)])
def test_s2d_pad3_source_index_mirror_equals_plain(h, w, c, extra_rows):
    """K2's index arithmetic, mirrored in numpy, gathers the plain version's
    output."""
    x = torch.from_numpy(_x((2, h, w, c), seed=1))
    idx = torch.from_numpy(realign._front_source_index(h, w, c, extra_rows))
    got = x.reshape(2, -1)[:, idx]
    assert torch.equal(got, realign.s2d_pad3_plain(x, extra_rows))


@pytest.mark.parametrize("shape,extra_rows", [((1, 8, 5, 3), 0), ((1, 2, 8, 3), 0),
                                              ((8, 8, 3), 0), ((1, 8, 8, 3), 4)])
def test_s2d_pad3_rejects_bad_shapes(shape, extra_rows):
    with pytest.raises(ValueError):
        realign.s2d_pad3(torch.zeros(shape), extra_rows)


# -- K3: fused_instance_norm ---------------------------------------------------

@pytest.fixture
def force_interpret():
    """Run the Pallas kernel through the TPU interpreter on the CPU, as
    tests/test_pallas_instance_norm.py does."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


COMBOS = [(True, False), (False, True), (False, False)]  # (relu, residual)


@pytest.mark.parametrize("relu,has_res", COMBOS)
def test_instance_norm_plain_matches_pallas_fp32(force_interpret, relu, has_res):
    # x*3+1: a mean far from 0 breaks a raw sum of squares; 6 channels is
    # no multiple of 128
    x = _x((2, 8, 12, 6)) * 3 + 1
    res = _x((2, 8, 12, 6), seed=1) if has_res else None
    want = pin._fused_in(jnp.asarray(x), None if res is None else jnp.asarray(res), relu, 1e-5)
    got = instance_norm.fused_instance_norm_plain(
        torch.from_numpy(x), None if res is None else torch.from_numpy(res), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("relu,has_res", COMBOS)
def test_instance_norm_plain_matches_pallas_bf16(force_interpret, relu, has_res):
    x = _x((2, 8, 8, 20)) * 3 + 1
    res = _x((2, 8, 8, 20), seed=1) if has_res else None
    want = _np(pin._fused_in(_jax(x, "bfloat16"), None if res is None else _jax(res, "bfloat16"),
                             relu, 1e-5))
    got = instance_norm.fused_instance_norm_plain(
        _torch(x, "bfloat16"), None if res is None else _torch(res, "bfloat16"), relu=relu)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    # one bf16 ulp at the larger magnitude: 2^(exponent - 7)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(want)) + 1e-30)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def test_instance_norm_wrapper_takes_plain_on_cpu_and_is_forward_only():
    """The wrapper takes the plain version on the CPU and counts no launch.
    It was forward only until the training slice: under autograd it is now
    the FusedInstanceNorm Function, whose CPU backward is the plain one."""
    x = torch.from_numpy(_x((1, 4, 6, 3)))
    before = instance_norm.fused_instance_norm.launches
    assert torch.equal(instance_norm.fused_instance_norm(x, relu=True),
                       instance_norm.fused_instance_norm_plain(x, relu=True))
    assert instance_norm.fused_instance_norm.launches == before
    xg = x.clone().requires_grad_()
    y = instance_norm.fused_instance_norm(xg, relu=True)
    assert y.grad_fn is not None and torch.equal(y.detach(), instance_norm.fused_instance_norm(x,
                                                                                      relu=True))
    g = torch.from_numpy(_x((1, 4, 6, 3), seed=1))
    (dx,) = torch.autograd.grad(y, xg, g)
    assert torch.equal(dx, instance_norm.fused_instance_norm_bwd_plain(x, g, relu=True))
    with torch.no_grad():
        assert instance_norm.fused_instance_norm(xg).grad_fn is None
    assert instance_norm.fused_instance_norm.launches == before
    with pytest.raises(ValueError, match="residual"):
        instance_norm.fused_instance_norm(x.detach(), residual=x.detach()[:, :2])


# -- K4: head_conv_s2d ---------------------------------------------------------

@pytest.mark.parametrize("b,ho,wp,c,n", [(2, 8, 13, 12, 8), (1, 12, 12, 44, 32),
                                         (1, 16, 35, 20, 16)])
def test_head_conv_plain_matches_pallas_interpret(b, ho, wp, c, n):
    kp = 4
    extra = head_conv.head_conv_extra_rows(ho, kp)
    assert extra == jax_extra_rows(ho, kp)
    x = _x((b, ho + kp - 1, wp, c))
    # the extra rows are NaN: they may be fetched but never reach an output
    xp = np.concatenate([x, np.full((b, extra, wp, c), np.nan, np.float32)], axis=1)
    w = _x((kp, kp, c, n), seed=1) * 0.02
    wf = ts2d.weights_fold_w(w).reshape(kp, kp * c, n)
    want = head_conv_s2d_pallas(jnp.asarray(xp), jnp.asarray(wf), kp=kp, ho=ho, interpret=True)
    got = head_conv.head_conv_s2d(torch.from_numpy(xp), torch.from_numpy(wf), kp, ho=ho)
    assert got.shape == want.shape == (b, ho, wp - kp + 1, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_weights_fold_w_matches_jax():
    w = _x((4, 4, 12, 8))
    np.testing.assert_array_equal(ts2d.weights_fold_w(w), js2d.weights_fold_w(w))


@pytest.mark.parametrize("ho,kp", [(256, 4), (32, 4), (16, 4), (7, 4), (8, 2)])
def test_head_conv_extra_rows_fit_k1(ho, kp):
    """K1 takes the extra rows K4's producer asks for, at the flagship's
    ho=256 and at the tests' tiny shapes."""
    extra = head_conv.head_conv_extra_rows(ho, kp)
    assert extra == jax_extra_rows(ho, kp)
    realign._check(torch.zeros((1, ho, 4, 4)), extra)


def test_head_conv_rejects_bad_shapes():
    xp, wf = torch.zeros((1, 8, 8, 12)), torch.zeros((4, 48, 8))
    with pytest.raises(ValueError, match="fold"):
        head_conv.head_conv_s2d(xp, torch.zeros((4, 44, 8)))
    with pytest.raises(ValueError, match="rows"):
        head_conv.head_conv_s2d(xp, wf, ho=6)
    assert head_conv.head_conv_s2d(xp, wf, ho=5).shape == (1, 5, 5, 8)


# -- the wrappers on a CUDA tensor whose launch fails ---------------------------

class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive a wrapper's CUDA
    branch without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(a):
    return torch.Tensor._make_subclass(_CudaLooking, torch.from_numpy(a))


CASES = {
    "s2d_realign_pad3": (realign, "_launcher", lambda: realign.s2d_realign_pad3(
        _cuda_looking(_x((1, 4, 4, 8))))),
    "s2d_pad3": (realign, "_front_launcher", lambda: realign.s2d_pad3(
        _cuda_looking(_x((1, 8, 8, 3))))),
    "fused_instance_norm": (instance_norm, "_launcher", lambda: instance_norm.fused_instance_norm(
        _cuda_looking(_x((1, 4, 4, 8))), relu=True)),
    "fused_instance_norm_bwd": (instance_norm, "_bwd_launcher",
                                lambda: instance_norm.fused_instance_norm_bwd(
                                    _cuda_looking(_x((1, 4, 4, 8))),
                                    _cuda_looking(_x((1, 4, 4, 8), 1)),
                                    _cuda_looking(_x((1, 8, 2), 2)), relu=True)),
    "head_conv_s2d": (head_conv, "_launcher", lambda: head_conv.head_conv_s2d(
        _cuda_looking(_x((1, 8, 8, 12))), _cuda_looking(_x((4, 48, 8))))),
    "head_conv_gemm": (head_conv, "_gemm_launcher", lambda: head_conv.head_conv_gemm(
        _cuda_looking(_x((64, 32))).bfloat16(), _cuda_looking(_x((32, 16))).bfloat16())),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_failed_launch_raises_without_fallback(monkeypatch, name):
    """A CUDA tensor goes to the kernel: when its launcher reports a CUDA
    error the wrapper raises, counts no launch, and never takes the plain
    version."""
    module, attr, call = CASES[name]
    wrapper = getattr(module, name)
    calls = []

    def failing(*args):
        calls.append(args)
        return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(module, attr, lambda: failing)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(module, name + "_plain", lambda *a, **k: pytest.fail("fell back"))
    before = wrapper.launches
    with pytest.raises(RuntimeError, match=f"{name}: kernel launch failed with CUDA error 700"):
        call()
    assert len(calls) == 1 and wrapper.launches == before


def test_other_devices_raise():
    meta = torch.empty((1, 8, 8, 12), device="meta")
    for call in (lambda: realign.s2d_pad3(meta[..., :3].contiguous()),
                 lambda: realign.s2d_realign_pad3(meta),
                 lambda: instance_norm.fused_instance_norm(meta),
                 lambda: head_conv.head_conv_s2d(meta, torch.empty((4, 48, 8), device="meta"))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# -- K1's zero-padded channels (K4's producer) -----------------------------------

@pytest.mark.parametrize("hs,ws,c,extra_rows,channels", [
    (6, 6, 5, 0, 24), (8, 5, 3, 2, 16), (16, 20, 39, 1, 160), (7, 9, 36, 1, 144)])
def test_realign_padded_channels_mirror_equals_plain(hs, ws, c, extra_rows, channels):
    """K1 with ``channels`` > 4C: the numpy mirror (-1 marks a zero channel)
    gathers the plain version's output bit for bit, and the first 4C
    channels are the unpadded form."""
    y = torch.from_numpy(_x((2, hs, ws, 4 * c), seed=2))
    idx = torch.from_numpy(realign._source_index(hs, ws, c, extra_rows, channels))
    flat = torch.cat([y.reshape(2, -1), torch.zeros((2, 1))], dim=1)
    got = flat[:, torch.where(idx < 0, flat.shape[1] - 1, idx)]
    want = realign.s2d_realign_pad3_plain(y, extra_rows, channels)
    assert want.shape == (2, hs + 3 + extra_rows, ws + 3, channels)
    assert torch.equal(got, want)
    assert torch.equal(want[..., : 4 * c], realign.s2d_realign_pad3_plain(y, extra_rows))
    assert not want[..., 4 * c:].any()
    with pytest.raises(ValueError, match="channels"):
        realign.s2d_realign_pad3(y, extra_rows, 4 * c - 1)


@pytest.mark.parametrize("c,want", [(156, 160), (144, 144), (12, 16), (8, 8)])
def test_head_conv_padded_channels_and_routes(c, want):
    """bf16 operands off the wgmma route's grid (C or N not a multiple of
    8) are zero-padded to it: the padded operands compute the same conv in
    the first N outputs and zeros past them; N > 256 is refused."""
    assert head_conv.padded_channels(c) == want
    n = 100
    xp = torch.from_numpy(_x((1, 7, 9, c)))
    w = torch.from_numpy(_x((4, 4 * c, n), seed=1))
    xq, wq = head_conv._pad_operands(xp, w, 4, want, head_conv.padded_channels(n))
    assert xq.shape == (1, 7, 9, want) and wq.shape == (4, 4 * want, 104)
    got = head_conv.head_conv_s2d_plain(xq, wq)
    ref = head_conv.head_conv_s2d_plain(xp, w)
    torch.testing.assert_close(got[..., :n], ref, rtol=1e-5, atol=1e-4)
    assert not got[..., n:].any()
    with pytest.raises(ValueError, match="N <= 256"):
        head_conv.head_conv_s2d(_cuda_looking(_x((1, 8, 8, c))).bfloat16(),
                                _cuda_looking(_x((4, 4 * c, 264))).bfloat16())


# -- K4's wgmma route: tile addressing mirrored in numpy ---------------------------

def _emulate_wgmma(xp: np.ndarray, wf: np.ndarray, kp: int, ho: int) -> np.ndarray:
    """K4's wgmma route in numpy: per output tile, the producer's TMA boxes
    (zeros outside the tensors) multiplied and summed in fp32, then the
    epilogue's scatter to output pixels."""
    b, hp, wp, c = xp.shape
    n = wf.shape[-1]
    wo = wp - kp + 1
    a2 = xp.reshape(-1, c)
    b2 = wf.reshape(-1, n)
    bm, bk = head_conv._WGMMA_BM, head_conv._WGMMA_BK

    def box(mat, r0, c0, rows, cols):
        out = np.zeros((rows, cols), np.float32)
        part = mat[r0: r0 + rows, c0: c0 + cols]
        out[: part.shape[0], : part.shape[1]] = part
        return out

    out = np.full((b * ho * wo, n), np.nan, np.float32)
    for t in range(head_conv._wgmma_tiles(b, ho, wo)):
        acc = np.zeros((bm, n), np.float32)
        for a_row, a_col, b_row in head_conv._wgmma_boxes(hp, wp, c, kp, ho, wo, t):
            acc += box(a2, a_row, a_col, bm, bk) @ box(b2, b_row, 0, bk, n)
        pix = head_conv._wgmma_tile_pixels(ho, wo, t)
        out[pix[pix >= 0]] = acc[pix >= 0]
    return out.reshape(b, ho, wo, n)


@pytest.mark.parametrize("b,ho,wp,c,n", [
    (2, 5, 9, 16, 8),      # one tile per output row, C < 32: one partial step per tap
    (1, 2, 133, 40, 16),   # wo = 130: two tiles per row, the second mostly past the row
    (1, 3, 12, 160, 24),   # the netG head's padded C: five steps per tap
    (1, 3, 12, 144, 8),    # netE4label's C: the fifth step half past C
])
def test_head_conv_wgmma_addressing_mirror_matches_plain(b, ho, wp, c, n):
    kp = 4
    extra = head_conv.head_conv_extra_rows(ho, kp)
    xp = _x((b, ho + kp - 1 + extra, wp, c), seed=3)
    xp[:, ho + kp - 1:] = np.nan  # never read into an output
    wf = _x((kp, kp * c, n), seed=4) * 0.02
    got = _emulate_wgmma(np.nan_to_num(xp, nan=0.0), wf, kp, ho)
    want = head_conv.head_conv_s2d_plain(torch.from_numpy(xp), torch.from_numpy(wf), kp, ho=ho)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_head_conv_padded_fold_matches_pallas_on_unpadded():
    """K4 at the kernel configuration's tiny netG head (C = 156 s2d
    channels, N = 4 * ngf = 32) as the port feeds it, xp from K1 padded to
    160 channels and the folded weights with 4 zero input channels per tap,
    against the Pallas kernel on the unpadded operands (interpret mode)."""
    kp, c, n, ho, ws = 4, 156, 32, 8, 16
    extra = head_conv.head_conv_extra_rows(ho, kp)
    y = torch.from_numpy(_x((1, ho, ws, c), seed=5))
    xp = realign.s2d_realign_pad3(y, extra)
    xp_pad = realign.s2d_realign_pad3(y, extra, head_conv.padded_channels(c))
    w = _x((kp, kp, c, n), seed=6) * 0.02
    w_pad = np.pad(w, ((0, 0), (0, 0), (0, head_conv.padded_channels(c) - c), (0, 0)))
    wf = ts2d.weights_fold_w(w).reshape(kp, kp * c, n)
    wf_pad = ts2d.weights_fold_w(w_pad).reshape(kp, -1, n)
    want = head_conv_s2d_pallas(jnp.asarray(xp.numpy()), jnp.asarray(wf), kp=kp, ho=ho,
                                interpret=True)
    got = head_conv.head_conv_s2d(xp_pad, torch.from_numpy(wf_pad), kp, ho=ho)
    assert got.shape == want.shape == (1, ho, ws, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # and K1's padded form is the Pallas re-alignment with zero channels
    jx = np.asarray(s2d_realign_pad3_pallas(jnp.asarray(y.numpy()), interpret=True,
                                            extra_rows=extra))
    np.testing.assert_array_equal(xp_pad.numpy()[..., :c], jx)


def test_head_conv_gemm_takes_plain_on_cpu_and_checks_shapes():
    a = torch.from_numpy(_x((40, 24))).bfloat16()
    b = torch.from_numpy(_x((24, 16), seed=1)).bfloat16()
    before = head_conv.head_conv_gemm.launches
    got = head_conv.head_conv_gemm(a, b)
    assert got.dtype == torch.bfloat16 and torch.equal(got, head_conv.head_conv_gemm_plain(a, b))
    assert head_conv.head_conv_gemm.launches == before
    np.testing.assert_allclose(got.float().numpy(), a.float().numpy() @ b.float().numpy(),
                               rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        head_conv.head_conv_gemm(a, b[:20])


# -- K3's partition across the resident blocks ----------------------------------

@pytest.mark.parametrize("sm_count", [114, 132])
@pytest.mark.parametrize("b,hw,c,vec", [
    (1, 512 * 1024, 64, 8), (1, 256 * 512, 128, 8), (1, 128 * 256, 256, 8),
    (1, 64 * 128, 512, 8), (1, 32 * 64, 1024, 8),  # the flagship's norm slabs, bf16
    (1, 512 * 1024, 64, 4),  # the same slab in fp32
    (2, 96, 6, 1),           # a tiny slab with channels that fill no word
    (300, 64, 16, 8),        # more slabs than blocks: whole slabs in turn
    (2, 40, 8192, 8),        # channel groups past one block: two channel tiles
])
def test_instance_norm_plan_covers_every_row_once(sm_count, b, hw, c, vec):
    """For an H100 PCIe (114 SMs) and SXM (132), one block per SM: every row
    of every (batch element, channel) is in exactly one block item, each
    block's items come in a fixed increasing order, and the grid and the
    chunk count stay within what the card and the workspace hold."""
    grid, chunks, rows = instance_norm.plan(b, hw, c, vec, sm_count)
    assert 1 <= grid <= sm_count
    assert 1 <= chunks <= instance_norm.max_chunks(hw, c, vec)
    assert chunks * rows >= hw > (chunks - 1) * rows
    items = instance_norm.block_items(b, hw, c, vec, grid, chunks, rows)
    assert len(items) == grid and all(items)
    assert items == instance_norm.block_items(b, hw, c, vec, grid, chunks, rows)
    cover = np.zeros((b, hw, c // vec), np.int32)
    for block in items:
        assert block == sorted(block)
        for bi, c0, c1, r0, r1 in block:
            assert r0 < r1 and c0 < c1
            cover[bi, r0:r1, c0 // vec: c1 // vec] += 1
    assert (cover == 1).all()


def test_instance_norm_plan_fills_the_card():
    """A single large slab is cut into one chunk per resident block."""
    for sms in (114, 132):
        assert instance_norm.plan(1, 512 * 1024, 64, 8, sms)[:2] == (sms, sms)
    assert instance_norm.vector_width(64, 2) == 8 and instance_norm.vector_width(64, 4) == 4
    assert instance_norm.vector_width(6, 2) == 1 and instance_norm.vector_width(64, 2, False) == 1


# -- every launcher's ctypes signature against its C prototype ------------------

_C_TYPES = {"const void*": "p", "void*": "p", "long long": "l", "int": "i", "float": "f"}


def _c_prototype(library: str, symbol: str) -> str:
    """The argument kinds of ``extern "C" int symbol(...)`` in
    csrc/<library>.cu, in c_function's letters, the stream left off."""
    import re

    src = (build.CSRC_DIR / f"{library}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, symbol
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    assert params[-1] == "void*", params  # the stream
    return "".join(_C_TYPES[p] for p in params[:-1])


@pytest.mark.parametrize("module,attr", [
    (realign, "_launcher"), (realign, "_front_launcher"), (instance_norm, "_launcher"),
    (instance_norm, "_bwd_launcher"), (instance_norm, "_stats_launcher"),
    (instance_norm, "_apply_launcher"), (instance_norm, "_sums_launcher"),
    (instance_norm, "_dx_launcher"),
    (head_conv, "_launcher"), (head_conv, "_gemm_launcher")])
def test_launcher_signatures_match_the_c_prototypes(monkeypatch, module, attr):
    """ctypes passes what the wrapper declares: a letter short or wrong
    would shift or cut every argument after it on the card."""
    seen = {}

    def fake_c_function(library, symbol, signature):
        seen.update(library=library, symbol=symbol, signature=signature)

    monkeypatch.setattr(build, "c_function", fake_c_function)
    getattr(module, attr).__wrapped__()
    assert seen["signature"] == _c_prototype(seen["library"], seen["symbol"]), seen
