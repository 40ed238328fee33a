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
from jpdse_tpu.ops.pallas.realign import s2d_pad3_pallas
from jpdse_tpu_torch.ops import head_conv, instance_norm, realign
from jpdse_tpu_torch.ops import s2d as ts2d


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
    x = torch.from_numpy(_x((1, 4, 6, 3)))
    before = instance_norm.fused_instance_norm.launches
    assert torch.equal(instance_norm.fused_instance_norm(x, relu=True),
                       instance_norm.fused_instance_norm_plain(x, relu=True))
    assert instance_norm.fused_instance_norm.launches == before
    with pytest.raises(RuntimeError, match="forward only"):
        instance_norm.fused_instance_norm(x.requires_grad_())
    with torch.no_grad():
        instance_norm.fused_instance_norm(x)
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
    "head_conv_s2d": (head_conv, "_launcher", lambda: head_conv.head_conv_s2d(
        _cuda_looking(_x((1, 8, 8, 12))), _cuda_looking(_x((4, 48, 8))))),
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
