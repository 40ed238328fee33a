"""The port's metrics (jpdse_tpu_torch.ops.metrics) against the JAX
package's on the same uint8 arrays, within 1e-5: L1, MSE, PSNR, SSIM,
MS-SSIM (including levels smaller than the 11x11 window, where both
zero-pad) on random images and on real 1024x512 reconstructions tracked
under artifacts/, the denormalization to uint8 and the Bernoulli rate.

MS-SSIM is also held within 1e-5 of the same formula in float64. On a
nearly flat image the fp32 variance form E[x^2] - E[x]^2 cancels: there
the port is held within 1e-5 of float64 and at least as close to it as
the JAX package's fp32 value, which the test prints."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jpdse_tpu.ops import metrics as jm
from jpdse_tpu_torch.ops import metrics as pm

REPO = Path(__file__).resolve().parents[1]
GALLERY = REPO / "artifacts/flagship_r3/eval_phase3/test_visualizations/images"
REAL = sorted(p.name for p in (GALLERY / "image").glob("*.png"))[:2]
TOL = 1e-5


def _pair(a: np.ndarray, b: np.ndarray):
    return (torch.from_numpy(a.astype(np.float32)), torch.from_numpy(b.astype(np.float32)),
            jnp.asarray(a.astype(np.float32)), jnp.asarray(b.astype(np.float32)))


def _close(got, want, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (what, got, want)


def _blur64(x: np.ndarray) -> np.ndarray:
    """The separable 11x11 Gaussian (sigma 1.5) in float64, VALID, zero
    padded by 5 where the input is smaller than the window."""
    g = np.exp(-((np.arange(11) - 5) ** 2) / (2.0 * 1.5**2))
    g /= g.sum()
    if min(x.shape[1], x.shape[2]) < 11:
        x = np.pad(x, ((0, 0), (5, 5), (5, 5), (0, 0)))
    for axis in (1, 2):
        x = np.apply_along_axis(lambda v: np.convolve(v, g, "valid"), axis, x)
    return x


def _ms_ssim64(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.astype(np.float64) / 255.0, b.astype(np.float64) / 255.0
    c1, c2 = 0.01**2, 0.03**2
    mcs = []
    for i in range(5):
        mu_a, mu_b = _blur64(a), _blur64(b)
        sa, sb = _blur64(a * a) - mu_a**2, _blur64(b * b) - mu_b**2
        sab = _blur64(a * b) - mu_a * mu_b
        cs = (2 * sab + c2) / (sa + sb + c2)
        ssim_v = np.mean((2 * mu_a * mu_b + c1) / (mu_a**2 + mu_b**2 + c1) * cs)
        mcs.append(np.mean(cs))
        if i < 4:
            hh, ww = a.shape[1] // 2 * 2, a.shape[2] // 2 * 2
            a, b = (x[:, :hh, :ww].reshape(x.shape[0], hh // 2, 2, ww // 2, 2, -1).mean((2, 4))
                    for x in (a, b))
    w = np.asarray(pm.MSSSIM_WEIGHTS)
    return float(np.prod(np.maximum(mcs[:-1], 0) ** w[:-1]) * max(ssim_v, 0) ** w[-1])


def _all_metrics_match(a: np.ndarray, b: np.ndarray, jax_ms_ssim: bool = True):
    ta, tb, ja, jb = _pair(a, b)
    _close(pm.l1(ta, tb), jm.l1(ja, jb), "l1")
    _close(pm.mse(ta, tb), jm.mse(ja, jb), "mse")
    _close(pm.psnr(ta, tb), jm.psnr(ja, jb), "psnr")
    got = pm.ms_ssim(ta, tb)
    _close(got, _ms_ssim64(a, b), "ms_ssim against float64")
    if jax_ms_ssim:
        for g, w in zip(pm.ssim(ta, tb), jm.ssim(ja, jb)):
            _close(g, w, "ssim")
        _close(got, jm.ms_ssim(ja, jb), "ms_ssim")


@pytest.mark.parametrize("shape", [(1, 64, 128, 3), (2, 96, 80, 3), (1, 40, 44, 3),
                                   (1, 176, 200, 1)])
def test_metrics_match_jax_on_random_images(shape):
    """(1, 40, 44): levels of 10x11 and smaller fall back to zero padding;
    (1, 176, 200): every level is at least the window."""
    rng = np.random.default_rng(shape[1])
    a = rng.integers(0, 256, shape).astype(np.uint8)
    noise = rng.integers(-30, 31, shape)
    b = np.clip(a.astype(np.int64) + noise, 0, 255).astype(np.uint8)
    _all_metrics_match(a, b)


def test_metrics_match_jax_on_flat_and_equal_images():
    a = np.full((1, 48, 64, 3), 250, np.uint8)
    b = a.copy()
    b[0, 10:20, 10:20] = 255
    _all_metrics_match(a, b, jax_ms_ssim=False)
    exact = _ms_ssim64(a, b)
    ta, tb, ja, jb = _pair(a, b)
    port_err = abs(float(pm.ms_ssim(ta, tb)) - exact)
    jax_err = abs(float(jm.ms_ssim(ja, jb)) - exact)
    print(f"nearly flat image: MS-SSIM from float64, port {port_err:.3e}, JAX {jax_err:.3e}")
    assert port_err <= jax_err
    _all_metrics_match(a, a)  # PSNR at the 1e-12 floor, MS-SSIM 1


@pytest.mark.parametrize("name", REAL)
def test_metrics_match_jax_on_real_reconstructions(name):
    real = np.asarray(Image.open(GALLERY / "image" / name).convert("RGB"))[None]
    recon = np.asarray(Image.open(GALLERY / "reconstructed_image" / name).convert("RGB"))[None]
    assert real.shape == (1, 512, 1024, 3)
    _all_metrics_match(recon, real)


def test_denormalize_to_uint8_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 7, 3)).astype(np.float32)
    for mean, std in (((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)), ((0.5, 0.5, 0.5), (1.0, 1.0, 1.0))):
        got = pm.denormalize_to_uint8(torch.from_numpy(x), mean, std).numpy()
        want = np.asarray(jm.denormalize_to_uint8(jnp.asarray(x), mean, std))
        assert np.array_equal(got, want)
        assert got.min() >= 0 and got.max() <= 255 and np.array_equal(got, np.floor(got))


@pytest.mark.parametrize("natural_log", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_bernoulli_shannon_bpp_matches_jax(p, natural_log):
    rng = np.random.default_rng(int(p * 10))
    code = (rng.random((8, 16, 5)) < p).astype(np.float32)
    got = pm.bernoulli_shannon_bpp(torch.from_numpy(code), 64 * 128, natural_log)
    want = jm.bernoulli_shannon_bpp(jnp.asarray(code), 64 * 128, natural_log)
    for g, w in zip(got, want):
        _close(g, w, "bpp")
    assert float(got[1]) == code.size / (64 * 128)
