"""Kernel K1 of the PyTorch port (s2d grid re-alignment,
jpdse_tpu_torch/ops/realign.py) against the JAX package's Pallas kernel
run in interpret mode. Element movement only, so every comparison is
bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdse_tpu.ops.pallas.realign import s2d_realign_pad3_pallas
from jpdse_tpu_torch.ops import realign
from test_torch_port_threads import port_test_threads  # noqa: F401

# (hs, ws, C): odd ws and C not a multiple of 8 take the kernel's
# element-wise path; hs >= 6 leaves room for extra_rows=4
CASES = [(6, 6, 5), (8, 5, 3), (7, 9, 8), (16, 32, 8)]


def _input(hs, ws, c, seed=0, b=2):
    return np.random.default_rng(seed).normal(size=(b, hs, ws, 4 * c)).astype(np.float32)


@pytest.mark.parametrize("extra_rows", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hs,ws,c", CASES)
def test_plain_matches_pallas_interpret(hs, ws, c, dtype, extra_rows):
    y = _input(hs, ws, c)
    want = s2d_realign_pad3_pallas(
        jnp.asarray(y).astype(dtype), interpret=True, extra_rows=extra_rows)
    got = realign.s2d_realign_pad3_plain(
        torch.from_numpy(y).to(getattr(torch, dtype)), extra_rows=extra_rows)
    assert got.shape == want.shape
    # bf16 -> fp32 is exact, so equal fp32 values are equal bits
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("extra_rows", [0, 4])
@pytest.mark.parametrize("hs,ws,c", CASES)
def test_source_index_mirror_equals_plain(hs, ws, c, extra_rows):
    """The kernel's index arithmetic, mirrored in numpy, gathers the plain
    version's output."""
    y = torch.from_numpy(_input(hs, ws, c, seed=1))
    idx = torch.from_numpy(realign._source_index(hs, ws, c, extra_rows))
    got = y.reshape(y.shape[0], -1)[:, idx]
    assert torch.equal(got, realign.s2d_realign_pad3_plain(y, extra_rows))


def test_wrapper_takes_plain_version_on_cpu():
    y = torch.from_numpy(_input(8, 5, 3))
    before = realign.s2d_realign_pad3.launches
    assert torch.equal(realign.s2d_realign_pad3(y, 2), realign.s2d_realign_pad3_plain(y, 2))
    assert realign.s2d_realign_pad3.launches == before


@pytest.mark.parametrize(
    "shape,extra_rows",
    [((1, 1, 4, 8), 0), ((1, 4, 4, 6), 0), ((1, 4, 4, 8), 3), ((4, 4, 8), 0)],
)
def test_wrapper_rejects_bad_shapes(shape, extra_rows):
    with pytest.raises(ValueError):
        realign.s2d_realign_pad3(torch.zeros(shape), extra_rows)
