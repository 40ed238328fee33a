"""Full-width parity of the PyTorch port's standard path with the JAX
package's: one 1024x512 request of the flagship (full widths and depth),
fp32 on the CPU, the same weights (drawn with numpy in the Flax layout and
carried across by ``convert.from_jax_params``) and the same batch. Codes
are equal except where the JAX pre-sign value lies within 1e-5 of 0; the
image decoded from the JAX codes is within 2e-4, the tolerance the tiny
config's parity holds (tests/test_torch_port_codec.py).

The full-width test is marked ``slow``: it takes minutes and several GiB of
host memory, so tier-1 (``-m 'not slow'``) leaves it out. Run it with

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_port_fullwidth.py

The same check at the tiny widths and the full 1024x512 extent runs in
tier-1, so the comparison itself is exercised on every run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu_torch.config import flagship_config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.models.codec import SemanticCodec
from test_torch_port_codec import _jax_params, _jax_presign, assert_codes_match

H, W = 512, 1024
ATOL = 2e-4


def standard_path_parity(tiny: bool, seed: int = 0) -> float:
    """One H x W request through both standard paths; returns the image's
    max abs difference after asserting codes and image."""
    jcfg = _flagship_cfg(tiny=tiny)
    jcfg.model.compute_dtype = "float32"
    jcodec = JaxCodec(jcfg)
    batch = {k: np.array(v)
             for k, v in _batch(jcfg, 1, H, W, np.random.default_rng(seed)).items()}
    inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"])
    params = _jax_params(jcodec, inputs, seed=seed)
    codes = [np.array(c) for c in jax.jit(lambda p, i: jcodec.apply(
        {"params": p}, i, method=JaxCodec.get_codes_shaped))(params, inputs)]
    presign = _jax_presign(jcodec, params, inputs)
    want = np.asarray(jax.jit(lambda p, c: jcodec.apply(
        {"params": p}, c, method=JaxCodec.decode_from_codes))(params, [jnp.asarray(c) for c in codes]))
    del inputs

    cfg = flagship_config(tiny=tiny)
    cfg.model.compute_dtype = "float32"
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got_codes = codec.get_codes_shaped(codec.prepare(
            {k: torch.from_numpy(v) for k, v in batch.items()}))
        for name, g, w, p in zip(("netE4label", "netE"), got_codes, codes, presign):
            assert_codes_match(g.numpy(), w, p, name)
        got = codec.decode_from_codes([torch.from_numpy(c) for c in codes]).numpy()
    assert got.shape == want.shape == (1, H, W, 3)
    err = float(np.abs(got - want).max())
    print(f"{'tiny' if tiny else 'flagship'} standard path at {W}x{H}: image max abs diff {err:.3e}")
    np.testing.assert_allclose(got, want, atol=ATOL)
    return err


@pytest.mark.slow
def test_flagship_standard_path_matches_jax_at_full_width():
    standard_path_parity(tiny=False)


def test_tiny_standard_path_matches_jax_at_full_extent():
    standard_path_parity(tiny=True)
