"""Full-width parity of the PyTorch port's standard path with the JAX
package's: one 1024x512 request of the flagship (full widths and depth),
fp32 on the CPU, the same weights (drawn with numpy in the Flax layout and
carried across by ``convert.from_jax_params``) and the same batch. Codes
are equal except where the JAX pre-sign value lies within 1e-5 of 0; both
packages' ``codec_io.pack`` of the JAX codes give the same .jpds bytes (the
JAX codes for both: a bit within 1e-5 of 0 may differ between the two
packages' own codes); the image the port decodes from the codes it unpacks
from that stream is within 2e-4 of JAX's, the tolerance the tiny config's
parity holds (tests/test_torch_port_codec.py).

The base-codec recipe (``artifacts/flagship_r3_compressed``: raw semantics
and a jpg-decoded image into netG, no code) is held the same way: both
packages' ``pack`` of the side info give the same side-info-only stream,
and the port's ``CodecServer.decompress`` of it is within 2e-4 of JAX's
decode of the same inputs. So is the hires recipe's model
(``artifacts/flagship_r3_hires``: the same inputs into a LocalEnhancer,
ngf 32, its global trunk at ngf 64 on the input pooled to 512x256, one
enhancer of 3 res blocks), on the fast path too.

The full-width tests are marked ``slow``: it takes minutes and several GiB of
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
from jpdse_tpu import codec_io as jax_io
from jpdse_tpu.codecs.bridge import compress_for_model as jax_compress_for_model
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.utils.misc import tensor2im as jax_tensor2im
from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.config import Config, flagship_config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.serve import CodecServer
from test_torch_port_codec import _jax_params, _jax_presign, assert_codes_match
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W = 512, 1024
ATOL = 2e-4


def standard_path_parity(tiny: bool, seed: int = 0) -> float:
    """One H x W request through both standard paths; returns the image's
    max abs difference after asserting codes, stream and image."""
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
        stream = jax_io.pack([c[0] for c in codes], (H, W))
        assert codec_io.pack([c[0] for c in codes], (H, W)) == stream
        unpacked, hw = codec_io.unpack(stream)
        assert hw == (H, W)
        for u, c in zip(unpacked, codes):
            np.testing.assert_array_equal(u, c)
        print(f"{'tiny' if tiny else 'flagship'} .jpds of the JAX codes: v{stream[4]}, "
              f"{len(stream)} bytes, byte-identical from both packages")
        got = codec.decode_from_codes([torch.from_numpy(c) for c in unpacked]).numpy()
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


def base_codec_parity(tiny: bool, seed: int = 1, local: bool = False) -> float:
    """One H x W request of the base-codec recipe (with ``local``, the hires
    recipe's LocalEnhancer): the side-info stream both packages pack, and
    the port's decompress of it against JAX's decode, on the standard path
    and, for the LocalEnhancer, on the fast path too; returns the image's
    max abs difference."""
    jcfg = _flagship_cfg(tiny=tiny)
    m = jcfg.model
    if local:
        m.netG, m.ngf, m.n_local_enhancers = "local", 4 if tiny else 32, 1
        m.n_blocks_local = 1 if tiny else 3
    m.compute_dtype, m.no_feat_encoding, m.no_label_encoding = "float32", True, True
    jcfg.codec.use_compressed, jcfg.codec.ext, jcfg.codec.quality = True, "jpg", (50,)
    jcfg.validate()
    rng = np.random.default_rng(seed)
    label = np.repeat(np.repeat(rng.integers(0, 34, (1, H // 16, W // 16)), 16, 1), 16, 2)
    inst = np.where(label >= 24, label * 1000 + rng.integers(0, 3, label.shape), label)
    image = _batch(jcfg, 1, H, W, rng)["image"]
    d = jcfg.data
    comp, _, streams, ext = jax_compress_for_model(
        jax_tensor2im(np.asarray(image)[0], d.normalize_mean, d.normalize_std), "jpg", [50],
        d.normalize_mean, d.normalize_std, return_streams=True)
    batch = {"label": label.astype(np.float32), "instance": inst.astype(np.int32),
             "image": np.asarray(image), "compressed": comp[None]}
    jcodec = JaxCodec(jcfg)
    inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"],
                                batch["compressed"])
    params = _jax_params(jcodec, inputs, seed=seed)
    want = np.asarray(jax.jit(lambda p, i: jcodec.apply(
        {"params": p}, i, method=JaxCodec.decode)[0])(params, inputs))
    del inputs
    side = dict(label=label[0].astype(np.int32), instance=inst[0].astype(np.int32),
                base_ext=ext, base_payloads=streams)
    stream = jax_io.pack([], (H, W), jax_io.SideInfo(**side))
    assert codec_io.pack([], (H, W), codec_io.SideInfo(**side)) == stream
    err = 0.0
    for fast in (False, True) if local else (False,):
        cfg = Config.from_dict(jcfg.to_dict())
        cfg.model.fast_inference = fast
        server = CodecServer(cfg, from_jax_params(params), device="cpu")
        got = server.decompress(stream)
        err = max(err, float(np.abs(got - want[0]).max()))
        print(f"{'tiny' if tiny else 'flagship'} {'hires' if local else 'base-codec'} recipe "
              f"at {W}x{H}, {'fast' if fast else 'standard'} path: side-info stream "
              f"{len(stream)} bytes, byte-identical; image max abs diff {err:.3e}")
        np.testing.assert_allclose(got, want[0], atol=ATOL)
    return err


@pytest.mark.slow
def test_base_codec_recipe_matches_jax_at_full_width():
    base_codec_parity(tiny=False)


def test_tiny_base_codec_recipe_matches_jax_at_full_extent():
    base_codec_parity(tiny=True)


@pytest.mark.slow
def test_hires_recipe_matches_jax_at_full_width():
    base_codec_parity(tiny=False, local=True)


def test_tiny_hires_recipe_matches_jax_at_full_extent():
    base_codec_parity(tiny=True, local=True)
