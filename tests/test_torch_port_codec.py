"""The PyTorch port's codec (jpdse_tpu_torch) against the JAX package at the
tiny flagship config, 64x128, fp32 on the CPU.

Both stacks get the same weights (drawn with numpy in the Flax layout and
carried across by ``convert.from_jax_params``) and the same numpy batch.
Images agree within atol=2e-4, the tolerance tests/test_fast_codec.py holds
between the JAX package's own two paths (float reassociation through the
s2d weight transforms and the InstanceNorm statistics). Codes are equal; a
bit may differ only where the JAX pre-sign value lies within 1e-5 of 0,
where the sign rests on rounding, and such bits are counted and reported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.models.fast_codec import FastCodec as JaxFastCodec
from jpdse_tpu_torch.config import flagship_config
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.serve import CodecServer
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W = 64, 128
ATOL = 2e-4
NEAR_ZERO = 1e-5
ENCODERS = ("netE4label", "netE")


def _jax_params(jcodec, inputs, seed=0):
    """The Flax parameter tree of ``jcodec`` (structure from eval_shape),
    filled from numpy: kernels normal(0, 0.02) as the reference inits them,
    biases small but nonzero so the bridge's bias mapping is exercised."""
    shapes = jax.eval_shape(
        lambda: jcodec.init({"params": jax.random.PRNGKey(0)}, inputs, method=JaxCodec.decode)
    )["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.02).astype(np.float32), shapes)


def _jax_presign(jcodec, params, inputs):
    """tanh of each binarizer's input conv, in get_codes_shaped order."""

    def features(mdl, inputs):
        out = []
        for name, x in zip(ENCODERS, (inputs["input_label"], inputs["real_image"])):
            enc = getattr(mdl, name)
            h = enc.head(x, False)
            for blk in enc.down:
                h = blk(h, False)
            out.append(h)
        return out

    feats = jax.jit(lambda p, i: jcodec.apply({"params": p}, i, method=features))(params, inputs)
    return [
        np.tanh(np.einsum("bhwc,cd->bhwd", np.asarray(h),
                          params[n]["binarizer"]["conv"]["kernel"][0, 0]))
        for h, n in zip(feats, ENCODERS)
    ]


def assert_codes_match(got, want, presign, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = got != want
    away = diff & (np.abs(presign) >= NEAR_ZERO)
    assert not away.any(), f"{what}: {int(away.sum())} code bits differ away from 0"
    print(f"{what}: {int(diff.sum())} of {diff.size} code bits differ, all within "
          f"{NEAR_ZERO} of 0")


@pytest.fixture(scope="module")
def ref():
    """JAX weights, batch and reference outputs, computed once."""
    jcfg = _flagship_cfg(tiny=True)
    jcfg.model.compute_dtype = "float32"
    jcodec = JaxCodec(jcfg)
    batch = {k: np.array(v) for k, v in _batch(jcfg, 2, H, W, np.random.default_rng(1)).items()}
    inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"])
    params = _jax_params(jcodec, inputs)

    def apply(method):
        return jax.jit(lambda p, i: jcodec.apply({"params": p}, i, method=method))(params, inputs)

    codes = [np.array(c) for c in apply(JaxCodec.get_codes_shaped)]
    fast = JaxFastCodec(jcfg, params, dtype=jnp.float32)
    fast_codes = [np.array(c) for c in fast.get_codes_shaped(batch)]
    # deployment stores codes as uint8 (codec_io.pack): a sign of 0 codes as 0
    codes_u8 = [c.astype(np.uint8) for c in fast_codes]
    return {
        "params": params,
        "batch": batch,
        "decode": np.asarray(apply(JaxCodec.decode)[0]),
        "codes": codes,
        "presign": _jax_presign(jcodec, params, inputs),
        "from_codes": np.asarray(jcodec.apply(
            {"params": params}, [jnp.asarray(c) for c in codes],
            method=JaxCodec.decode_from_codes)),
        "fast_decode": np.asarray(fast.decode(batch)),
        "fast_codes": fast_codes,
        "codes_u8": codes_u8,
        "fast_from_codes_u8": np.asarray(fast.decode_from_codes(
            [jnp.asarray(c, jnp.float32) for c in codes_u8])),
    }


@pytest.fixture(scope="module")
def port(ref):
    cfg = flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(ref["params"]))
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    return cfg, codec, batch


def test_bridge_round_trip_is_bit_equal(ref):
    """JAX -> port -> JAX gives back every array bit for bit, and the port's
    modules take the converted state dict with every key and shape."""
    state = from_jax_params(ref["params"])
    cfg = flagship_config(tiny=True)
    SemanticCodec(cfg, device="cpu", seed=None).load_state_dict(state, strict=True)
    back = to_jax_params(state)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, ref["params"]))
    jax.tree_util.tree_map(np.testing.assert_array_equal, ref["params"], back)


def test_semantic_codec_decode_matches_jax(ref, port):
    _, codec, batch = port
    with torch.no_grad():
        got = codec.decode(codec.prepare(batch))[0].numpy()
    assert got.shape == ref["decode"].shape == (2, H, W, 3)
    np.testing.assert_allclose(got, ref["decode"], atol=ATOL)


def test_semantic_codec_codes_match_jax(ref, port):
    _, codec, batch = port
    with torch.no_grad():
        got = codec.get_codes_shaped(codec.prepare(batch))
    assert len(got) == 2
    for name, g, w, p in zip(ENCODERS, got, ref["codes"], ref["presign"]):
        assert_codes_match(g.numpy(), w, p, name)


def test_semantic_codec_presign_matches_jax(ref, port):
    _, codec, batch = port
    with torch.no_grad():
        got = codec.get_presign(codec.prepare(batch))
    for g, w in zip(got, ref["presign"]):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def test_semantic_codec_decode_from_codes_matches_jax(ref, port):
    _, codec, _ = port
    with torch.no_grad():
        got = codec.decode_from_codes([torch.from_numpy(c) for c in ref["codes"]]).numpy()
    np.testing.assert_allclose(got, ref["from_codes"], atol=ATOL)


def test_fast_codec_decode_matches_jax(ref, port):
    cfg, codec, batch = port
    got = FastCodec(cfg, codec.state_dict(), device="cpu").decode(batch).numpy()
    np.testing.assert_allclose(got, ref["fast_decode"], atol=ATOL)
    np.testing.assert_allclose(got, ref["decode"], atol=ATOL)


def test_fast_codec_codes_match_jax(ref, port):
    cfg, codec, batch = port
    got = FastCodec(cfg, codec.state_dict(), device="cpu").get_codes_shaped(batch)
    for name, g, w, p in zip(ENCODERS, got, ref["fast_codes"], ref["presign"]):
        assert_codes_match(g.numpy(), w, p, name)


def test_fast_codec_decode_from_codes_matches_jax(ref, port):
    cfg, codec, _ = port
    fast = FastCodec(cfg, codec.state_dict(), device="cpu")
    got = fast.decode_from_codes([torch.from_numpy(c).float() for c in ref["codes_u8"]])
    np.testing.assert_allclose(got.numpy(), ref["fast_from_codes_u8"], atol=ATOL)


def test_codec_server_round_trip_matches_jax(ref, port):
    """The slice end to end: compress to uint8 codes, decompress from them
    alone, against the JAX FastCodec's get_codes_shaped and
    decode_from_codes."""
    cfg, codec, _ = port
    server = CodecServer(cfg, codec.state_dict(), device="cpu")
    codes = server.compress_codes(ref["batch"])
    assert [c.dtype for c in codes] == [torch.uint8, torch.uint8]
    assert [tuple(c.shape) for c in codes] == [(2, H // 4, W // 4, 16)] * 2
    for name, g, w, p in zip(ENCODERS, codes, ref["codes_u8"], ref["presign"]):
        assert set(np.unique(g.numpy())) <= {0, 1}
        assert_codes_match(g.numpy(), w, p, name)
    image = server.decompress_codes(codes)
    assert image.dtype == torch.float32 and image.shape == (2, H, W, 3)
    np.testing.assert_allclose(image.numpy(), ref["fast_from_codes_u8"], atol=ATOL)


def test_codec_server_bf16_error_is_jax_bf16_error(ref):
    """The flagship's own compute dtype: decoding the same codes in bf16
    departs from the fp32 result by about what the JAX package's bf16 fast
    path does (measured ratio ~1: the two round at different points, e.g.
    the bias is fused into the conv here), so within 1.5x of it."""
    jcfg = _flagship_cfg(tiny=True)
    assert jcfg.model.compute_dtype == "bfloat16"
    codes = [jnp.asarray(c, jnp.float32) for c in ref["codes_u8"]]
    jax_bf16 = np.asarray(JaxFastCodec(jcfg, ref["params"]).decode_from_codes(codes), np.float32)
    cfg = flagship_config(tiny=True)
    server = CodecServer(cfg, from_jax_params(ref["params"]), device="cpu")
    image = server.decompress_codes([torch.from_numpy(c) for c in ref["codes_u8"]])
    assert image.shape == (2, H, W, 3)
    assert torch.isfinite(image).all() and image.abs().max() <= 1.0
    want = np.abs(jax_bf16 - ref["fast_from_codes_u8"])
    got = np.abs(image.numpy() - ref["fast_from_codes_u8"])
    print(f"bf16 vs fp32: port max {got.max():.4f} mean {got.mean():.5f}, "
          f"JAX max {want.max():.4f} mean {want.mean():.5f}")
    assert got.mean() <= 1.5 * want.mean() and got.max() <= 1.5 * want.max(), (
        got.mean(), want.mean(), got.max(), want.max())
