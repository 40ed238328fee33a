"""CodecServer serves .jpds bytes: the port's compress -> stream ->
decompress against the JAX package's codes packed by
``jpdse_tpu.codec_io.pack`` (what ``Trainer.compress`` writes for a
code-only configuration) and its ``decode_from_codes``, at the tiny
flagship config, 64x128, fp32 on the CPU, on the fast and the standard
path, in the default and in the kernel configuration.

The streams are byte-identical wherever the two packages' codes are equal;
a code bit may differ only where the JAX pre-sign value lies within 1e-5 of
0 (tests/test_torch_port_codec.py), and then the port's stream must be the
JAX package's pack of the port's codes. Images decoded from JAX's stream are
within 2e-4 of JAX's, the tolerance of the tiny config's parity."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu import codec_io as jax_io
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.models.fast_codec import FastCodec as JaxFastCodec
from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.config import flagship_config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.serve import CodecServer
from test_torch_port_codec import ENCODERS, _jax_params, _jax_presign, assert_codes_match

H, W = 64, 128
ATOL = 2e-4
PATHS = [("default", "fast"), ("default", "standard"), ("kernel", "fast"),
         ("kernel", "standard")]


def _jax_cfg(config: str):
    jcfg = _flagship_cfg(tiny=True)
    m = jcfg.model
    m.compute_dtype = "float32"
    if config == "kernel":
        m.fused_instance_norm = True
        m.fast.head_pallas = "1"
        m.fast.front_realign = "pallas"
    return jcfg


def _port_cfg(config: str, path: str):
    cfg = flagship_config(tiny=True, kernels=config == "kernel")
    cfg.model.compute_dtype = "float32"
    cfg.model.fast_inference = path == "fast"
    return cfg


@pytest.fixture(scope="module")
def ref():
    """Per (config, path): JAX's codes for a batch of 2, its .jpds stream of
    each image, and its decode of each stream's codes."""
    with pytest.MonkeyPatch.context() as mp:
        for k in [k for k in os.environ if k.startswith("JPDSE_")]:
            mp.delenv(k)  # JAX's JPDSE_* overrides beat its config
        out = {}
        for config in ("default", "kernel"):
            jcfg = _jax_cfg(config)
            jcodec = JaxCodec(jcfg)
            batch = {k: np.array(v) for k, v in
                     _batch(jcfg, 2, H, W, np.random.default_rng(11)).items()}
            inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"])
            params = _jax_params(jcodec, inputs, seed=5)
            presign = _jax_presign(jcodec, params, inputs)
            fast = JaxFastCodec(jcfg, params, dtype=jnp.float32)
            for path in ("fast", "standard"):
                if path == "fast":
                    codes = [np.array(c) for c in fast.get_codes_shaped(batch)]
                else:
                    codes = [np.array(c) for c in jax.jit(lambda p, i: jcodec.apply(
                        {"params": p}, i, method=JaxCodec.get_codes_shaped))(params, inputs)]
                codes = [c.astype(np.uint8) for c in codes]
                streams = [jax_io.pack([c[j] for c in codes], (H, W)) for j in range(2)]
                images = []
                for s in streams:
                    got = [jnp.asarray(c) for c in jax_io.unpack(s)[0]]
                    if path == "fast":
                        images.append(np.asarray(fast.decode_from_codes(got))[0])
                    else:
                        images.append(np.asarray(jcodec.apply(
                            {"params": params}, got, method=JaxCodec.decode_from_codes))[0])
                out[config, path] = {"state": from_jax_params(params), "batch": batch,
                                     "presign": presign, "codes": codes, "streams": streams,
                                     "images": images}
    return out


@pytest.fixture(scope="module")
def servers(ref):
    return {(config, path): CodecServer(_port_cfg(config, path), ref[config, path]["state"],
                                        device="cpu")
            for config, path in PATHS}


@pytest.mark.parametrize("config,path", PATHS)
def test_compress_gives_jax_stream(ref, servers, config, path):
    r = ref[config, path]
    server = servers[config, path]
    assert (server.fast is not None) == (path == "fast")
    streams = server.compress(r["batch"])
    assert len(streams) == 2 and all(isinstance(s, bytes) for s in streams)
    assert set(server.times) == {"compress_codes", "pack"}
    for j, stream in enumerate(streams):
        got, hw = codec_io.unpack(stream)
        assert hw == (H, W)
        for name, g, w, p in zip(ENCODERS, got, r["codes"], r["presign"]):
            assert_codes_match(g[0], w[j], p[j], f"{config} {path} image {j} {name}")
        if all(np.array_equal(g[0], w[j]) for g, w in zip(got, r["codes"])):
            assert stream == r["streams"][j]
        else:
            assert stream == jax_io.pack([g[0] for g in got], (H, W))


@pytest.mark.parametrize("config,path", PATHS)
def test_decompress_of_jax_stream_matches_jax(ref, servers, config, path):
    r = ref[config, path]
    server = servers[config, path]
    for stream, want in zip(r["streams"], r["images"]):
        image = server.decompress(stream)
        assert set(server.times) == {"unpack", "decompress_codes"}
        assert isinstance(image, np.ndarray) and image.dtype == np.float32
        assert image.shape == (H, W, 3)
        np.testing.assert_allclose(image, want, atol=ATOL)


@pytest.mark.parametrize("config,path", PATHS)
def test_round_trip_through_bytes_equals_the_tensor_path(ref, servers, config, path):
    """compress -> bytes -> decompress gives what compress_codes ->
    decompress_codes gives, image by image, for a batch of one too."""
    r = ref[config, path]
    server = servers[config, path]
    one = {k: v[1:] for k, v in r["batch"].items()}
    (stream,) = server.compress(one)
    codes = server.compress_codes(one)
    got, _ = codec_io.unpack(stream)
    for g, c in zip(got, codes):
        np.testing.assert_array_equal(g[0], c[0].numpy())
    np.testing.assert_array_equal(server.decompress(stream),
                                  server.decompress_codes(codes)[0].numpy())
