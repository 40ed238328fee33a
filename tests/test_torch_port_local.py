"""The PyTorch port's LocalEnhancer (``model.netG`` 'local') against the
JAX package at the tiny flagship config (64x128, ngf 4 so the global trunk
runs at 8 x 2^n_local channels, 2 downsamples, 2 global and 1 local res
blocks), fp32 on the CPU, for one and two enhancers.

Both stacks get the same weights (drawn with numpy in the Flax layout and
carried across by ``convert.from_jax_params``) and the same numpy batch,
over two assemblies: the hires recipe's (raw one-hot semantics and the
edge map beside a base codec's decoded image, no encoder, so no code:
``artifacts/flagship_r3_hires``) and the learned one (netE4label's and
netE's codes into the enhancer). Images agree within atol=2e-4, the
tolerance of ``test_torch_port_codec.py``; codes are equal. The s2d fast
path (``FastCodec``, ``_FastLocalG``) is held against JAX's ``FastCodec``
in the default configuration and the kernel configuration (K1, K4 and K3
take their plain versions on the CPU); two enhancers exercise the inner
enhancer's tail-less upsample stack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.models.fast_codec import FastCodec as JaxFastCodec
from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.codecs.bridge import compress_for_model
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.models.generator import LocalEnhancer
from jpdse_tpu_torch.serve import CodecServer
from jpdse_tpu_torch.utils.misc import tensor2im
from test_torch_port_codec import _jax_params
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W = 64, 128
ATOL = 2e-4
ASSEMBLIES = ("raw", "learned")


def local_cfg(assembly: str, n_local: int, kernels: bool = False):
    """The tiny flagship with a LocalEnhancer netG of ``n_local``
    enhancers, over the hires recipe's raw assembly or the learned one."""
    cfg = _flagship_cfg(tiny=True)
    m = cfg.model
    m.compute_dtype = "float32"
    m.netG, m.ngf, m.n_local_enhancers, m.n_blocks_local = "local", 4, n_local, 1
    if assembly == "raw":
        m.no_feat_encoding = m.no_label_encoding = True
        cfg.codec.use_compressed = True
    if kernels:
        m.fused_instance_norm = True
        m.fast.head_pallas, m.fast.front_realign = "1", "pallas"
    cfg.validate()
    return cfg


_REF = {}


def ref(assembly: str, n_local: int) -> dict:
    """JAX weights, batch and outputs of one configuration, computed once."""
    key = (assembly, n_local)
    if key in _REF:
        return _REF[key]
    cfg = local_cfg(assembly, n_local)
    rng = np.random.default_rng(1)
    batch = {k: np.array(v) for k, v in _batch(cfg, 2, H, W, rng).items()}
    batch["compressed"] = np.clip(batch["image"] + rng.normal(0, 0.1, batch["image"].shape),
                                  -1, 1).astype(np.float32)
    inputs = jax_prepare_inputs(cfg, batch["label"], batch["instance"], batch["image"],
                                batch["compressed"])
    jcodec = JaxCodec(cfg)
    params = _jax_params(jcodec, inputs, seed=5)

    def apply(method, *args):
        return jcodec.apply({"params": params}, *args, method=method)

    out = {"cfg": cfg, "params": params, "batch": batch,
           "decode": np.asarray(apply(JaxCodec.decode, inputs)[0]),
           "fast_decode": np.asarray(JaxFastCodec(cfg, params, dtype=jnp.float32).decode(batch))}
    if assembly == "learned":
        codes = apply(JaxCodec.get_codes_shaped, inputs)
        out["codes"] = [np.array(c) for c in codes]
        out["from_codes"] = np.asarray(apply(JaxCodec.decode_from_codes, codes))
    _REF[key] = out
    return out


def port_codec(r, kernels=False):
    cfg = Config.from_dict(local_cfg(*_key(r), kernels=kernels).to_dict())
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(r["params"]))
    return cfg, codec


def _key(r):
    m = r["cfg"].model
    return ("raw" if m.no_feat_encoding else "learned"), m.n_local_enhancers


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("n_local", [1, 2])
@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_local_enhancer_decode_matches_jax(assembly, n_local):
    r = ref(assembly, n_local)
    for kernels in (False, True):
        _, codec = port_codec(r, kernels)
        assert isinstance(codec.netG, LocalEnhancer) and codec.netG.binarizer is None
        with torch.no_grad():
            got = codec.decode(codec.prepare(_tensors(r["batch"])))[0].numpy()
        np.testing.assert_allclose(got, r["decode"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_local", [1, 2])
def test_local_enhancer_codes_and_decode_from_codes_match_jax(n_local):
    r = ref("learned", n_local)
    _, codec = port_codec(r)
    with torch.no_grad():
        codes = codec.get_codes_shaped(codec.prepare(_tensors(r["batch"])))
        assert len(codes) == 2
        for got, want in zip(codes, r["codes"]):
            np.testing.assert_array_equal(got.numpy(), want)
        img = codec.decode_from_codes([torch.from_numpy(c) for c in r["codes"]]).numpy()
    np.testing.assert_allclose(img, r["from_codes"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_local", [1, 2])
@pytest.mark.parametrize("assembly", ASSEMBLIES)
def test_local_fast_codec_matches_jax_fast_codec(assembly, n_local):
    """The default configuration and the kernel configuration (K4 on both
    wide heads fed by K1, K1 in the last enhancer's back), against JAX's
    FastCodec on the same weights."""
    r = ref(assembly, n_local)
    for kernels in (False, True):
        cfg, codec = port_codec(r, kernels)
        fast = FastCodec(cfg, codec.state_dict(), device="cpu", dtype=torch.float32)
        assert fast.netG.binarize == "none" and len(fast.netG.ups) == n_local
        assert not fast.netG.glob.has_back and fast.netG.glob.n_mid_up == 2
        for n, (down, up) in enumerate(zip(fast.netG.downs, fast.netG.ups), 1):
            assert down.has_front and not down.has_back and down.n_mid_up == 0
            assert not up.has_front and up.has_back == (n == n_local)
            assert up.n_mid_up == (0 if n == n_local else 1)
            # K4 takes a head whose s2d input is >= 64 channels (the raw assembly's 156)
            assert (down.head_fold == "pallas") == (kernels and 4 * cfg.netG_input_nc >= 64)
        got = fast.decode(_tensors(r["batch"])).numpy()
        np.testing.assert_allclose(got, r["fast_decode"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, r["decode"], rtol=0, atol=ATOL)


def test_local_bridge_round_trip_keeps_flax_nesting():
    """from_jax_params / to_jax_params bit-equal on the enhancer trees:
    netG.global without a tail, local{n}_down / local{n}_up as attributes."""
    for n_local in (1, 2):
        r = ref("raw", n_local)
        state = from_jax_params(r["params"])
        assert not any(k.startswith("netG.global.tail") for k in state)
        assert "netG.global.head.conv.conv.weight" in state
        assert f"netG.local{n_local}_up.tail.conv.weight" in state
        assert "netG.local1_up.res.0.conv1.conv.weight" in state
        assert "netG.local1_down.d1.conv.conv.weight" in state
        if n_local == 2:
            assert not any(k.startswith("netG.local1_up.tail") for k in state)
        _, codec = port_codec(r)
        assert set(codec.state_dict()) == set(state)
        back = to_jax_params(state)
        flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                          for k, v in jax.tree_util.tree_leaves_with_path(t)}
        a, b = flat(r["params"]), flat(back)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("fast", [False, True], ids=["standard", "fast"])
def test_local_side_info_stream_round_trip(fast):
    """A side-info-only .jpds stream (the hires recipe: no code, the id maps
    and a jpg base stream) through CodecServer on each path: no code in the
    stream, and the image decompressed from it alone equals the standard
    decode of the request's own inputs."""
    r = ref("raw", 1)
    cfg, codec = port_codec(r)
    cfg.codec.ext, cfg.codec.quality = "jpg", (50,)
    cfg.model.fast_inference = fast
    d = cfg.data
    batch = {k: r["batch"][k][:1] for k in ("label", "instance", "image")}
    trip = compress_for_model(tensor2im(batch["image"][0], d.normalize_mean, d.normalize_std),
                              "jpg", (50,), d.normalize_mean, d.normalize_std, True)
    batch.update(compressed=trip[0][None], base_codec_streams=[trip[2]],
                 base_codec_ext=[trip[3]])
    server = CodecServer(cfg, codec.state_dict(), device="cpu")
    stream = server.compress(batch)[0]
    assert not codec_io.unpack_full(stream).codes
    got = server.decompress(stream)
    with torch.no_grad():
        want = codec.decode(codec.prepare(_tensors(
            {k: batch[k] for k in ("label", "instance", "image", "compressed")})))[0][0]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL)
