"""The PyTorch port in the JAX package's kernel configuration, against the
JAX package at the tiny flagship config, 64x128, fp32 on the CPU.

The kernel configuration is the flagship with ``fused_instance_norm=True``
(kernel K3 at every norm site of the standard path), ``fast.head_pallas``
(K4 on the wide heads, fed by K1 with extra rows) and
``fast.front_realign='pallas'`` (K2 on the other fronts). On the CPU the
port's wrappers take their plain versions, and the JAX package takes its own
off-TPU forms of the same switches. Both stacks get the same weights (drawn
with numpy in the Flax layout, carried across by ``convert.from_jax_params``)
and the same batch; images agree within atol=2e-4 and codes are equal except
where the JAX pre-sign value lies within 1e-5 of 0, as in
tests/test_torch_port_codec.py. JAX's ``JPDSE_*`` env overrides beat its
config, so every test runs with them cleared.
"""

import copy
import os

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
from jpdse_tpu_torch.config import FastPathConfig, flagship_config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.models import fast_trunk, layers
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.serve import CodecServer
from test_torch_port_codec import ENCODERS, _jax_params, _jax_presign, assert_codes_match
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W = 64, 128
ATOL = 2e-4
HEADS = ("1", "force")


def _clear_env(mp):
    for k in [k for k in os.environ if k.startswith("JPDSE_")]:
        mp.delenv(k)


@pytest.fixture(autouse=True)
def _no_jpdse_env(monkeypatch):
    _clear_env(monkeypatch)


def _jax_cfg(head_pallas="1"):
    jcfg = _flagship_cfg(tiny=True)
    m = jcfg.model
    m.compute_dtype = "float32"
    m.fused_instance_norm = True
    m.fast.head_pallas = head_pallas
    m.fast.front_realign = "pallas"
    return jcfg


def _port_cfg(head_pallas="1", fast_inference=True):
    cfg = flagship_config(tiny=True, kernels=True)
    cfg.model.compute_dtype = "float32"
    cfg.model.fast.head_pallas = head_pallas
    cfg.model.fast_inference = fast_inference
    return cfg


@pytest.fixture(scope="module")
def ref():
    """JAX weights, batch and reference outputs of both kernel-configuration
    paths, computed once."""
    with pytest.MonkeyPatch.context() as mp:
        _clear_env(mp)
        jcfg = _jax_cfg()
        jcodec = JaxCodec(jcfg)
        batch = {k: np.array(v)
                 for k, v in _batch(jcfg, 2, H, W, np.random.default_rng(7)).items()}
        inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"])
        params = _jax_params(jcodec, inputs, seed=2)

        def apply(method):
            return jax.jit(lambda p, i: jcodec.apply({"params": p}, i, method=method))(
                params, inputs)

        codes = [np.array(c) for c in apply(JaxCodec.get_codes_shaped)]
        out = {
            "params": params,
            "batch": batch,
            "presign": _jax_presign(jcodec, params, inputs),
            "decode": np.asarray(apply(JaxCodec.decode)[0]),
            "codes": codes,
            "from_codes": np.asarray(jcodec.apply(
                {"params": params}, [jnp.asarray(c) for c in codes],
                method=JaxCodec.decode_from_codes)),
        }
        for head in HEADS:
            fast = JaxFastCodec(_jax_cfg(head), params, dtype=jnp.float32)
            fast_codes = [np.array(c) for c in fast.get_codes_shaped(batch)]
            codes_u8 = [c.astype(np.uint8) for c in fast_codes]
            out[head] = {
                "decode": np.asarray(fast.decode(batch)),
                "codes": fast_codes,
                "codes_u8": codes_u8,
                "from_codes_u8": np.asarray(fast.decode_from_codes(
                    [jnp.asarray(c, jnp.float32) for c in codes_u8])),
            }
    return out


@pytest.fixture(scope="module")
def port(ref):
    state = from_jax_params(ref["params"])
    codec = SemanticCodec(_port_cfg(fast_inference=False), device="cpu", seed=None)
    codec.load_state_dict(state)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    return state, codec, batch


# -- the standard path with K3 ---------------------------------------------------

def test_fused_semantic_codec_decode_matches_jax(ref, port):
    _, codec, batch = port
    with torch.no_grad():
        got = codec.decode(codec.prepare(batch))[0].numpy()
    assert got.shape == ref["decode"].shape == (2, H, W, 3)
    np.testing.assert_allclose(got, ref["decode"], atol=ATOL)


def test_fused_semantic_codec_codes_match_jax(ref, port):
    _, codec, batch = port
    with torch.no_grad():
        got = codec.get_codes_shaped(codec.prepare(batch))
    for name, g, w, p in zip(ENCODERS, got, ref["codes"], ref["presign"]):
        assert_codes_match(g.numpy(), w, p, name)


def test_fused_semantic_codec_decode_from_codes_matches_jax(ref, port):
    _, codec, _ = port
    with torch.no_grad():
        got = codec.decode_from_codes([torch.from_numpy(c) for c in ref["codes"]]).numpy()
    np.testing.assert_allclose(got, ref["from_codes"], atol=ATOL)


def test_fused_semantic_codec_is_forward_only(port):
    """Forward only until the training slice; now the decode with K3 at every
    norm site is differentiable, and its parameter gradients equal the
    default configuration's (the plain InstanceNorm under autograd) on the
    same weights."""
    state, codec, batch = port
    default = SemanticCodec(flagship_config(tiny=True), device="cpu", seed=None,
                            dtype=torch.float32)
    default.load_state_dict(state)
    grads = []
    for c in (codec, default):
        fake, _ = c.decode(c.prepare(batch))
        w = torch.from_numpy(np.random.default_rng(3).normal(size=fake.shape).astype(np.float32))
        grads.append(torch.autograd.grad((fake * w).sum(), list(c.parameters())))
    for (name, _), g, want in zip(codec.named_parameters(), *grads):
        scale = want.abs().max().item()
        if name.endswith("bias") and "tail" not in name:
            continue  # a bias an InstanceNorm follows: its gradient is 0 to rounding
        assert (g - want).abs().max().item() <= 1e-4 * scale, name


# -- the fast path with K1, K2 and K4 -----------------------------------------------

@pytest.mark.parametrize("head", HEADS)
def test_kernel_fast_codec_picks_the_jax_heads(ref, port, head):
    """'1' puts K4 on netE4label alone at the tiny size (s2d input 144
    channels; netG's 44 and netE's 12 take K2); 'force' puts it on all."""
    state, _, _ = port
    fast = FastCodec(_port_cfg(head), state, device="cpu")
    want = {"1": ("none", "none", "pallas"), "force": ("pallas",) * 3}[head]
    assert tuple(t.head_fold for t in (fast.netG, fast.netE, fast.netE4label)) == want
    jfast = JaxFastCodec(_jax_cfg(head), ref["params"], dtype=jnp.float32)
    assert tuple(t.head_fold for t in (jfast.netG, jfast.netE, jfast.netE4label)) == want


@pytest.mark.parametrize("head", HEADS)
def test_kernel_fast_codec_decode_matches_jax(ref, port, head):
    state, _, batch = port
    got = FastCodec(_port_cfg(head), state, device="cpu").decode(batch).numpy()
    np.testing.assert_allclose(got, ref[head]["decode"], atol=ATOL)
    np.testing.assert_allclose(got, ref["decode"], atol=ATOL)


@pytest.mark.parametrize("head", HEADS)
def test_kernel_fast_codec_codes_match_jax(ref, port, head):
    state, _, batch = port
    got = FastCodec(_port_cfg(head), state, device="cpu").get_codes_shaped(batch)
    for name, g, w, p in zip(ENCODERS, got, ref[head]["codes"], ref["presign"]):
        assert_codes_match(g.numpy(), w, p, name)


@pytest.mark.parametrize("head", HEADS)
def test_kernel_codec_server_round_trip_matches_jax(ref, port, head):
    state, _, _ = port
    server = CodecServer(_port_cfg(head), state, device="cpu")
    assert server.fast is not None
    codes = server.compress_codes(ref["batch"])
    for name, g, w, p in zip(ENCODERS, codes, ref[head]["codes_u8"], ref["presign"]):
        assert_codes_match(g.numpy(), w, p, name)
    image = server.decompress_codes([torch.from_numpy(c) for c in ref[head]["codes_u8"]])
    np.testing.assert_allclose(image.numpy(), ref[head]["from_codes_u8"], atol=ATOL)


# -- CodecServer's choice of path -----------------------------------------------------

def test_codec_server_serves_standard_path_without_fast_inference(ref, port):
    state, _, _ = port
    server = CodecServer(_port_cfg(fast_inference=False), state, device="cpu")
    assert server.fast is None and isinstance(server.codec, SemanticCodec)
    codes = server.compress_codes(ref["batch"])
    assert [c.dtype for c in codes] == [torch.uint8] * 2
    for name, g, w, p in zip(ENCODERS, codes, ref["codes"], ref["presign"]):
        assert_codes_match(g.numpy(), w.astype(np.uint8), p, name)
    image = server.decompress_codes(codes)
    assert image.dtype == torch.float32
    np.testing.assert_allclose(image.numpy(), ref["from_codes"], atol=ATOL)


# -- which kernels each path calls ----------------------------------------------------

def _count(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(module, name, counted)
    return calls


def test_kernel_calls_per_request(ref, port, monkeypatch):
    """The counts chip_smoke.py asserts on the card, at the flagship's
    channel widths: fast compress K1 1, K2 1, K4 1 and decompress K1 4,
    K4 1; standard compress K3 10 and decompress K3 35 (one per norm site:
    5 in each encoder's head and downs, 4 in each encoder's ups, 27 in
    netG); the default fast path K1 3 per decompress and nothing else."""
    cfg = _port_cfg()
    m = cfg.model
    m.label_encoder_out_channels = 36  # netG's s2d head input: 4 * (36 + 3) >= 64
    m.ngf, m.n_downsample_global, m.n_blocks_global = 8, 4, 9
    m.n_downsample_E = m.n_downsample_E4label = 4
    state = SemanticCodec(cfg, device="cpu", seed=0).state_dict()
    batch = {k: v[:1] for k, v in ref["batch"].items()}
    fast = _count(monkeypatch, fast_trunk, ("s2d_realign_pad3", "s2d_pad3", "head_conv_s2d"))
    norm = _count(monkeypatch, layers, ("fused_instance_norm",))

    def run(server):
        for d in (fast, norm):
            d.update(dict.fromkeys(d, 0))
        codes = server.compress_codes(batch)
        after = {**fast, **norm}
        server.decompress_codes(codes)
        return after, {k: v - after[k] for k, v in {**fast, **norm}.items()}

    comp, dec = run(CodecServer(cfg, state, device="cpu"))
    assert comp == {"s2d_realign_pad3": 1, "s2d_pad3": 1, "head_conv_s2d": 1,
                    "fused_instance_norm": 0}
    assert dec == {"s2d_realign_pad3": 4, "s2d_pad3": 0, "head_conv_s2d": 1,
                   "fused_instance_norm": 0}
    cfg.model.fast_inference = False
    comp, dec = run(CodecServer(cfg, state, device="cpu"))
    assert comp == {"s2d_realign_pad3": 0, "s2d_pad3": 0, "head_conv_s2d": 0,
                    "fused_instance_norm": 10}
    assert dec["fused_instance_norm"] == 35 and sum(dec.values()) == 35
    default = flagship_config(tiny=True)
    for k in ("label_encoder_out_channels", "ngf", "n_downsample_global", "n_blocks_global",
              "n_downsample_E", "n_downsample_E4label", "compute_dtype"):
        setattr(default.model, k, getattr(m, k))
    comp, dec = run(CodecServer(default, state, device="cpu"))
    assert sum(comp.values()) == 0
    assert dec == {"s2d_realign_pad3": 3, "s2d_pad3": 0, "head_conv_s2d": 0,
                   "fused_instance_norm": 0}


def test_kernel_calls_per_phase1_request(ref, monkeypatch):
    """The flagship's phase 1 (no netE; netG reads netE4label's 36 channels,
    144 after s2d) at its depth and channel widths, narrow elsewhere: the
    kernel configuration's fast compress K1 1 and K4 1 (netE4label's head),
    decompress K1 3 and K4 1 (netE4label's back, netG's head and back);
    its standard path K3 5 (netE4label's head and downs) and 31 (netE4label's
    4 ups, netG's 27); the default fast path K1 2 per decompress. The one
    code is netE4label's."""
    cfg = _port_cfg()
    m = cfg.model
    m.no_feat, m.label_encoder_out_channels = True, 36
    m.ngf, m.n_downsample_global, m.n_blocks_global, m.n_downsample_E4label = 8, 4, 9, 4
    state = SemanticCodec(cfg, device="cpu", seed=0).state_dict()
    assert not any(k.startswith("netE.") for k in state)
    batch = {k: v[:1] for k, v in ref["batch"].items()}
    fast = _count(monkeypatch, fast_trunk, ("s2d_realign_pad3", "s2d_pad3", "head_conv_s2d"))
    norm = _count(monkeypatch, layers, ("fused_instance_norm",))

    def run(server):
        for d in (fast, norm):
            d.update(dict.fromkeys(d, 0))
        codes = server.compress_codes(batch)
        assert [tuple(c.shape) for c in codes] == [(1, H // 16, W // 16, 16)]
        after = {**fast, **norm}
        server.decompress_codes(codes)
        return ({k: v for k, v in after.items() if v},
                {k: v - after[k] for k, v in {**fast, **norm}.items() if v - after[k]})

    assert run(CodecServer(cfg, state, device="cpu")) == (
        {"s2d_realign_pad3": 1, "head_conv_s2d": 1}, {"s2d_realign_pad3": 3, "head_conv_s2d": 1})
    cfg.model.fast_inference = False
    assert run(CodecServer(cfg, state, device="cpu")) == (
        {"fused_instance_norm": 5}, {"fused_instance_norm": 31})
    default = flagship_config(tiny=True)
    for k in ("no_feat", "label_encoder_out_channels", "ngf", "n_downsample_global",
              "n_blocks_global", "n_downsample_E4label", "compute_dtype"):
        setattr(default.model, k, getattr(m, k))
    assert run(CodecServer(default, state, device="cpu")) == ({}, {"s2d_realign_pad3": 2})


def test_fast_path_config_env_overrides_and_values(monkeypatch):
    fp = FastPathConfig()
    assert (fp.head_pallas, fp.front_realign) == ("0", "0")
    monkeypatch.setenv("JPDSE_HEAD_PALLAS", "force")
    monkeypatch.setenv("JPDSE_FRONT_REALIGN", "auto")
    r = fp.resolved()
    assert (r.head_pallas, r.front_realign) == ("force", "auto")
    assert fp.head_pallas == "0"  # resolved() copies
    monkeypatch.setenv("JPDSE_HEAD_PALLAS", "2")
    with pytest.raises(ValueError, match="head_pallas"):
        FastCodec(_port_cfg(), {}, device="cpu")
    cfg = flagship_config(tiny=True)
    assert cfg.model.fast_inference and not cfg.model.fused_instance_norm
    cfg.model.fast.front_realign = "xla"
    with pytest.raises(ValueError, match="front_realign"):
        cfg.validate()


@pytest.mark.parametrize("recipe", ["raw", "nosem"])
def test_kernel_calls_per_base_codec_request(ref, monkeypatch, recipe):
    """The base-codec recipes through .jpds bytes, side info only, at netG's
    depth and head widths: no kernel runs in a compress on any path. A
    decompress in the kernel configuration's fast path runs K4 on netG's
    s2d head, fed by K1, where it reads raw semantics over the decoded
    image (39 channels, 156 after s2d), and K2 on its front where it reads
    the decoded image alone (3 channels), then K1 in netG's back; its
    standard path K3 at netG's 27 norm sites; the default fast path K1 in
    netG's back alone."""
    from jpdse_tpu_torch.codecs.bridge import compress_for_model
    from jpdse_tpu_torch.utils.misc import tensor2im

    cfg = _port_cfg()
    m = cfg.model
    m.no_feat_encoding = m.no_label_encoding = True
    if recipe == "nosem":
        m.no_label = m.no_instance = True
    m.ngf, m.n_downsample_global, m.n_blocks_global = 8, 4, 9
    cfg.codec.use_compressed, cfg.codec.ext, cfg.codec.quality = True, "jpg", (50,)
    cfg.validate()
    assert cfg.netG_input_nc == (39 if recipe == "raw" else 3)
    state = SemanticCodec(cfg, device="cpu", seed=0).state_dict()
    batch = {k: v[:1] for k, v in ref["batch"].items()}
    d = cfg.data
    trip = compress_for_model(tensor2im(batch["image"][0], d.normalize_mean, d.normalize_std),
                              "jpg", [50], d.normalize_mean, d.normalize_std, True)
    batch.update(compressed=trip[0][None], base_codec_streams=[trip[2]],
                 base_codec_ext=[trip[3]])
    fast = _count(monkeypatch, fast_trunk, ("s2d_realign_pad3", "s2d_pad3", "head_conv_s2d"))
    norm = _count(monkeypatch, layers, ("fused_instance_norm",))

    def run(server):
        for c in (fast, norm):
            c.update(dict.fromkeys(c, 0))
        stream = server.compress(batch)[0]
        after = {**fast, **norm}
        assert not any(after.values())
        assert codec_io.unpack_full(stream).codes == []
        server.decompress(stream)
        return {k: v for k, v in {**fast, **norm}.items() if v}

    front = ({"s2d_realign_pad3": 2, "head_conv_s2d": 1} if recipe == "raw"
             else {"s2d_realign_pad3": 1, "s2d_pad3": 1})
    assert run(CodecServer(cfg, state, device="cpu")) == front
    cfg.model.fast_inference = False
    assert run(CodecServer(cfg, state, device="cpu")) == {"fused_instance_norm": 27}
    default = copy.deepcopy(cfg)
    default.model.fused_instance_norm = False
    default.model.fast = FastPathConfig()
    default.model.fast_inference = True
    assert run(CodecServer(default, state, device="cpu")) == {"s2d_realign_pad3": 1}
