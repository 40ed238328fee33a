"""Every assembly of the generator's input, and generator binarization, in
the PyTorch port against the JAX package at the tiny flagship config,
64x128, fp32 on the CPU.

An assembly is the flagship with some of its ``model`` fields changed
(:data:`ASSEMBLIES`): no visual features (``no_feat``, the flagship's phase
1), the raw image into netG (``no_feat_encoding``), no semantics
(``no_label`` with ``no_instance``, as the tracked no-semantics recipes set
it), raw semantics (``no_label_encoding``), semantic masking with and
without ``binary_mask``, netE's output as the image (``use_netE_output``),
the ablations ``zero_sem`` / ``zero_ins`` / ``zero_vis``, unbinarized
encoders, the generator's bottleneck binarized after or before its
residual blocks, and the base-codec recipes: raw semantics over a base
codec's decoded image (``artifacts/flagship_r3_compressed``; also with the
maps at ``codec.sem_downsample`` 2) and that image alone
(``flagship_r4_nosem_*``), whose streams are side info only. Both stacks get the same weights (drawn with numpy in the
Flax layout, carried across by ``convert.from_jax_params``) and the same
batch. Images agree within 2e-4, as tests/test_torch_port_codec.py holds
them; codes are equal except where the port's pre-sign value lies within
1e-5 of 0.

JAX's FastCodec assembles netG's input without the ablations (it reads no
``zero_*`` and no ``use_netE_output``), so for those the port's FastCodec,
which applies them, is held against JAX's SemanticCodec; its codes and its
decode from codes against JAX's FastCodec, as for every other assembly but
``sem_masking``, which both FastCodecs refuse.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu import codec_io as jax_io
from jpdse_tpu.codecs.bridge import compress_for_model as jax_compress_for_model
from jpdse_tpu.eval.harness import evaluate as jax_evaluate
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.models.fast_codec import FastCodec as JaxFastCodec
from jpdse_tpu.utils.misc import tensor2im as jax_tensor2im
from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.config import Config, NotPorted
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.eval.harness import evaluate
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.serve import CodecServer
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W = 64, 128
ATOL = 2e-4
NEAR_ZERO = 1e-5
G_BIN = {"no_generator_binarization": False, "no_encoder_binarization": True,
         "no_label_encoder_binarization": True}
# the flagship_r3_compressed recipe: raw semantics and the base codec's
# decoded image (jpg here; the recipe's heif where libheif loads)
BASE_RAW = {"no_feat_encoding": True, "no_label_encoding": True, "use_compressed": True}
BASE_EXT, BASE_Q = "jpg", 50
ASSEMBLIES = {
    "no_feat": {"no_feat": True},
    "no_feat_encoding": {"no_feat_encoding": True},
    "no_label": {"no_label": True, "no_instance": True},
    "no_label_encoding": {"no_label_encoding": True},
    "raw_semantics_no_feat": {"no_feat": True, "no_label_encoding": True},
    "raw": {"no_feat_encoding": True, "no_label_encoding": True},
    "sem_masking": {"sem_masking": True},
    "sem_masking_binary_mask": {"sem_masking": True, "binary_mask": True},
    "use_netE_output": {"use_netE_output": True},
    "zero_sem": {"zero_sem": True},
    "zero_ins": {"zero_ins": True},
    "zero_vis": {"zero_vis": True},
    "no_encoder_binarization": {"no_encoder_binarization": True},
    "no_label_encoder_binarization": {"no_label_encoder_binarization": True},
    "g_binarized_after_res": G_BIN,
    "g_binarized_before_res": dict(G_BIN, bin_generator_before_res=True),
    "base_codec_raw": BASE_RAW,
    "base_codec_raw_sem_downsample": dict(BASE_RAW, sem_downsample=2),
    "base_codec_nosem": dict(BASE_RAW, no_label=True, no_instance=True),
}
CODEC_FIELDS = ("use_compressed", "sem_downsample")  # of cfg.codec; the rest of cfg.model
ABLATIONS = ("use_netE_output", "zero_sem", "zero_ins", "zero_vis")
FAST = [n for n, a in ASSEMBLIES.items() if not a.get("sem_masking")]


@pytest.fixture(autouse=True)
def _no_jpdse_env(monkeypatch):
    for k in [k for k in os.environ if k.startswith("JPDSE_")]:
        monkeypatch.delenv(k)


def jax_config(name: str, kernels: bool = False):
    cfg = _flagship_cfg(tiny=True)
    m = cfg.model
    m.compute_dtype = "float32"
    for k, v in ASSEMBLIES[name].items():
        setattr(cfg.codec if k in CODEC_FIELDS else m, k, v)
    cfg.codec.ext, cfg.codec.quality = BASE_EXT, (BASE_Q,)
    if kernels:
        m.fused_instance_norm = True
        m.fast.head_pallas, m.fast.front_realign = "1", "pallas"
    cfg.validate()
    return cfg


def port_config(name: str, kernels: bool = False) -> Config:
    return Config.from_dict(jax_config(name, kernels).to_dict())


def _touch(mdl, inputs):
    """netG on the assembled input: with decode's modules, every module
    the configuration has (use_netE_output's decode skips netG)."""
    return mdl.netG(mdl._generator_input(inputs, False, True)[0])


_REF = {}


def ref(name: str) -> dict:
    """JAX weights, batch and outputs of one assembly, computed once."""
    if name in _REF:
        return _REF[name]
    cfg = jax_config(name)
    jcodec = JaxCodec(cfg)
    batch = {k: np.array(v) for k, v in _batch(cfg, 2, H, W, np.random.default_rng(21)).items()}
    base = None
    if cfg.codec.use_compressed:
        # the base codec's round trip of each image, as the data pipeline makes it
        d = cfg.data
        trips = [jax_compress_for_model(jax_tensor2im(im, d.normalize_mean, d.normalize_std),
                                        BASE_EXT, [BASE_Q], d.normalize_mean, d.normalize_std,
                                        return_streams=True) for im in batch["image"]]
        batch["compressed"] = np.stack([t[0] for t in trips])
        base = {"base_codec_bytes": np.array([t[1] for t in trips]),
                "base_codec_streams": [t[2] for t in trips],
                "base_codec_ext": [t[3] for t in trips]}
    inputs = jax_prepare_inputs(cfg, batch["label"], batch["instance"], batch["image"],
                                batch.get("compressed"))
    shapes = jax.eval_shape(
        lambda: jcodec.init({"params": jax.random.PRNGKey(0)}, inputs, method=_touch))["params"]
    rng = np.random.default_rng(22)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.02).astype(np.float32), shapes)

    def apply(method, *args):
        return jcodec.apply({"params": params}, *args, method=method)

    decode, label = apply(JaxCodec.decode, inputs)
    codes = [np.array(c) for c in apply(JaxCodec.get_codes_shaped, inputs)]
    jcodes = [jnp.asarray(c) for c in codes]
    try:
        from_codes, side = apply(JaxCodec.decode_from_codes, jcodes), False
    except ValueError:
        from_codes, side = apply(JaxCodec.decode_from_codes, jcodes, inputs), True
    out = {"cfg": cfg, "params": params, "batch": batch, "base": base,
           "decode": np.asarray(decode),
           "label": None if label is None else np.asarray(label), "codes": codes,
           "from_codes": np.asarray(from_codes), "side": side}
    _REF[name] = out
    return out


def jax_fast(name: str, kernels: bool) -> dict:
    key = (name, kernels)
    if key not in _REF:
        r = ref(name)
        fast = JaxFastCodec(jax_config(name, kernels), r["params"], dtype=jnp.float32)
        codes = [np.array(c) for c in fast.get_codes_shaped(r["batch"])]
        side = r["batch"] if r["side"] else None
        _REF[key] = {"decode": np.asarray(fast.decode(r["batch"])), "codes": codes,
                     "from_codes": np.asarray(fast.decode_from_codes(
                         [jnp.asarray(c) for c in codes], side))}
    return _REF[key]


def port_codec(name: str):
    r = ref(name)
    codec = SemanticCodec(port_config(name), device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(r["params"]))
    batch = {k: torch.from_numpy(v) for k, v in r["batch"].items()}
    return codec, batch


def assert_codes_match(got, want, presign, what):
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w, p) in enumerate(zip(got, want, presign)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        diff = g != w
        away = diff & (np.abs(np.asarray(p)) >= NEAR_ZERO)
        assert not away.any(), f"{what} code {i}: {int(away.sum())} bits differ away from 0"


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_decode_matches_jax(name):
    r = ref(name)
    codec, batch = port_codec(name)
    with torch.no_grad():
        image, label = codec.decode(codec.prepare(batch))
    assert image.shape == r["decode"].shape
    np.testing.assert_allclose(image.numpy(), r["decode"], atol=ATOL)
    assert (label is None) == (r["label"] is None)
    if label is not None:
        np.testing.assert_allclose(label.numpy(), r["label"], atol=ATOL)


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_codes_match_jax(name):
    r = ref(name)
    codec, batch = port_codec(name)
    with torch.no_grad():
        inputs = codec.prepare(batch)
        codes = codec.get_codes_shaped(inputs)
        presign = codec.get_presign(inputs)
    assert len(codes) == port_config(name).has_binary_codes * len(r["codes"])
    assert_codes_match([c.numpy() for c in codes], r["codes"], presign, name)


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_decode_from_codes_matches_jax(name):
    """From the codes alone where they carry everything, else with the
    prepared inputs as side inputs; without them the port raises as JAX
    does."""
    r = ref(name)
    codec, batch = port_codec(name)
    codes = [torch.from_numpy(c) for c in r["codes"]]
    with torch.no_grad():
        if r["side"]:
            with pytest.raises(ValueError, match="side_inputs"):
                codec.decode_from_codes(codes)
            got = codec.decode_from_codes(codes, codec.prepare(batch))
        else:
            got = codec.decode_from_codes(codes)
    np.testing.assert_allclose(got.numpy(), r["from_codes"], atol=ATOL)


@pytest.mark.parametrize("kernels", [False, True], ids=["default", "kernel_config"])
@pytest.mark.parametrize("name", FAST)
def test_fast_codec_matches_jax(name, kernels):
    r, jf = ref(name), jax_fast(name, kernels)
    codec, batch = port_codec(name)
    fast = FastCodec(port_config(name, kernels), codec.state_dict(), device="cpu")
    want = r["decode"] if name in ABLATIONS else jf["decode"]
    np.testing.assert_allclose(fast.decode(batch).numpy(), want, atol=ATOL)
    with torch.no_grad():
        presign = codec.get_presign(codec.prepare(batch))
    codes = fast.get_codes_shaped(batch)
    assert_codes_match([c.numpy() for c in codes], jf["codes"], presign, name)
    jcodes = [torch.from_numpy(c) for c in jf["codes"]]
    got = fast.decode_from_codes(jcodes, batch if r["side"] else None)
    np.testing.assert_allclose(got.numpy(), jf["from_codes"], atol=ATOL)


@pytest.mark.parametrize("name", ["sem_masking", "sem_masking_binary_mask"])
def test_fast_codec_refuses_sem_masking_as_jax_does(name):
    r = ref(name)
    with pytest.raises(ValueError, match="other configs use SemanticCodec"):
        JaxFastCodec(r["cfg"], r["params"])
    with pytest.raises(ValueError, match="sem_masking"):
        FastCodec(port_config(name), from_jax_params(r["params"]), device="cpu")


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_bridge_round_trip_is_bit_equal(name):
    """Trees without netE or netE4label, and with netG/binarizer, go to the
    port and back bit for bit, and the port's modules take every key."""
    params = ref(name)["params"]
    state = from_jax_params(params)
    SemanticCodec(port_config(name), device="cpu", seed=None).load_state_dict(state)
    back = to_jax_params(state)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, back)


def _jax_side(cfg):
    try:
        return jax_io.side_requirements(cfg)
    except ValueError as e:
        return str(e)


def _jax_streams(r) -> list:
    """What JAX's Trainer.compress writes for the batch: JAX's codes, and
    the side info side_requirements asks for, per image."""
    need_label, need_inst, need_base = jax_io.side_requirements(r["cfg"])
    f, out = r["cfg"].codec.sem_downsample, []
    for j in range(2):
        side = jax_io.SideInfo()
        if need_label:
            side.label = jax_io.downsample_ids(r["batch"]["label"][j].astype(np.int32), f)
        if need_inst:
            side.instance = jax_io.downsample_ids(r["batch"]["instance"][j].astype(np.int32), f)
        if need_base:
            side.base_ext = r["base"]["base_codec_ext"][j]
            side.base_payloads = list(r["base"]["base_codec_streams"][j])
        out.append(jax_io.pack([c[j].astype(np.uint8) for c in r["codes"]], (H, W),
                               None if side.empty() else side))
    return out


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_side_requirements_and_compress_raise_as_specified(name):
    """The port's side_requirements agrees with JAX's; CodecServer.compress
    raises JAX's ValueError where the generator reads raw pixels, and
    otherwise packs one stream per image, with the side info its
    configuration needs, byte-identical to what JAX's Trainer.compress
    writes; decompress rebuilds the side inputs from each stream and
    decodes within 2e-4 of JAX's decode from the codes and the batch."""
    r = ref(name)
    cfg = port_config(name)
    try:
        got = codec_io.side_requirements(cfg)
    except ValueError as e:
        got = str(e)
    assert got == _jax_side(r["cfg"])
    codec, _ = port_codec(name)
    server = CodecServer(cfg, codec.state_dict(), device="cpu")
    if isinstance(got, str):
        with pytest.raises(ValueError, match="raw uncompressed pixels"):
            server.compress(r["batch"])
        return
    if got[2]:
        with pytest.raises(ValueError, match="lacks base_codec_streams"):
            server.compress(r["batch"])
    streams = server.compress(dict(r["batch"], **(r["base"] or {})))
    assert streams == _jax_streams(r)
    assert [len(codec_io.unpack(s)[0]) for s in streams] == [len(r["codes"])] * 2
    for j, stream in enumerate(streams):
        np.testing.assert_allclose(server.decompress(stream), r["from_codes"][j], atol=ATOL)


@pytest.mark.parametrize("name", ["no_feat", "g_binarized_after_res", "g_binarized_before_res"])
def test_one_code_stream_is_byte_identical_to_jax(name):
    """A one-code stream (netE4label's in the flagship's phase 1, or the
    generator's bottleneck code) from CodecServer.compress equals JAX's
    codec_io.pack of JAX's codes, and each package decodes the other's
    stream: JAX's codes from the port's, the port's image from JAX's
    stream within 2e-4 of JAX's decode from its codes."""
    r = ref(name)
    codec, _ = port_codec(name)
    server = CodecServer(port_config(name), codec.state_dict(), device="cpu")
    streams = server.compress({k: v[:1] for k, v in r["batch"].items()})
    want = jax_io.pack([c[0].astype(np.uint8) for c in r["codes"]], (H, W))
    assert streams == [want]
    codes, hw = jax_io.unpack(streams[0])
    assert hw == (H, W) and len(codes) == 1
    np.testing.assert_array_equal(codes[0][0], r["codes"][0][0])
    image = server.decompress(want)
    np.testing.assert_allclose(image, r["from_codes"][0], atol=ATOL)


@pytest.mark.parametrize("name", ["raw_semantics_no_feat", "no_label_encoder_binarization",
                                  "no_feat_encoding", "raw", "no_feat", "base_codec_raw",
                                  "base_codec_nosem"])
def test_eval_harness_follows_the_side_requirements(name, tmp_path):
    """Raw uncompressed visuals evaluate without side accounting; a
    configuration whose streams carry side info reports the id maps' and
    the base codec's rates and the total JAX's harness reports (within
    1e-6 relative); a code-only one evaluates with its rate."""
    cfg = port_config(name)
    cfg.save_dir = str(tmp_path)
    codec, _ = port_codec(name)

    class Std:
        """The standard path's decode and rate, as the Trainer serves them."""

        def place(self, batch):
            return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
                    if k in ("label", "instance", "image", "compressed")}

        def get_img(self, batch):
            with torch.no_grad():
                return codec.decode(codec.prepare(self.place(batch)))[0]

        def get_eval_rate(self, batch):
            return 0.5, 1.0

        def get_code_and_contexts(self, batch):
            with torch.no_grad():
                codes = [c.numpy() for c in
                         codec.get_codes_shaped(codec.prepare(self.place(batch)))]
            shapes = [c.shape[1:] for c in codes]
            flat = np.concatenate([c.reshape(c.shape[0], -1) for c in codes], axis=-1)
            return flat, codec_io.contexts_for_shapes(shapes), shapes

    r = ref(name)
    batch = dict(r["batch"], path=["a.png", "b.png"], **(r["base"] or {}))
    metrics = evaluate(cfg, Std(), [batch])
    assert metrics["n_images"] == 2 and np.isfinite(metrics["PSNR"])
    if cfg.has_binary_codes:
        assert metrics["actual_bpp"] == 1.0 and metrics["coded_bpp"] > 0
    jcfg = copy.deepcopy(r["cfg"])
    jcfg.save_dir = str(tmp_path / "jax")
    want = jax_evaluate(jcfg, Std(), [batch])
    rates = {"actual_bpp", "coded_bpp", "sem_side_bpp", "base_codec_bpp", "total_bpp"}
    assert rates & set(metrics) == rates & set(want)
    for k in rates & set(want):
        np.testing.assert_allclose(metrics[k], want[k], rtol=1e-6, err_msg=k)
    assert ("sem_side_bpp" in metrics) == (name in ("raw_semantics_no_feat", "base_codec_raw",
                                                     "no_label_encoder_binarization"))
    assert ("base_codec_bpp" in metrics) == name.startswith("base_codec")
    if name in ("raw", "no_feat_encoding"):  # raw pixels: nothing a stream could carry
        assert metrics["total_bpp"] == metrics.get("coded_bpp", 0.0)


def test_trainer_code_methods_raise_without_a_binarized_module():
    """Raw semantics and no visual features (the three-phase recipe's phase
    1): no code at all, so the code methods raise as JAX's Trainer's do and
    the rate is 0; the reconstruction runs."""
    from jpdse_tpu_torch.trainer import Trainer

    r = ref("raw_semantics_no_feat")
    trainer = Trainer(port_config("raw_semantics_no_feat"), device="cpu")
    trainer._std.codec.load_state_dict(from_jax_params(r["params"]))
    for fn in (trainer.get_code, trainer.get_code_and_contexts):
        with pytest.raises(ValueError, match="no binarized module in this configuration"):
            fn(r["batch"])
    assert trainer.get_eval_rate(r["batch"]) == (0.0, 0.0)
    np.testing.assert_allclose(trainer.get_img(r["batch"]).numpy(), r["decode"], atol=ATOL)
