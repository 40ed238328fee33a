"""The rest of the model family in the PyTorch port against the JAX package,
fp32 on the CPU, weights drawn with numpy in the Flax layout and carried
across by ``convert.from_jax_params``: the grouped ``Encoder``,
``GroupedConvTransposeNormAct`` (the port's ``ConvTransposeNormAct`` with
``groups``) and ``Binarizer`` at 2 groups and at one group per channel,
``instance_wise_avg_pool`` (ids past ``num_segments`` clipped), the identity
norm, ``replicate`` and ``zero`` padding in ``ResnetBlock``; then a codec
with a grouped netE (3 groups) whose output is averaged over each instance:
its decode, its codes and decode_from_codes (which raises as JAX's does),
and one GAN step in the default and the ``fused_instance_norm``
configuration against ``make_train_step``. Tolerances: modules 1e-5
absolute, the codec's images 2e-4 (``test_torch_port_codec.py``), the step
``test_torch_port_train_step.py``'s. The batch norm builds (its parity with
JAX is ``test_torch_port_batch_norm.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdse_tpu.models import generator as jgen
from jpdse_tpu.models import layers as jlayers
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.ops.quantizers import Binarizer as JaxBinarizer
from jpdse_tpu_torch.config import Config, check_ported, flagship_config
from jpdse_tpu_torch.convert import deconv_groups, from_jax_params, to_jax_params
from jpdse_tpu_torch.models import layers
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import NLayerDiscriminator
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.models.generator import Encoder
from jpdse_tpu_torch.ops.quantizers import Binarizer
from test_torch_port_train_step import jax_config, recipe_weights, run_steps
from test_torch_port_threads import port_test_threads  # noqa: F401

ATOL = 1e-5


def _draw(module, *args, seed=0):
    """Flax params of ``module`` for ``args``, drawn from numpy: kernels
    normal(0, 0.02), biases normal(0, 0.02) too, so every bias mapping is
    exercised."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.02).astype(np.float32), shapes)


def _port_params(params, groups=1):
    """A Flax module's params in the port's layout (the bridge keys them
    under a network name, which carries the transposed convs' groups)."""
    state = from_jax_params({"netE": params}, {"netE": groups})
    return {k[len("netE."):]: v for k, v in state.items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("groups", [2, 4], ids=["2 groups", "a group per channel"])
def test_grouped_encoder_matches_jax(groups):
    """Input 4 channels, ngf 4 (one channel a group at 4 groups), 2
    downsamples, a 16-bit grouped binarizer: the encoder's output, its code
    and the decode from the code."""
    x = _x((2, 32, 64, 4))
    jenc = jgen.Encoder(4, 4, ngf=4, n_downsampling=2, binarize=True, binarizer_out_channels=16,
                        groups=groups)
    params = _draw(jenc, jnp.asarray(x))
    enc = Encoder(4, 4, ngf=4, n_downsampling=2, binarize=True, binarizer_out_channels=16,
                  groups=groups)
    enc.load_state_dict(_port_params(params, groups))
    assert enc.up[0].deconv.groups == groups and enc.binarizer.conv.groups == groups
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(x)))
    want_code = np.asarray(jenc.apply({"params": params}, jnp.asarray(x), method=jenc.encode))
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
        code = enc.encode(torch.from_numpy(x))
        from_code = enc.decode_from_code(code).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(code.numpy(), want_code)
    np.testing.assert_allclose(from_code, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("groups", [2, 8], ids=["2 groups", "a group per channel"])
def test_grouped_conv_transpose_norm_act_and_bridge(groups):
    """GroupedConvTransposeNormAct 8 -> 8 channels (the bridge's grouped
    ConvTranspose layout: torch[j*ipg + ci, ol] = flax[:, :, ci, j*opg +
    ol]), and the bridge's round trip bit-equal."""
    x = _x((2, 8, 16, 8))
    jmod = jgen.GroupedConvTransposeNormAct(8, groups)
    params = _draw(jmod, jnp.asarray(x))
    mod = layers.ConvTransposeNormAct(8, 8, groups=groups)
    state = _port_params(params, groups)
    mod.load_state_dict(state)
    assert tuple(mod.deconv.weight.shape) == (8, 8 // groups, 3, 3)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    back = to_jax_params({"netE." + k: v for k, v in state.items()}, {"netE": groups})["netE"]
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("groups", [2, 8], ids=["2 groups", "a group per channel"])
def test_grouped_binarizer_matches_jax(groups):
    x = _x((2, 8, 16, 8))
    jmod = JaxBinarizer(8, groups=groups)
    params = _draw(jmod, jnp.asarray(x), True)
    mod = Binarizer(8, 8, groups)
    mod.load_state_dict(_port_params(params))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_instance_wise_avg_pool_matches_jax():
    """Ids past num_segments share its last segment (clipped), negative
    ids the first; (B, H, W) and (B, H, W, 1) ids."""
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 16, 24, 5)).astype(np.float32)
    inst = rng.integers(-3, 40, (2, 16, 24)).astype(np.int32)
    for ids in (inst, inst[..., None]):
        want = np.asarray(jlayers.instance_wise_avg_pool(jnp.asarray(feats), jnp.asarray(ids), 30))
        got = layers.instance_wise_avg_pool(torch.from_numpy(feats), torch.from_numpy(ids), 30)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    got = layers.instance_wise_avg_pool(torch.from_numpy(feats), torch.from_numpy(inst), 30)
    top = inst[0] >= 29  # ids 29 to 39 all pool into segment 29
    assert top.sum() > 1
    np.testing.assert_allclose(got[0].numpy()[top], np.broadcast_to(
        feats[0][top].mean(0), (top.sum(), 5)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("padding", ["reflect", "replicate", "zero"])
@pytest.mark.parametrize("norm", ["instance", "identity"])
def test_resnet_block_padding_and_norm_match_jax(padding, norm):
    x = _x((2, 8, 16, 6))
    jmod = jlayers.ResnetBlock(6, padding, norm)
    params = _draw(jmod, jnp.asarray(x))
    for fused in (False, True):
        mod = layers.ResnetBlock(6, fused=fused, padding_type=padding, norm=norm)
        mod.load_state_dict(_port_params(params))
        assert mod.fused == (fused and norm == "instance")
        want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = mod(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_replicate_pad_matches_jax():
    x = _x((1, 5, 7, 2))
    np.testing.assert_array_equal(layers.replicate_pad(torch.from_numpy(x), 2).numpy(),
                                  np.asarray(jlayers.replicate_pad(jnp.asarray(x), 2)))


@pytest.mark.parametrize("norm", ["instance", "identity"])
def test_conv_norm_act_norms_match_jax(norm):
    x = _x((2, 16, 32, 3))
    jmod = jlayers.ConvNormAct(8, 7, reflect=3, norm=norm)
    params = _draw(jmod, jnp.asarray(x))
    mod = layers.ConvNormAct(3, 8, 7, reflect=3, norm=norm)
    mod.load_state_dict(_port_params(params))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(mod(torch.from_numpy(x)).numpy(), want, rtol=0, atol=ATOL)


def test_identity_norm_codec_matches_jax():
    """The tiny flagship with ``model.norm`` 'identity' in every network
    (D's layers too), standard path; the fast path refuses it as JAX's."""
    jcfg = jax_config("phase2", False)
    jcfg.model.norm = "identity"
    w = recipe_weights("phase2")
    b = w["batch"]
    inputs = jax_prepare_inputs(jcfg, b["label"], b["instance"], b["image"])
    jcodec = JaxCodec(jcfg)
    want = np.asarray(jcodec.apply({"params": w["g"]}, inputs, method=JaxCodec.decode)[0])
    cfg = Config.from_dict(jcfg.to_dict())
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(w["g"]))
    with torch.no_grad():
        got = codec.decode(codec.prepare({k: torch.from_numpy(v) for k, v in b.items()}))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    d = NLayerDiscriminator(4, 8, 3, norm="identity")
    feats = d(torch.from_numpy(_x((1, 32, 32, 4))))
    assert len(feats) == 5 and all(torch.isfinite(f).all() for f in feats)
    with pytest.raises(ValueError, match="ungrouped instance-norm"):
        FastCodec(cfg, codec.state_dict(), device="cpu")


def _grouped_ref():
    """JAX's grouped, instance-pooled codec on the recipe's weights."""
    jcfg = jax_config("grouped", False)
    w = recipe_weights("grouped")
    b = w["batch"]
    inputs = jax_prepare_inputs(jcfg, b["label"], b["instance"], b["image"])
    jcodec = JaxCodec(jcfg)

    def apply(method, *args):
        return jcodec.apply({"params": w["g"]}, *args, method=method)

    return jcfg, w, apply(JaxCodec.decode, inputs)[0], apply(JaxCodec.get_codes_shaped, inputs)


def test_grouped_pooled_codec_decode_and_codes_match_jax():
    jcfg, w, want, want_codes = _grouped_ref()
    cfg = Config.from_dict(jcfg.to_dict())
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(w["g"], deconv_groups(cfg)))
    assert codec.netE.inst_wise_pool and codec.netE.head.conv.conv.groups == 3
    batch = {k: torch.from_numpy(v) for k, v in w["batch"].items()}
    with torch.no_grad():
        inputs = codec.prepare(batch)
        got = codec.decode(inputs)[0]
        codes = codec.get_codes_shaped(inputs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
        assert len(codes) == len(want_codes) == 2
        for c, wc in zip(codes, want_codes):
            np.testing.assert_array_equal(c.numpy(), np.asarray(wc))
        with pytest.raises(ValueError, match="inst_wise_pool needs instance ids at decode"):
            codec.decode_from_codes(codes)
        with pytest.raises(ValueError, match="requires instance ids"):
            codec.netE(inputs["real_image"])
    with pytest.raises(ValueError, match="ungrouped instance-norm"):
        FastCodec(cfg, codec.state_dict(), device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused_instance_norm"])
def test_grouped_pooled_codec_train_step_matches_jax(fused, monkeypatch):
    metrics, state = run_steps("grouped", fused, 1, monkeypatch)
    assert state.codec.netE.up[0].deconv.groups == 3 and np.isfinite(metrics["loss_G"].item())


def test_batch_norm_raises_naming_item_10():
    """The batch norm, which raised naming item 10 before it was ported,
    passes the gate and builds: a block holds its norm as Flax names it,
    D its ``norm{n}``, and the norm mode chooses the statistics (the layer
    against Flax's is ``test_torch_port_batch_norm.py``'s)."""
    cfg = flagship_config(tiny=True)
    cfg.model.norm = "batch"
    check_ported(cfg)
    block = layers.ConvNormAct(3, 4, 3, norm="batch")
    disc = NLayerDiscriminator(4, 8, 3, norm="batch")
    assert {"norm.BatchNorm_0.scale", "norm.BatchNorm_0.bias", "norm.BatchNorm_0.mean",
            "norm.BatchNorm_0.var"} <= set(block.state_dict())
    assert {f"norm{n}.BatchNorm_0.var" for n in (1, 2, 3)} <= set(disc.state_dict())
    x = torch.randn(2, 8, 8, 3)
    with torch.no_grad():
        outs = {}
        for mode in (layers.RUNNING, layers.BATCH, layers.UPDATE):
            with layers.norm_mode(mode):
                outs[mode] = block(x)
    assert torch.equal(outs[layers.BATCH], outs[layers.UPDATE])
    assert not torch.equal(outs[layers.RUNNING], outs[layers.BATCH])
    assert not torch.equal(block.norm.BatchNorm_0.mean, torch.zeros(4))  # UPDATE moved it
    with pytest.raises(ValueError, match="norm mode"):
        layers.norm_mode("train")
