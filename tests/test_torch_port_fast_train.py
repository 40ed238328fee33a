"""The PyTorch port's fast train decode (``optim.fast_train``,
``jpdse_tpu_torch/models/fast_train.py``) against the JAX package's
``make_fast_train_decode``, and the pieces it stands on, on the CPU in fp32
at the tiny flagship widths (32x64, ngf 8, 2 downsamples).

Both sides get the same weights (numpy in the Flax layout, carried across
by ``convert.from_jax_params``) and the same batch. Tolerances are the JAX
package's own for its fast decode against its standard one
(tests/test_fast_train.py): the image within atol 2e-5 + rtol 1e-4; each
gradient leaf of ``sum(fake * probe)`` within 3e-4 of the largest
gradient (the global scale) + 1e-3 relative, since a bias an InstanceNorm
follows has a gradient of 0 up to rounding on both sides. The binarizers
are deterministic in both decodes. The port's fast decode is also held
against its own standard decode at the same tolerances, for every variant:
the learned flagship (binarized encoders), raw semantics beside the image,
zero_sem, no semantics, the base codec's decoded image
(``use_compressed``) and no visual features.

Also here: the differentiable twins of the s2d weight transforms, bit-equal
to the numpy transforms, and the ``fused_realign`` switch of the fast path,
whose values all give the same image bit for bit.
"""

import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu.config import Config as JaxConfig
from jpdse_tpu.models import fast_train as jft
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.models import fast_train, fast_trunk
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.ops import s2d
from test_torch_port_codec import _jax_params

H, W, B = 32, 64, 2
FWD = {"atol": 2e-5, "rtol": 1e-4}
GRAD_ATOL, GRAD_RTOL = 3e-4, 1e-3

VARIANTS = {
    "learned": {},
    "raw": {"no_label_encoding": True, "no_feat_encoding": True},
    "zero_sem": {"no_label_encoding": True, "no_feat_encoding": True, "zero_sem": True},
    "nosem": {"no_label_encoding": True, "no_feat_encoding": True, "no_label": True,
              "no_instance": True},
    "use_compressed": {"no_label_encoding": True, "no_feat_encoding": True},
    "no_feat": {"no_feat": True},
}


def jax_cfg(variant: str):
    cfg = _flagship_cfg(tiny=True)
    m = cfg.model
    m.compute_dtype, m.fused_instance_norm, m.phase_deconv = "float32", False, False
    for k, v in VARIANTS[variant].items():
        setattr(m, k, v)
    cfg.codec.use_compressed = variant == "use_compressed"
    cfg.validate()
    return cfg


def batch_for(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    batch = {k: np.array(v) for k, v in _batch(cfg, B, H, W, rng).items()}
    if cfg.codec.use_compressed:
        batch["compressed"] = np.clip(batch["image"] + rng.normal(0, 0.1, batch["image"].shape),
                                      -1, 1).astype(np.float32)
    return batch


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_grads_close(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module", params=list(VARIANTS))
def case(request):
    """JAX's fast decode of one variant (image, label features and the
    gradients of sum(fake * probe)), and the port's codec on its weights."""
    variant = request.param
    jcfg = jax_cfg(variant)
    batch = batch_for(jcfg, 3)
    m = jcfg.model
    inputs = jax_prepare_inputs(jcfg, None if m.no_label else batch["label"],
                                None if m.no_instance else batch["instance"], batch["image"],
                                batch.get("compressed"))
    jcodec = JaxCodec(jcfg)
    params = _jax_params(jcodec, inputs, seed=5)
    probe = np.random.default_rng(7).normal(size=(B, H, W, 3)).astype(np.float32)
    jfast = jft.make_fast_train_decode(jcfg, jcodec)

    def loss(p):
        fake, label = jfast(p, inputs)
        return jnp.sum(fake * probe), (fake, label)

    (_, (fake, label)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    cfg = Config.from_dict(jcfg.to_dict())
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {"variant": variant, "cfg": cfg, "codec": codec, "inputs": codec.prepare(tb),
            "probe": torch.from_numpy(probe), "fake": np.asarray(fake),
            "label": None if label is None else np.asarray(label), "grads": _leaves(grads)}


def port_run(case, decode):
    """(image, label features, named gradients in the Flax layout) of one
    port decode, from ``sum(fake * probe)``."""
    codec = case["codec"]
    fake, label = decode(case["inputs"])
    params = list(codec.named_parameters())
    grads = torch.autograd.grad((fake * case["probe"]).sum(), [p for _, p in params],
                                allow_unused=True)
    named = {n: (torch.zeros_like(p) if g is None else g).double()
             for (n, p), g in zip(params, grads)}
    return (fake.detach().numpy(), None if label is None else label.detach().numpy(),
            _leaves(to_jax_params(named)))


def test_fast_decode_matches_jax(case, monkeypatch):
    """Image, label features and every gradient leaf against JAX's fast
    decode; kernels K1, K2 and K4 are not called (their wrappers raise
    here), whatever the kernel switches say."""
    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called by the fast train decode")

    for name in ("s2d_realign_pad3", "s2d_pad3", "head_conv_s2d"):
        monkeypatch.setattr(fast_trunk, name, refuse)
    cfg = Config.from_dict(case["cfg"].to_dict())
    cfg.model.fast.head_pallas, cfg.model.fast.front_realign = "force", "pallas"
    fast = fast_train.make_fast_train_decode(cfg, case["codec"])
    fake, label, grads = port_run(case, fast)
    np.testing.assert_allclose(fake, case["fake"], **FWD)
    if case["label"] is None:
        assert label is None
    else:
        np.testing.assert_allclose(label, case["label"], **FWD)
    assert_grads_close(grads, case["grads"], f"{case['variant']}: port fast vs JAX fast")


def test_fast_decode_matches_the_standard_decode(case):
    fast = fast_train.make_fast_train_decode(case["cfg"], case["codec"])
    got = port_run(case, fast)
    want = port_run(case, case["codec"].decode)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    assert_grads_close(got[2], want[2], f"{case['variant']}: port fast vs port standard")


def test_fast_decode_matches_the_standard_decode_in_float64(case):
    """In float64, where rounding is ~1e-16, the fast decode's image and
    every gradient leaf equal the standard decode's to 1e-10 of their
    scale: the two compute one function (the s2d InstanceNorm keeps
    float64, as the standard one does)."""
    codec = copy.deepcopy(case["codec"]).double()
    codec.dtype = torch.float64
    inputs = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
              for k, v in case["inputs"].items()}
    c64 = dict(case, codec=codec, inputs=inputs, probe=case["probe"].double())
    got = port_run(c64, fast_train.make_fast_train_decode(case["cfg"], codec))
    want = port_run(c64, codec.decode)
    np.testing.assert_allclose(got[0], want[0], atol=1e-12, rtol=0)
    scale = max(np.abs(v).max() for v in want[2].values())
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], atol=1e-10 * scale, rtol=1e-9,
                                   err_msg=f"{case['variant']}: {k}")


def test_stochastic_binarizers_draw_from_the_step_generator(case):
    """In training the fast decode's binarizers draw from generators derived
    from the step's: the same seed draws the same codes, the generator moves
    on after each decode, and a decode without a binarizer is
    deterministic."""
    fast = fast_train.make_fast_train_decode(case["cfg"], case["codec"])
    with torch.no_grad():
        a, _ = fast(case["inputs"], torch.Generator().manual_seed(1), deterministic=False)
        b, _ = fast(case["inputs"], torch.Generator().manual_seed(1), deterministic=False)
        gen = torch.Generator().manual_seed(1)
        fast(case["inputs"], gen, deterministic=False)
        c, _ = fast(case["inputs"], gen, deterministic=False)
    assert torch.equal(a, b)
    coded = case["codec"].label_coded or case["codec"].feat_coded
    assert torch.equal(a, c) != coded


INELIGIBLE = {
    "netG": ("local", {"no_label_encoding": True, "no_feat_encoding": True}),
    "no_generator_binarization": (False, {}),
    "sem_masking": (True, {}),
    "use_netE_output": (True, {}),
    "norm": ("identity", {}),
    "use_dropout": (True, {}),
    "fused_instance_norm": (True, {}),
    "phase_deconv": (True, {}),
    "netE_groups": (2, {"nef": 8}),
    "inst_wise_pool": (True, {}),
}


@pytest.mark.parametrize("field", list(INELIGIBLE))
def test_ineligible_configs_raise_with_the_jax_reason(field):
    value, extra = INELIGIBLE[field]
    jcfg = jax_cfg("learned")
    for k, v in dict(extra, **{field: value}).items():
        setattr(jcfg.model, k, v)
    if field == "no_generator_binarization":
        jcfg.model.no_encoder_binarization = jcfg.model.no_label_encoder_binarization = True
    cfg = Config.from_dict(jcfg.to_dict())
    want = jft.fast_train_ineligible_reason(JaxConfig.from_dict(jcfg.to_dict()))
    assert want is not None
    assert fast_train.fast_train_ineligible_reason(cfg) == want
    with pytest.raises(ValueError, match=re.escape(f"optim.fast_train unavailable: {want}")):
        fast_train.make_fast_train_decode(cfg, None)
    assert fast_train.fast_train_ineligible_reason(Config.from_dict(
        jax_cfg("learned").to_dict())) is None


TRANSFORMS = {
    "conv_s1": (s2d.conv_s1_weights_to_s2d, s2d.conv_s1_weights_to_s2d_oihw),
    "conv_s2": (s2d.conv_s2_weights_from_s2d_nopad, s2d.conv_s2_weights_from_s2d_nopad_oihw),
}


@pytest.mark.parametrize("shape", [(8, 3, 7, 7), (3, 8, 7, 7), (16, 8, 3, 3), (5, 4, 3, 3)])
def test_s2d_weight_twins_equal_the_numpy_transforms(shape):
    """Each differentiable twin on an OIHW weight equals ``hwio_to_oihw`` of
    the numpy transform bit for bit (7x7 kernels through the stride-1
    transform, 3x3 through the stride-2 one and, as a ConvTranspose2d's
    (in, out, kh, kw) weight, through the transposed one); the gradient of
    a sum through a twin counts each weight's copies."""
    w = torch.from_numpy(np.random.default_rng(sum(shape)).normal(size=shape)
                         .astype(np.float32)).requires_grad_(True)
    if shape[-1] == 7:
        np_fn, twin = TRANSFORMS["conv_s1"]
        want = np_fn(s2d.oihw_to_hwio(w))
    else:
        np_fn, twin = TRANSFORMS["conv_s2"]
        want = np_fn(s2d.oihw_to_hwio(w))
        got_t = s2d.convT_s2_weights_to_s2d_oihw(w)
        g = np.flip(w.detach().numpy().transpose(2, 3, 0, 1), axis=(0, 1))
        want_t = s2d.convT_s2_weights_to_s2d(np.ascontiguousarray(g))
        assert torch.equal(got_t, s2d.hwio_to_oihw(want_t, "cpu", torch.float32))
    got = twin(w)
    assert torch.equal(got, s2d.hwio_to_oihw(want, "cpu", torch.float32))
    assert got.is_contiguous(memory_format=torch.channels_last)
    (grad,) = torch.autograd.grad(got.sum(), w)
    ones = np_fn(np.ones(s2d.oihw_to_hwio(w).shape, np.float32))
    np.testing.assert_array_equal(grad.numpy().sum(), ones.sum())


def test_s2d_weight_twins_make_their_index_once_on_the_weights_device():
    """A twin's gather positions are made once per (transform, shape,
    device) and kept on the weight's device: later calls (a training step's
    re-layouts) reuse them, so no step copies an index to the card."""
    w = torch.ones(4, 3, 7, 7, requires_grad=True)
    s2d.conv_s1_weights_to_s2d_oihw(w)
    misses = s2d._relayout_index.cache_info().misses
    s2d.conv_s1_weights_to_s2d_oihw(w * 2)
    assert s2d._relayout_index.cache_info().misses == misses
    shape, dst, src = s2d._relayout_index(s2d.conv_s1_weights_to_s2d, (7, 7, 3, 4), w.device)
    assert dst.device == src.device == w.device
    assert not (dst.is_inference() or src.is_inference())
    assert shape == s2d.conv_s1_weights_to_s2d(np.zeros((7, 7, 3, 4), np.float32)).shape


@pytest.mark.parametrize("how", ["0", "1", "xla"])
def test_fused_realign_forms_give_the_kernel_form_image_bit_for_bit(how):
    """The fast path's ``fused_realign`` switch: '0', '1' and 'xla' (the
    composition) decode the image K1's form ('pallas', its plain version on
    the CPU) decodes, bit for bit, with K4's producer (``head_pallas``
    'force') among the re-alignments."""
    jcfg = jax_cfg("learned")
    cfg = Config.from_dict(jcfg.to_dict())
    cfg.model.fast.head_pallas = "force"
    state = SemanticCodec(cfg, device="cpu", seed=0).state_dict()
    tb = {k: torch.from_numpy(v) for k, v in batch_for(jcfg, 4).items()}
    cfg.model.fast.fused_realign = "pallas"
    want = FastCodec(cfg, state, device="cpu").decode(tb)
    cfg.model.fast.fused_realign = how
    fast = FastCodec(cfg, state, device="cpu")
    assert fast.netG.fp.fused_realign == how
    assert torch.equal(fast.decode(tb), want)
