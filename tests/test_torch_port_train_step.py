"""The PyTorch port's GAN training step against the JAX package's
``make_train_step``, at the tiny flagship config (64x128, ngf 8, 2
downsamples, 2 res blocks, ndf 8), batch 2, fp32 on the CPU.

Both sides get the same generator, discriminator and VGG weights (drawn
with numpy in the Flax layout and carried across by
``convert.from_jax_params``) and the same batch, for the flagship's
phase-1 recipe (no netE: netG fed by netE4label's code; no distortion
loss), its phase-2 recipe (the full GAN with VGG, feature matching and
distortion) and its phase-3 recipe (distortion only, D stepped on zero
gradients), in
the default configuration and in ``model.fused_instance_norm`` (K3 at every
norm site; the JAX package runs its off-TPU form of the same switch). Both
packages' ``stochastic_sign_ste`` is patched to the deterministic sign,
so the binarizers draw nothing; before each step the port's codes are
checked equal to JAX's (a bit whose pre-sign rests on rounding would make
the two steps decode different codes).

The port takes two steps. Before each, its parameters, lambda and step
count are carried into JAX (``convert.to_jax_params``), so both packages
take their gradients at the same point. JAX's step is built once per
configuration with a stand-in optimizer that returns the gradients as its
state, so the gradients themselves are compared. Tolerances: the eight
metrics 1e-4 relative; each G and D gradient tensor 1e-4 of its own
max-abs (float reassociation through the convolutions and the
InstanceNorm statistics). A bias of a conv that an InstanceNorm follows
has a gradient of exactly 0 (the norm removes any constant): both sides'
must be 0 to rounding, at most 1e-5 of the largest gradient of its
network.

Where a gradient tensor misses that bound against JAX in fp32, the same
JAX step is evaluated in float64 (see :func:`jax_precision`) from the same
parameters and batch, and the port's fp32 gradient must be within 1e-4 of
its max-abs of that. It happens in the GAN recipe: at this size a weight
gradient of the full-resolution discriminator sums a few hundred terms,
and a pre-activation within fp32 rounding of a leaky ReLU's kink, taken on
the other side of it, moves the sum by up to 1e-2 of its max-abs. The
distortion-only recipe has no such miss (asserted).
"""

import contextlib
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jpdse_tpu.ops.quantizers as jq
import jpdse_tpu.train.step as jstep
from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import build_discriminator as jax_build_disc
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.models.vgg import Vgg19Features as JaxVgg
from jpdse_tpu.train.state import create_train_state as jax_create_state
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import deconv_groups, from_jax_params, to_jax_params
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import build_discriminator
from jpdse_tpu_torch.models.fast_train import make_fast_train_decode
from jpdse_tpu_torch.models.vgg import Vgg19Features
from jpdse_tpu_torch.ops import quantizers
from jpdse_tpu_torch.train import step
from jpdse_tpu_torch.train.state import create_train_state
from test_torch_port_codec import _jax_params
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W, B = 64, 128, 2
RTOL = 1e-4
RECIPES = ("phase1", "phase2", "phase3")
# Phase 1's second step at these weights lies where fp32 cannot resolve some
# of G's gradients: against JAX's float64 step, JAX's own fp32 gradients miss
# by up to ~1e-2 of their max-abs, and so do the port's, each on its own
# tensors (a value at its rounding edge before a ReLU); the port in float64
# matches JAX in float64 to ~2e-7.
FP32_LIMITED = {"phase1", "grouped", "fast_train"}
# Through the fast train decode, netE's binarizer kernel lies there too: JAX's
# fp32 step misses its float64 step by ~2.5e-3 of that tensor's max-abs, the
# port's by ~2.2e-3.
# The grouped, instance-pooled netE's tail bias (a gradient summed over every
# pixel through the pooling's segment means) lies there too: JAX's fp32 step
# misses its float64 step by ~1.4e-4 of that tensor's max-abs, the port's by
# ~1.8e-4.
# the module structure each recipe's weights are drawn for (the others share phase 2's)
STRUCTURE = {"phase1": "phase1", "g_binarized": "g_binarized", "phaseA": "phaseA",
             "phaseB": "phaseA", "hiresA": "hiresA", "hiresB": "hiresA", "grouped": "grouped"}


def jax_config(recipe: str, fused: bool):
    """The tiny flagship with the phase's training recipe
    (artifacts/flagship_r3/phase{1,2,3}/opt.json), fp32; or phase 2's
    recipe with an ablation (``zero_sem``, ``use_netE_output``) or with the
    generator's bottleneck binarized instead of the encoders
    (``g_binarized``); or phase 2's recipe through the fast train decode
    (``fast_train``); or the base-codec recipe's phases
    (artifacts/flagship_r3_compressed/phase{A,B}/opt.json: raw semantics and
    the base codec's decoded image into netG, no encoder; A the GAN, B
    distortion only); or the hires recipe's (artifacts/flagship_r3_hires:
    the same assembly into a LocalEnhancer, ngf 4, one enhancer of one res
    block); or phase 2's recipe with a grouped netE (3 groups, nef 6) whose
    output is averaged over each instance (ids clipped at 600)."""
    cfg = _flagship_cfg(tiny=True)
    m, L, o = cfg.model, cfg.loss, cfg.optim
    m.compute_dtype = "float32"
    m.fast_inference = False
    m.ndf = 8
    m.fused_instance_norm = fused
    o.remat, o.remat_granularity = True, "block"
    cfg.data.normalize_std = (1.0, 1.0, 1.0)
    cfg.data.batch_size = B
    if recipe == "phase1":
        m.no_feat, L.no_distortion_loss = True, True
        cfg.data.normalize_std = (0.5, 0.5, 0.5)
    if recipe in ("phaseA", "phaseB", "hiresA", "hiresB"):
        m.no_feat_encoding = m.no_label_encoding = True
        cfg.codec.use_compressed = True
    if recipe in ("hiresA", "hiresB"):
        m.netG, m.ngf, m.n_local_enhancers, m.n_blocks_local = "local", 4, 1, 1
    if recipe == "grouped":
        m.netE_groups, m.nef, m.encoder_binarizer_out_channels = 3, 6, 12
        m.inst_wise_pool, m.max_instance_id = True, 600
    if recipe in ("phase3", "phaseB", "hiresB"):
        L.no_d_gan_loss = L.no_g_gan_loss = L.no_gan_feat_loss = L.no_vgg_loss = True
        o.schedule_lr, o.lr_decay_patience = True, 3
    if recipe in ("zero_sem", "use_netE_output"):
        setattr(m, recipe, True)
    if recipe == "fast_train":
        o.fast_train = True
    if recipe == "g_binarized":
        m.no_generator_binarization = False
        m.no_encoder_binarization = m.no_label_encoder_binarization = True
        m.generator_binarizer_out_channels = 16
    cfg.validate()
    return cfg


def _capture():
    """An optimizer whose state is the last gradients and whose update is 0."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), {"g": g}))


def _det_sign(x, key):
    return jq.deterministic_sign_ste(x)


_WEIGHTS = {}


def recipe_weights(recipe: str) -> dict:
    """The batch and the G, D and VGG weights (numpy, Flax layout) for the
    recipe's module structure, drawn once per structure."""
    key = STRUCTURE.get(recipe, "phase2")
    if key in _WEIGHTS:
        return _WEIGHTS[key]
    cfg = jax_config(key, False)
    rng = np.random.default_rng(11)
    batch = {k: np.array(v) for k, v in _batch(cfg, B, H, W, rng).items()}
    if cfg.codec.use_compressed:  # the base codec's decoded image, normalized
        batch["compressed"] = np.clip(batch["image"] + rng.normal(0, 0.1, batch["image"].shape),
                                      -1, 1).astype(np.float32)
    inputs = jax_prepare_inputs(cfg, batch["label"], batch["instance"], batch["image"],
                                batch.get("compressed"))
    codec = JaxCodec(cfg)
    params_g = _jax_params(codec, inputs, seed=12)
    disc = jax_build_disc(cfg)
    d_in = jnp.zeros((B, H, W, cfg.netD_input_nc))
    rng = np.random.default_rng(13)
    params_d = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.02).astype(np.float32),
        jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(3), d_in))["params"])
    vshapes = jax.eval_shape(lambda: JaxVgg().init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32, 32, 3))))["params"]
    params_v = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * (1.0 / np.sqrt(np.prod(s.shape[:-1]))
                                               if len(s.shape) == 4 else 0.01)
                   ).astype(np.float32), vshapes)
    _WEIGHTS[key] = {"batch": batch, "g": params_g, "d": params_d, "v": params_v}
    return _WEIGHTS[key]


@contextlib.contextmanager
def jax_precision(x64: bool):
    """JAX in fp32, or in float64: x64 on, and ``jnp.float32`` read as
    float64 by the JAX package, which names its compute type so."""
    if not x64:
        yield jnp.float32
        return
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        yield jnp.float64


_JAX = {}


def jax_step(recipe, fused, weights, state, x64=False, freeze_global=False):
    """JAX's step at the port ``state``'s parameters, lambda and step count:
    (metrics, grads_g, grads_d, codes), in fp32 or, with ``x64``, in float64
    (codes only in fp32); ``freeze_global`` as ``make_train_step`` takes it.
    Each configuration and precision is compiled once; its optimizer is a
    stand-in that returns the gradients as its state."""
    key = (recipe, fused, x64, freeze_global)
    with jax_precision(x64) as ftype, pytest.MonkeyPatch.context() as mp:
        cast = lambda tree: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, ftype) if np.asarray(a).dtype.kind == "f" else a, tree)
        mp.setattr(jq, "stochastic_sign_ste", _det_sign)
        if key not in _JAX:
            mp.setattr(jstep, "make_optimizers", lambda c: (_capture(), _capture()))
            cfg = jax_config(recipe, fused)
            codec, disc = JaxCodec(cfg), jax_build_disc(cfg)
            vgg = None
            if not cfg.loss.no_vgg_loss:
                params_v, net = cast(weights["v"]), JaxVgg(dtype=ftype)
                vgg = lambda x: net.apply({"params": params_v}, x)  # noqa: E731
            fn = jstep.make_train_step(cfg, codec, disc, vgg, donate=False,
                                       freeze_global=freeze_global)
            batch = {k: jnp.asarray(v) for k, v in cast(weights["batch"]).items()}
            inputs = jax_prepare_inputs(cfg, batch["label"], batch["instance"], batch["image"],
                                        batch.get("compressed"))
            codes = jax.jit(lambda p: codec.apply({"params": p}, inputs,
                                                  method=JaxCodec.get_codes_shaped))
            _JAX[key] = (cfg, fn, batch, codes)
        cfg, fn, batch, codes = _JAX[key]
        params_g = cast(to_jax_params(state.codec.state_dict(), deconv_groups(cfg)))
        jstate = jax_create_state(cfg, params_g, cast(to_jax_params(state.disc.state_dict())))
        jstate = jstate.replace(
            steps_taken=jnp.asarray(state.steps_taken, jnp.int32),
            lambda_distortion_weight=jnp.asarray(state.lambda_distortion_weight, ftype))
        new, metrics = fn(jstate, batch, jax.random.PRNGKey(0))
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree_util.tree_map(np.asarray, new.opt_state_g["g"]),
                jax.tree_util.tree_map(np.asarray, new.opt_state_d["g"]),
                None if x64 else [np.asarray(c) for c in codes(params_g)])


def port_state(recipe, fused, weights):
    cfg = Config.from_dict(jax_config(recipe, fused).to_dict())
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(weights["g"], deconv_groups(cfg)))
    disc = build_discriminator(cfg, "cpu", None)
    disc.load_state_dict(from_jax_params(weights["d"]))
    vgg = None
    if not cfg.loss.no_vgg_loss:
        vgg = Vgg19Features()
        vgg.load_state_dict(from_jax_params(weights["v"]))
        vgg.requires_grad_(False)
    return create_train_state(cfg, codec, disc, vgg)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# biases that a norm follows (an InstanceNorm or a batch norm, which removes a
# per-channel constant too): the generator's and encoders' blocks (a
# LocalEnhancer's c7, d1 and up among them), the discriminator's normalized
# layers (Flax key paths); not a batch norm's own bias
NORMED_BIAS = re.compile(
    r"\['(head|down\d+|up\d*|res\d+|layer[1-9]|c7|d1)'\](?!.*BatchNorm_0).*\['bias'\]$")


def _named(module, grads):
    names = [n for n, _ in module.named_parameters()]
    cfg = getattr(module, "cfg", None)  # a codec's grouped netE
    return _flat(to_jax_params({n: g.double() for n, g in zip(names, grads)},
                               None if cfg is None else deconv_groups(cfg)))


def assert_step_matches(got, want, modules, arbiter, port64=None):
    """Metrics and gradients of one port step against JAX's fp32 step from
    the same point; a gradient tensor that misses it must be within the
    same bound of JAX's float64 step (``arbiter()``, evaluated at the first
    miss). With ``port64`` (the recipes of FP32_LIMITED), where a tensor
    misses that too, the port's float64 step (``port64()``, named gradients
    of G and D) must be within 1e-5 of its max-abs of JAX's float64 step in
    every tensor of both players: at a point that fp32 cannot resolve, the
    two packages compute the same gradients. Returns how many tensors
    needed JAX's float64 step."""
    (got_metrics, got_grads), exact, exact_port = got, None, None
    assert sorted(got_metrics) == list(step.METRICS)
    for k in step.METRICS:
        np.testing.assert_allclose(got_metrics[k].item(), want[0][k], rtol=RTOL, atol=0,
                                   err_msg=k)
    arbitrated = 0
    for j, module in enumerate(modules):
        got, ref = _named(module, got_grads[j]), _flat(want[1 + j])
        top = max(np.abs(v).max() for v in got.values())
        for k in got:
            if NORMED_BIAS.search(k):
                for g in (got[k], ref[k]):
                    assert np.abs(g).max() <= 1e-5 * top, f"{k}: {np.abs(g).max()} not 0"
                continue
            if np.abs(got[k] - ref[k]).max() <= RTOL * np.abs(ref[k]).max():
                continue
            if exact is None:
                exact = arbiter()
            x64 = _flat(exact[1 + j])[k]
            err, top_k = np.abs(got[k] - x64).max(), np.abs(x64).max()
            arbitrated += 1
            if err <= RTOL * top_k:
                continue
            assert port64 is not None, f"{k}: {err} from JAX in float64 (max-abs {top_k}; fp32 JAX {np.abs(ref[k] - x64).max()})"
            if exact_port is None:
                exact_port = port64()
                for i in (0, 1):  # the same math at this point: every tensor of both players
                    for n, a in _flat(exact[1 + i]).items():
                        e = np.abs(exact_port[i][n] - a).max()
                        assert NORMED_BIAS.search(n) or e <= 1e-5 * np.abs(a).max(), \
                            f"{n}: the port in float64 {e} from JAX's"
    return arbitrated


def port_step_f64(state, batch):
    """The port's G and D gradients (named as _flat names them) of one step
    in float64 from the state's parameters."""
    s = copy.copy(state)
    s.codec = copy.deepcopy(state.codec).double()
    s.codec.dtype = torch.float64
    s.disc = copy.deepcopy(state.disc).double()
    s.vgg = None if state.vgg is None else copy.deepcopy(state.vgg).double()
    if state.fast_decode is not None:  # the fast train decode, on the float64 codec
        s.fast_decode = make_fast_train_decode(state.cfg, s.codec)
    _, grads = step.loss_and_grads(s, dict(batch, image=batch["image"].double()),
                                   torch.Generator())
    return [_named(s.codec, grads[0]), _named(s.disc, grads[1])]


def run_steps(recipe, fused, n_steps, monkeypatch):
    """``n_steps`` port steps of the recipe, each held against JAX's from
    the same point (codes first); returns the last step's metrics and the
    port's state."""
    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    weights = recipe_weights(recipe)
    state = port_state(recipe, fused, weights)
    batch = {k: torch.from_numpy(v) for k, v in weights["batch"].items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(n_steps):
        want = jax_step(recipe, fused, weights, state)
        with torch.no_grad():
            codes = state.codec.get_codes_shaped(state.codec.prepare(batch))
        assert len(codes) == len(want[3])
        for got, w in zip(codes, want[3]):
            np.testing.assert_array_equal(got.numpy(), w)
        out = step.loss_and_grads(state, batch, gen)
        arbitrated = assert_step_matches(
            out, want, (state.codec, state.disc),
            lambda: jax_step(recipe, fused, weights, state, x64=True),
            (lambda: port_step_f64(state, batch)) if recipe in FP32_LIMITED else None)
        if recipe in ("phase3", "phaseB"):
            assert arbitrated == 0
        step.apply(state, out[1])
    assert state.steps_taken == n_steps
    return out[0], state


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused_instance_norm"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_two_train_steps_match_jax(recipe, fused, monkeypatch):
    metrics, state = run_steps(recipe, fused, 2, monkeypatch)
    if recipe == "phase1":
        assert state.codec.netE is None and float(metrics["G_Distortion"]) == 0.0
    if recipe == "phase3":
        assert all(float(metrics[k]) == 0.0 for k in ("G_GAN", "G_GAN_Feat", "G_VGG",
                                                        "D_real", "D_fake", "loss_D"))
        assert all(s["step"].item() == 2 for s in state.opt_d.state.values())
