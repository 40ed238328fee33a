"""The port's batch norm (``model.norm`` 'batch') against the JAX package:
the layer against Flax's ``Norm(kind="batch")``, two GAN steps against
JAX's ``make_train_step`` with its ``mstate_g`` / ``mstate_d``, remat, the
LocalEnhancer's frozen trunk, save and resume, evaluation and the
``.jpds`` stream against JAX's ``Trainer``, a JAX run's statistics through
``tools/torch_port_export_params.py``, and two gloo ranks on each parallel
axis against one process on the global batch.

Weights are drawn with numpy in the Flax layout (kernels and biases
normal(0, 0.02), batch-norm scales 1 + normal(0, 0.02), running means
normal(0, 0.1), running variances uniform on [0.5, 1.5]) and carried
across by ``convert.from_jax_params`` with the ``batch_stats`` collection.

Tolerances. The layer: fp32 output within 1e-5 of its max-abs, the new
statistics within 1e-6 of each statistic's max-abs, the input, scale and
bias gradients within 1e-4 of each tensor's max-abs; bf16 output and input
gradient within one bf16 ulp of JAX's value (both round the same fp32
value, which the two packages reach by differently ordered sums), its
scale and bias gradients (fp32) within 1e-4 of their max-abs. The GAN
steps: ``test_torch_port_train_step.py``'s rule (metrics 1e-4 relative,
each gradient 1e-4 of its max-abs, JAX's float64 step arbitrating a fp32
miss; a bias that a norm follows 0 to rounding: a batch norm removes a
per-channel constant as an InstanceNorm does), and the running statistics
after the step within 1e-6 of each tensor's max-abs of JAX's, with the same
float64 arbiter; the hires recipe's step is fp32-limited, so there, as
``FP32_LIMITED`` in that file, the port's float64 step must match JAX's
float64 step within 1e-5 in every tensor. The two ranks:
``test_torch_port_spatial.py``'s rule, float64 within 1e-9 in relative L2
for every gradient and every entry of the state dicts, running statistics
included (a running mean, which takes in the normed bias before it,
within 1e-9 absolute as that bias is); in fp32 a gradient that misses one
process's fp32 step must be within :data:`LIMITED_TOL` of one process's
float64 step from the same point (see there).

The top of this module imports only the port, numpy and torch when a
spawned rank imports it: JAX is imported in the pytest process alone.
"""

import copy
import importlib.util
import io
import multiprocessing
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_port_spatial as sp
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import deconv_groups, from_jax_params, is_stat, to_jax_mstate, \
    to_jax_params
from jpdse_tpu_torch.models import layers
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import build_discriminator
from jpdse_tpu_torch.ops import quantizers
from jpdse_tpu_torch.parallel import distributed, mesh as mesh_mod
from jpdse_tpu_torch.train import step
from jpdse_tpu_torch.train.checkpoint import save_params
from jpdse_tpu_torch.train.state import create_train_state
from jpdse_tpu_torch.trainer import Trainer
from test_torch_port_threads import port_test_threads  # noqa: F401

if multiprocessing.parent_process() is None:  # the spawned ranks need no JAX
    import jax
    import jax.numpy as jnp

    import jpdse_tpu.ops.quantizers as jq
    import jpdse_tpu.train.step as jstep
    from __graft_entry__ import _batch
    from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
    from jpdse_tpu.models.codec import build_discriminator as jax_build_disc
    from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
    from jpdse_tpu.models.layers import Norm as JaxNorm
    from jpdse_tpu.models.vgg import Vgg19Features as JaxVgg
    from jpdse_tpu.train.state import create_train_state as jax_create_state
    from test_torch_port_train_step import _capture, _det_sign, _flat, \
        assert_step_matches, jax_config, jax_precision, port_step_f64, recipe_weights

REPO = Path(__file__).resolve().parents[1]
B, H, W = 2, 64, 128
STAT_TOL = 1e-6
# The hires recipe's step at these weights lies where fp32 cannot resolve the
# enhancer's gradients: the port's fp32 step misses JAX's float64 step by up
# to ~6.7e-3 of a tensor's max-abs in every tensor of local1_down / local1_up
# alike (one value at its rounding edge before a kink, taken on the other
# side, moves all of them; float64 sums inside the batch norm change nothing),
# JAX's fp32 step by ~3e-5; the port in float64 matches JAX in float64 within
# 1e-5 in every tensor, which assert_step_matches then requires.
FP32_LIMITED = {"hires"}


def _max_err(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zeros)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _bf16_ulps(got, want) -> float:
    """The largest difference in bf16 ulps of ``want``'s magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126)))
    return (np.abs(got - want) / 2.0 ** (exp - 7)).max()


# -- the layer -----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [layers.RUNNING, layers.BATCH, layers.UPDATE])
def test_the_layer_matches_flax_batch_norm(mode, dtype):
    rng = np.random.default_rng(3)
    c = 16
    x = (rng.normal(size=(4, 6, 10, c)) * 2.0 + 0.5).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    params = {"BatchNorm_0": {"scale": (1 + 0.02 * rng.normal(size=c)).astype(np.float32),
                              "bias": (0.1 * rng.normal(size=c)).astype(np.float32)}}
    stats = {"BatchNorm_0": {"mean": (0.3 * rng.normal(size=c)).astype(np.float32),
                             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jm = JaxNorm(kind="batch", dtype=jdt)

    def fwd(p, xj):
        v = {"params": p, "batch_stats": stats}
        if mode == layers.RUNNING:
            return jm.apply(v, xj, train=False), stats
        y, new = jm.apply(v, xj, train=True, mutable=["batch_stats"])
        return y, new["batch_stats"]

    xj = jnp.asarray(x, jdt)
    y_j, vjp, new_j = jax.vjp(fwd, params, xj, has_aux=True)
    gp_j, gx_j = vjp(jnp.asarray(cot, jdt))

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    norm = layers.Norm("batch", c)
    norm.load_state_dict(from_jax_params(params, mstate={"batch_stats": stats}))
    before = {k: v.clone() for k, v in norm.state_dict().items()}
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    with layers.norm_mode(mode):
        y = norm(xt)
    y.backward(torch.from_numpy(cot).to(tdt))
    assert y.dtype == tdt
    y_j, gx_j = np.asarray(y_j, np.float32), np.asarray(gx_j, np.float32)
    if dtype == "bfloat16":
        assert _bf16_ulps(y.float().detach(), y_j) <= 1
        assert _bf16_ulps(xt.grad.float(), gx_j) <= 1
    else:
        assert _max_err(y.detach(), y_j) <= 1e-5
        assert _max_err(xt.grad, gx_j) <= 1e-4
    bn = norm.BatchNorm_0
    assert _max_err(bn.scale.grad, gp_j["BatchNorm_0"]["scale"]) <= 1e-4
    assert _max_err(bn.bias.grad, gp_j["BatchNorm_0"]["bias"]) <= 1e-4
    for name in ("mean", "var"):
        got, want = getattr(bn, name), new_j["BatchNorm_0"][name]
        if mode == layers.UPDATE:
            assert _max_err(got, want) <= STAT_TOL, name
            assert not torch.equal(got, before[f"BatchNorm_0.{name}"])
        else:  # the running averages read, or the batch's without the update
            assert torch.equal(got, before[f"BatchNorm_0.{name}"]), name


def test_init_draws_scales_about_one_and_fresh_statistics():
    cfg = bn_config("flagship")
    codec = SemanticCodec(Config.from_dict(cfg.to_dict()), device="cpu", seed=0)
    scales = [p for n, p in codec.named_parameters() if n.endswith("BatchNorm_0.scale")]
    assert scales and all(p.shape[0] > 1 for p in scales)
    s = torch.cat([p.detach() for p in scales])
    assert abs(s.mean().item() - 1.0) < 0.01 and 0.01 < s.std().item() < 0.03
    stats = {k: v for k, v in codec.state_dict().items() if is_stat(k)}
    assert all(torch.all(v == (0.0 if k.endswith("mean") else 1.0)) for k, v in stats.items())
    assert all(p.abs().max() == 0 for n, p in codec.named_parameters()
               if n.endswith("BatchNorm_0.bias"))


def test_the_bridge_round_trip_is_bit_equal_statistics_included():
    w = bn_weights("flagship")
    cfg = Config.from_dict(bn_config("flagship").to_dict())
    groups = deconv_groups(cfg)
    state = from_jax_params(w["g"], groups, w["mstate_g"])
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(state)
    for tree, back in ((w["g"], to_jax_params(codec.state_dict(), groups)),
                       (w["mstate_g"], to_jax_mstate(codec.state_dict()))):
        a, b = _flat(tree), _flat(back)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    disc = build_discriminator(cfg, "cpu", None)
    disc.load_state_dict(from_jax_params(w["d"], None, w["mstate_d"]))
    assert _flat(to_jax_mstate(disc.state_dict())).keys() == _flat(w["mstate_d"]).keys()
    assert any("norm3" in k for k in _flat(w["mstate_d"]))  # D's norm{n}, n = 1..n_layers


# -- the recipes ---------------------------------------------------------------------
def bn_config(recipe: str):
    """A JAX config with ``model.norm`` 'batch': the tiny flagship's phase-2
    recipe (netE4label + netE binarized, VGG, block remat), the recipe of
    ``tests/test_codec_model.py::test_batchnorm_train_step`` (raw label and
    image into netG, no VGG, no remat) or the hires recipe's phase A
    (a LocalEnhancer over raw semantics and a base codec's image)."""
    if recipe == "codec_model":
        from test_codec_model import tiny_cfg

        cfg = tiny_cfg(norm="batch", no_label_encoding=True, no_feat_encoding=True,
                       no_generator_binarization=True)
        cfg.loss.no_vgg_loss = True
        cfg.data.batch_size = B
        cfg.model.compute_dtype = "float32"
    else:
        cfg = jax_config({"flagship": "phase2", "hires": "hiresA"}[recipe], False)
        cfg.model.norm = "batch"
    cfg.validate()
    return cfg


def _draw(tree, rng):
    """Flax variables filled from numpy by their leaf's name."""
    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.02 * rng.normal(size=s.shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.02 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


_WEIGHTS = {}


def bn_weights(recipe: str) -> dict:
    """The batch, G's and D's params and statistics (numpy, Flax layout) and
    VGG's params of a recipe, drawn once."""
    if recipe in _WEIGHTS:
        return _WEIGHTS[recipe]
    cfg = bn_config(recipe)
    if recipe == "codec_model":
        batch = {k: np.array(v) for k, v in _batch(cfg, B, H, W, np.random.default_rng(11))
                 .items()}
        vgg = None
    else:
        base = recipe_weights({"flagship": "phase2", "hires": "hiresA"}[recipe])
        batch, vgg = base["batch"], base["v"]
    inputs = jax_prepare_inputs(cfg, batch["label"], batch["instance"], batch["image"],
                                batch.get("compressed"))
    codec, disc = JaxCodec(cfg), jax_build_disc(cfg)
    g = jax.eval_shape(lambda: codec.init({"params": jax.random.PRNGKey(0)}, inputs,
                                          method=JaxCodec.decode))
    d = jax.eval_shape(lambda: disc.init(jax.random.PRNGKey(3),
                                         jnp.zeros((B, H, W, cfg.netD_input_nc))))
    rng = np.random.default_rng(12)
    g, d = _draw(dict(g), rng), _draw(dict(d), rng)
    _WEIGHTS[recipe] = {"batch": batch, "v": vgg, "g": g["params"], "d": d["params"],
                        "mstate_g": {"batch_stats": g["batch_stats"]},
                        "mstate_d": {"batch_stats": d["batch_stats"]}}
    return _WEIGHTS[recipe]


def bn_state(recipe: str, remat: str = None):
    """The port's training state at the recipe's weights; ``remat`` 'none',
    'block' or 'decode' overrides the recipe's."""
    w = bn_weights(recipe)
    cfg = Config.from_dict(bn_config(recipe).to_dict())
    if remat is not None:
        cfg.optim.remat = remat != "none"
        cfg.optim.remat_granularity = "decode" if remat == "decode" else "block"
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(w["g"], deconv_groups(cfg), w["mstate_g"]))
    disc = build_discriminator(cfg, "cpu", None)
    disc.load_state_dict(from_jax_params(w["d"], None, w["mstate_d"]))
    vgg = None
    if not cfg.loss.no_vgg_loss:
        from jpdse_tpu_torch.models.vgg import Vgg19Features

        vgg = Vgg19Features()
        vgg.load_state_dict(from_jax_params(w["v"]))
        vgg.requires_grad_(False)
    return create_train_state(cfg, codec, disc, vgg)


_JAX = {}


def jax_bn_step(recipe, weights, state, x64=False, freeze_global=False):
    """JAX's step at the port ``state``'s parameters and running statistics:
    (metrics, grads_g, grads_d, codes, mstate_g, mstate_d), in fp32 or, with
    ``x64``, in float64 (codes only in fp32), on a stand-in optimizer that
    returns the gradients as its state."""
    key = (recipe, x64, freeze_global)
    with jax_precision(x64) as ftype, pytest.MonkeyPatch.context() as mp:
        cast = lambda tree: jax.tree_util.tree_map(  # noqa: E731
            lambda a: np.asarray(a, ftype) if np.asarray(a).dtype.kind == "f" else a, tree)
        mp.setattr(jq, "stochastic_sign_ste", _det_sign)
        if key not in _JAX:
            mp.setattr(jstep, "make_optimizers", lambda c: (_capture(), _capture()))
            cfg = bn_config(recipe)
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
            codes = jax.jit(lambda p, ms: codec.apply({"params": p, **ms}, inputs,
                                                      method=JaxCodec.get_codes_shaped))
            _JAX[key] = (cfg, fn, batch, codes)
        cfg, fn, batch, codes = _JAX[key]
        sd_g, sd_d = state.codec.state_dict(), state.disc.state_dict()
        params_g, mstate_g = cast(to_jax_params(sd_g, deconv_groups(cfg))), cast(to_jax_mstate(sd_g))
        jstate = jax_create_state(cfg, params_g, cast(to_jax_params(sd_d)), None, mstate_g,
                                  cast(to_jax_mstate(sd_d)))
        jstate = jstate.replace(
            steps_taken=jnp.asarray(state.steps_taken, jnp.int32),
            lambda_distortion_weight=jnp.asarray(state.lambda_distortion_weight, ftype))
        new, metrics = fn(jstate, batch, jax.random.PRNGKey(0))
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        return ({k: float(v) for k, v in metrics.items()}, host(new.opt_state_g["g"]),
                host(new.opt_state_d["g"]),
                None if x64 else [np.asarray(c) for c in codes(params_g, mstate_g)],
                host(new.mstate_g), host(new.mstate_d))


def assert_stats_match(state, want, arbiter) -> int:
    """G's and D's running statistics after the port's step against JAX's
    (``want[4]``, ``want[5]``) within 1e-6 of each tensor's max-abs; a miss
    held against JAX's float64 step (``arbiter()``). Returns the misses."""
    exact, misses = None, 0
    for j, module in enumerate((state.codec, state.disc)):
        got, ref = _flat(to_jax_mstate(module.state_dict())), _flat(want[4 + j])
        assert got.keys() == ref.keys() and got
        for k in got:
            if _max_err(got[k], ref[k]) <= STAT_TOL:
                continue
            exact = exact or arbiter()
            misses += 1
            assert _max_err(got[k], _flat(exact[4 + j])[k]) <= STAT_TOL, k
    return misses


def run_bn_steps(recipe, n_steps, monkeypatch, freeze_global=False):
    """``n_steps`` port steps of the recipe, each held against JAX's from
    the same point, statistics included; returns the port's state and the
    statistics before the steps."""
    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    weights = bn_weights(recipe)
    state = bn_state(recipe)
    if freeze_global:
        state.codec.netG.global_trunk.requires_grad_(False)
    before = [{k: v.clone() for k, v in m.state_dict().items() if is_stat(k)}
              for m in (state.codec, state.disc)]
    batch = {k: torch.from_numpy(v) for k, v in weights["batch"].items()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(n_steps):
        want = jax_bn_step(recipe, weights, state, freeze_global=freeze_global)
        with torch.no_grad():
            codes = state.codec.get_codes_shaped(state.codec.prepare(batch))
        assert len(codes) == len(want[3])
        for got, w in zip(codes, want[3]):
            np.testing.assert_array_equal(got.numpy(), w)
        snap = copy.copy(state)  # the point the float64 arbiters step from
        snap.codec, snap.disc = copy.deepcopy(state.codec), copy.deepcopy(state.disc)
        out = step.loss_and_grads(state, batch, gen)
        arbiter = lambda: jax_bn_step(recipe, weights, snap, x64=True,  # noqa: E731
                                      freeze_global=freeze_global)
        assert_step_matches(out, want, (state.codec, state.disc), arbiter,
                            (lambda: port_step_f64(snap, batch)) if recipe in FP32_LIMITED
                            else None)
        assert_stats_match(state, want, arbiter)
        step.apply(state, out[1])
    return state, before


@pytest.mark.parametrize("recipe", ["flagship", "codec_model"])
def test_two_gan_steps_match_jax_statistics_included(recipe, monkeypatch):
    state, before = run_bn_steps(recipe, 2, monkeypatch)
    for b, m in zip(before, (state.codec, state.disc)):
        now = m.state_dict()
        assert all(not torch.equal(v, now[k]) for k, v in b.items()), "a statistic stayed"
    assert all(s["step"].item() == 2 for s in state.opt_g.state.values())


def test_the_frozen_global_trunk_updates_its_statistics_as_jax(monkeypatch):
    """A LocalEnhancer under ``niter_fix_global``: the trunk's gradients are
    zeros (JAX's ``freeze_global``), its statistics advance, as JAX's
    ``mutable`` decode advances them."""
    state, before = run_bn_steps("hires", 1, monkeypatch, freeze_global=True)
    now = state.codec.state_dict()
    trunk = [k for k in before[0] if k.startswith("netG.global.")]
    assert trunk and all(not torch.equal(before[0][k], now[k]) for k in trunk)


# -- remat ---------------------------------------------------------------------------
def test_remat_updates_the_statistics_once(monkeypatch):
    """One step without remat, with block remat and with decode remat: the
    same running statistics, bit for bit (a recompute in the backward does
    not advance them again, and G's reads of D, rematerialized too, leave
    D's as they were), and the same gradients."""
    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    batch = {k: torch.from_numpy(v) for k, v in bn_weights("flagship")["batch"].items()}
    out = {}
    for remat in ("none", "block", "decode"):
        state = bn_state("flagship", remat)
        _, grads = step.loss_and_grads(state, batch, torch.Generator().manual_seed(0))
        out[remat] = ([{k: v for k, v in m.state_dict().items() if is_stat(k)}
                       for m in (state.codec, state.disc)], grads)
    want_stats, want_grads = out["none"]
    for remat in ("block", "decode"):
        stats, grads = out[remat]
        for a, b in zip(stats, want_stats):
            assert all(torch.equal(a[k], b[k]) for k in b), remat
        for ga, gb in zip(grads, want_grads):
            for a, b in zip(ga, gb):
                assert (a - b).abs().max() <= 1e-6 * max(b.abs().max().item(), 1e-30), remat


# -- save, resume, evaluation --------------------------------------------------------
def _port_cfg(recipe: str, **paths) -> Config:
    cfg = Config.from_dict(bn_config(recipe).to_dict())
    pp = cfg.data.preprocess
    pp.preprocess_mode, pp.crop_size, pp.aspect_ratio = "fixed", W, W / H
    for k, v in paths.items():
        setattr(cfg, k, v)
    return cfg


def test_a_saved_state_resumes_and_steps_on_as_before(tmp_path, monkeypatch):
    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    batch = bn_weights("codec_model")["batch"]
    cfg = _port_cfg("codec_model", save_dir=str(tmp_path))
    with redirect_stdout(io.StringIO()):
        first = Trainer(copy.deepcopy(cfg), mode="train", device="cpu")
        first.step(batch)
        first.save(0, 1.0)
        second = Trainer(copy.deepcopy(cfg), mode="train", device="cpu")
        second.load()
    for a, b in ((first.gan.codec, second.gan.codec), (first.gan.disc, second.gan.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert any(is_stat(k) for k in sa) and all(torch.equal(sa[k], sb[k]) for k in sa)
    second.generator.set_state(first.generator.get_state())
    m1, m2 = first.step(batch), second.step(batch)
    assert m1 == m2
    for a, b in ((first.gan.codec, second.gan.codec), (first.gan.disc, second.gan.disc)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert first.get_eval_loss(batch) == second.get_eval_loss(batch)


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """JAX's test-mode Trainer and the port's at the flagship recipe's
    weights and running statistics (the fast path asked for: both fall back
    to the standard path for a batch norm)."""
    from jpdse_tpu.trainer import Trainer as JaxTrainer

    run = tmp_path_factory.mktemp("bn_eval")
    w = bn_weights("flagship")
    jcfg = bn_config("flagship")
    jcfg.mode, jcfg.is_train = "test", False
    pp = jcfg.data.preprocess
    pp.preprocess_mode, pp.crop_size, pp.aspect_ratio = "fixed", W, W / H
    jcfg.model.fast_inference = True
    cfg = Config.from_dict(jcfg.to_dict())
    cfg.checkpoints_dir = str(run)
    save_params(str(run), from_jax_params(w["g"], deconv_groups(cfg), w["mstate_g"]))
    with redirect_stdout(io.StringIO()) as log:
        jt = JaxTrainer(jcfg, mode="test")
        jt.state = jt.state.replace(params_g=jax.tree_util.tree_map(jnp.asarray, w["g"]),
                                    mstate_g=jax.tree_util.tree_map(jnp.asarray, w["mstate_g"]))
        trainer = Trainer(cfg, device="cpu")
        trainer.load()
        assert trainer._fast is None and jt._fast is None
    batch = {k: v for k, v in w["batch"].items() if k in ("label", "instance", "image")}
    return {"jt": jt, "trainer": trainer, "batch": batch, "log": log.getvalue()}


def test_eval_reads_the_running_statistics_as_jax(evaluated):
    """The image (2e-4), the codes and the rates (1e-6) of JAX's Trainer at
    equal weights and statistics; a decode in train mode differs."""
    jt, trainer, batch = evaluated["jt"], evaluated["trainer"], evaluated["batch"]
    assert "fast_inference unavailable" in evaluated["log"]
    img = trainer.get_img(batch)
    np.testing.assert_allclose(img.numpy(), jt.get_img(batch), rtol=0, atol=2e-4)
    assert np.array_equal(trainer.get_code(batch), np.asarray(jt.get_code(batch)).astype(np.uint8))
    (s, a), (js, ja) = trainer.get_eval_rate(batch), jt.get_eval_rate(batch)
    assert a == pytest.approx(ja, rel=1e-6) and s == pytest.approx(js, rel=1e-6)
    codec = trainer._std.codec
    kept = {k: v.clone() for k, v in codec.state_dict().items()}
    with torch.no_grad(), layers.norm_mode(layers.BATCH):  # the batch's statistics, no update
        train_img, _ = codec._decode(codec.prepare({k: torch.from_numpy(v)
                                                    for k, v in batch.items()}), True, None)
    assert (train_img.float() - img).abs().max() > 1e-2
    assert all(torch.equal(codec.state_dict()[k], v) for k, v in kept.items())


def test_jpds_streams_are_jax_bytes_and_decode_as_jax(evaluated):
    jt, trainer, batch = evaluated["jt"], evaluated["trainer"], evaluated["batch"]
    streams, jstreams = trainer.compress(batch), jt.compress(batch)
    assert streams == jstreams
    for s in streams:
        np.testing.assert_allclose(trainer.decompress(s), np.asarray(jt.decompress(s)), rtol=0,
                                   atol=2e-4)


def test_a_jax_run_statistics_export_into_the_port(tmp_path):
    """JAX's Trainer takes a step of the test_codec_model recipe and saves;
    ``tools/torch_port_export_params.py`` writes its ``mstate_g`` /
    ``mstate_d`` beside the params; the port's ``Trainer.load`` restores
    every leaf, statistics bit for bit."""
    from jpdse_tpu.trainer import Trainer as JaxTrainer

    cfg = bn_config("codec_model")
    cfg.save_dir = str(tmp_path)
    pp = cfg.data.preprocess
    pp.preprocess_mode, pp.crop_size, pp.aspect_ratio = "fixed", W, W / H
    batch = bn_weights("codec_model")["batch"]
    with redirect_stdout(io.StringIO()):
        jt = JaxTrainer(cfg, mode="train")
        jt.step(batch)
        cfg.save(str(tmp_path / "opt.json"))
        jt.save(epoch=0, val_loss=3.0)
        spec = importlib.util.spec_from_file_location(
            "torch_port_export_params", REPO / "tools/torch_port_export_params.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        tool.export(str(tmp_path))
    pcfg = Config.from_dict(cfg.to_dict())
    pcfg.checkpoints_dir = str(tmp_path)
    with redirect_stdout(io.StringIO()) as log:
        trainer = Trainer(pcfg, mode="train", device="cpu")
        trainer.load()
    gan = trainer.gan
    n = len(gan.codec.state_dict()) + len(gan.disc.state_dict())
    assert f"{n}/{n} leaves matched" in log.getvalue()
    for module, mstate, params in ((gan.codec, jt.state.mstate_g, jt.state.params_g),
                                   (gan.disc, jt.state.mstate_d, jt.state.params_d)):
        got = _flat(to_jax_mstate(module.state_dict()))
        want = _flat(jax.tree_util.tree_map(np.asarray, mstate))
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)
        assert any(not np.all(want[k] == 0) for k in want if k.endswith("['mean']"))
        p_got, p_want = _flat(to_jax_params(module.state_dict())), _flat(params)
        assert all(np.array_equal(p_got[k], np.asarray(p_want[k])) for k in p_want)
    assert trainer.steps_taken == 1


def test_the_warm_start_leaves_the_statistics_fresh(tmp_path):
    """The warm start carries the params (scales and biases included) and
    not the running statistics, as the JAX tool carries params alone."""
    from jpdse_tpu_torch.train.warmstart import renest

    cfg = Config.from_dict(bn_config("flagship").to_dict())
    codec = SemanticCodec(cfg, device="cpu", seed=0)
    out = renest(codec.state_dict())
    assert not any(is_stat(k) for k in out)
    assert "netG.global.head.norm.BatchNorm_0.scale" in out


# -- two ranks -----------------------------------------------------------------------
AXES = ("data", "spatial")


def axis_config(cfg_dict: dict, axis: str) -> Config:
    return sp.case_config(cfg_dict, "default", 2 if axis == "spatial" else 1)


def rank_main(rank: int, port: int, work: str) -> None:
    """One of two gloo ranks: the batch-norm recipe's steps at data_axis 2
    (each rank one image of the global batch) and at spatial_axis 2 (each
    rank half of H of the whole batch), in fp32 and float64."""
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    sp._join(port, 2, rank)
    result = {}
    for axis in AXES:
        for case in sp.CASES:
            cfg = axis_config(spec["cfg"], axis)
            mesh = mesh_mod.mesh_from_config(cfg.parallel)
            batch = spec["batch"]
            if axis == "data":
                batch = {k: v[mesh.rows(1)] for k, v in batch.items()}
            result[(axis, case)] = sp.run_steps(cfg, case, batch, mesh,
                                                resume=spec["resume"].get((axis, case)))
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    dist.destroy_process_group()


def float64_arbiter(cfg: Config, batch: dict, fp32: list) -> list:
    """G's and D's gradients of one process's float64 step from each point
    the fp32 run stepped from (the seeded weights, then its snapshot after
    the previous step), on its code bits, the generator advanced as it
    advanced (the binarizers' uniforms drawn in fp32 and unused)."""
    state = sp.build_state(cfg, "float64", None)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b["image"] = b["image"].double()
    gen = torch.Generator().manual_seed(0)
    real, out = quantizers.stochastic_sign_ste, []
    try:
        for k, run in enumerate(fp32):
            if k:
                sp.restore(state, fp32[k - 1]["snapshot"], None)
            signs = iter(run["signs"])

            def sign(x, generator):
                torch.rand(x.shape, generator=generator)
                return sp._Pinned.apply(x, next(signs))

            quantizers.stochastic_sign_ste = sign
            _, grads = step.loss_and_grads(state, b, gen)
            names = ([n for n, _ in state.codec.named_parameters()],
                     [n for n, _ in state.disc.named_parameters()])
            out.append([dict(zip(n, gs)) for n, gs in zip(names, grads)])
    finally:
        quantizers.stochastic_sign_ste = real
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One process's steps on the global batch and two ranks' from one
    spawn, on each axis (pool 2 and dropout on); while the ranks run, the
    float64 arbiter of one process's fp32 steps."""
    work = tmp_path_factory.mktemp("bn_ranks")
    cfg_dict = bn_config("flagship").to_dict()
    spec = {"cfg": cfg_dict, "batch": sp.global_batch()}
    cfg = axis_config(cfg_dict, "data")
    fp32 = sp.run_steps(cfg, "fp32", spec["batch"], None)
    spec["resume"] = {(axis, "fp32"): [{"snapshot": s["snapshot"], "signs": s["signs"]}
                                       for s in fp32] for axis in AXES}
    torch.save(spec, work / "spec.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = sp.free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, str(work))) for r in range(2)]
    for p in procs:
        p.start()
    single = {"fp32": fp32, "float64": sp.run_steps(cfg, "float64", spec["batch"], None),
              "arbiter": float64_arbiter(cfg, spec["batch"], fp32)}
    for p in procs:
        p.join(timeout=600)
    assert [p.exitcode for p in procs] == [0, 0], "a rank failed"
    return {"single": single,
            "ranks": [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]}


# An fp32 step of the batch-norm recipe cannot resolve its gradients to 1e-4:
# one ulp more in every batch variance moves one process's fp32 G gradients by
# up to 8e-5 of their max-abs (median 2e-5 to 4e-5; this file's recipe, pool 2
# and dropout, CPU), far more than the ulp itself (values at their rounding
# edge before a kink, taken on the other side). The ranks' statistics sum
# every rank's rows, so their activations part from one process's by a few
# ulps everywhere (an instance norm's per-image statistics do not), and
# their fp32 gradients by up to ~6.6e-4 (the spatial axis). The float64 case
# holds the same steps to 1e-9.
LIMITED_TOL = 1e-3


def _hold_fp32(got: dict, want: dict, exact: list) -> None:
    """``test_torch_port_spatial.py``'s fp32 rule (metrics 1e-4 relative,
    each gradient 1e-4 of its max-abs, a normed bias 0 to 1e-5 of its
    network's largest gradient); a tensor that misses one process's fp32
    gradient must be within :data:`LIMITED_TOL` of its max-abs of one
    process's float64 gradient from the same point (``exact``)."""
    for k in step.METRICS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=sp.RTOL, atol=0,
                                   err_msg=k)
    for net_got, net_want, net_exact in zip(got["grads"], want["grads"], exact):
        top = max(g.abs().max().item() for g in net_want.values())
        for n, w in net_want.items():
            g = net_got[n]
            if sp.NORMED_BIAS.search(n):
                assert max(g.abs().max().item(), w.abs().max().item()) <= 1e-5 * top, n
                continue
            if (g - w).abs().max().item() <= sp.RTOL * w.abs().max().item():
                continue
            x = net_exact[n]
            err = (g.double() - x).abs().max().item() / x.abs().max().item()
            assert err <= LIMITED_TOL, f"{n}: {err} of its max-abs from one process's float64"


def _hold_float64(got: dict, want: dict) -> None:
    """``test_torch_port_spatial.py``'s float64 rule; a running mean, which
    takes in the bias of the conv before its norm, within 1e-9 absolute as
    that bias is (Adam moves a normed bias by its gradient's rounding
    noise)."""
    for k in step.METRICS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2 * 2.0**-23,
                                   atol=0, err_msg=k)
    for kind in ("grads", "params"):
        for net_got, net_want in zip(got[kind], want[kind]):
            for n, w in net_want.items():
                if sp.NORMED_BIAS.search(n) or n.endswith("BatchNorm_0.mean"):
                    assert (net_got[n] - w).abs().max().item() <= sp.F64_TOL, f"{kind} {n}"
                else:
                    assert sp._rel_l2(net_got[n], w) <= sp.F64_TOL, f"{kind} {n}"


@pytest.mark.parametrize("case", sp.CASES)
@pytest.mark.parametrize("axis", AXES)
def test_two_ranks_step_as_one_process_statistics_included(two_ranks, axis, case):
    """Each rank's two steps against one process's on the global batch:
    gradients, parameters and running statistics, the binarizers' draws
    each rank's rows of one process's, the ranks' state dicts bit-identical
    after each step."""
    data, size = (2, 1) if axis == "data" else (1, 2)
    single = two_ranks["single"][case]
    ranks_out = [r[(axis, case)] for r in two_ranks["ranks"]]
    assert any(is_stat(k) for k in single[0]["params"][0])
    b = B // data
    for k in range(2):
        for r, got in enumerate(ranks_out):
            d, s = r // size, r % size
            assert len(got[k]["draws"]) == len(single[k]["draws"]) == 2
            for u, want in zip(got[k]["draws"], single[k]["draws"]):
                assert torch.equal(u, sp._h_rows(want[d * b:(d + 1) * b], s, size))
            if case == "float64":
                _hold_float64(got[k], single[k])
            else:
                _hold_fp32(got[k], single[k], two_ranks["single"]["arbiter"][k])
        for a, c in zip(ranks_out[0][k]["params"], ranks_out[1][k]["params"]):
            assert all(torch.equal(a[n], c[n]) for n in a), f"step {k + 1}: ranks differ"
