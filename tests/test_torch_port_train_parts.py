"""The pieces of the PyTorch port's training slice against the JAX package,
on the CPU: K3's backward (plain version against ``jax.vjp`` of the Pallas
kernel's custom VJP in interpret mode, and ``gradcheck`` of the autograd
Function), the stochastic sign, the discriminator, VGG, the pooling and
every loss, Adam from equal gradients, and the plateau schedule.

Tolerances: fp32 1e-5 absolute for K3's backward (the tolerance the
forward is held to: fp32 statistics summed in another order) and for the
forwards and losses at the reference's weight scale; bf16 within one bf16
ulp beyond 1e-5; Adam 1e-7 absolute on the parameters (optax and torch
order the same operations differently and take the bias corrections in
fp32 and float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jpdse_tpu.models import discriminator as jdisc
from jpdse_tpu.models import layers as jlayers
from jpdse_tpu.models import vgg as jvgg
from jpdse_tpu.ops import quantizers as jq
from jpdse_tpu.ops.pallas import instance_norm as pin
from jpdse_tpu.train import losses as jlosses
from jpdse_tpu.train.schedule import ReduceLROnPlateau as JaxPlateau
from jpdse_tpu_torch.config import flagship_config
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.models import layers
from jpdse_tpu_torch.models.discriminator import MultiscaleDiscriminator
from jpdse_tpu_torch.models.vgg import Vgg19Features, load_vgg19_params
from jpdse_tpu_torch.ops import instance_norm, quantizers
from jpdse_tpu_torch.train import losses, step
from jpdse_tpu_torch.train.schedule import ReduceLROnPlateau
from jpdse_tpu_torch.train.state import GANTrainState, make_adam
from jpdse_tpu_torch.utils import image_pool
from test_torch_port_threads import port_test_threads  # noqa: F401

COMBOS = [(True, False), (False, True), (False, False)]  # (relu, residual)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _fill(shapes, seed, scale=0.02):
    """A Flax parameter tree of these shapes from numpy: kernels normal(0,
    scale), biases small but nonzero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * scale).astype(np.float32), shapes)


@pytest.fixture
def force_interpret():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


# -- K3's backward --------------------------------------------------------------

def _jax_vjp(x, res, g, relu):
    """(dx, dresidual) of the Pallas kernel's custom VJP."""
    if res is None:
        _, vjp = jax.vjp(lambda a: pin._fused_in(a, None, relu, 1e-5), x)
        return vjp(g)[0], None
    _, vjp = jax.vjp(lambda a, r: pin._fused_in(a, r, relu, 1e-5), x, res)
    return vjp(g)


def _autograd(x, res, g, relu):
    x = x.clone().requires_grad_()
    r = None if res is None else res.clone().requires_grad_()
    y = instance_norm.fused_instance_norm(x, r, relu=relu)
    return torch.autograd.grad(y, [x] + ([] if r is None else [r]), g)


@pytest.mark.parametrize("relu,has_res", COMBOS)
def test_instance_norm_bwd_plain_matches_jax_vjp_fp32(force_interpret, relu, has_res):
    x = _x((2, 8, 12, 6)) * 3 + 1
    g = _x((2, 8, 12, 6), seed=2)
    res = _x((2, 8, 12, 6), seed=1) if has_res else None
    want_dx, want_dres = _jax_vjp(jnp.asarray(x), None if res is None else jnp.asarray(res),
                                  jnp.asarray(g), relu)
    got = instance_norm.fused_instance_norm_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                                     relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_dx), atol=1e-5)
    # the autograd Function on the CPU: the plain backward, the residual's
    # gradient the output's
    grads = _autograd(torch.from_numpy(x), None if res is None else torch.from_numpy(res),
                      torch.from_numpy(g), relu)
    assert torch.equal(grads[0], got)
    if has_res:
        np.testing.assert_array_equal(grads[1].numpy(), np.asarray(want_dres))


@pytest.mark.parametrize("relu,has_res", COMBOS)
def test_instance_norm_bwd_plain_matches_jax_vjp_bf16(force_interpret, relu, has_res):
    x = _x((2, 8, 8, 16)) * 3 + 1
    g = _x((2, 8, 8, 16), seed=2)
    res = _x((2, 8, 8, 16), seed=1) if has_res else None
    bf = jnp.bfloat16
    want, _ = _jax_vjp(jnp.asarray(x).astype(bf), None if res is None else
                       jnp.asarray(res).astype(bf), jnp.asarray(g).astype(bf), relu)
    want = np.asarray(want.astype(jnp.float32))
    got = instance_norm.fused_instance_norm_bwd_plain(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(), relu=relu)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(want)) + 1e-30)) - 7)
    assert np.all(np.abs(got - want) - 1e-5 <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
def test_instance_norm_bwd_plain_on_given_statistics(relu, dtype):
    """Given the forward's (b, c, 2) fp32 mean and rstd, the plain backward
    uses them, as the kernel does: equal to recomputing them when they are
    the same numbers, and following them when they are not."""
    x = (torch.from_numpy(_x((2, 8, 12, 6))) * 3 + 1).to(dtype)
    g = torch.from_numpy(_x((2, 8, 12, 6), seed=2)).to(dtype)
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    rstd = torch.rsqrt(((x32 - mean[:, None, None]) ** 2).mean(dim=(1, 2)) + 1e-5)
    stats = torch.stack([mean, rstd], dim=-1)
    want = instance_norm.fused_instance_norm_bwd_plain(x, g, relu)
    assert torch.equal(instance_norm.fused_instance_norm_bwd_plain(x, g, relu, stats=stats), want)
    moved = instance_norm.fused_instance_norm_bwd_plain(x, g, relu, stats=stats * 1.01)
    assert not torch.equal(moved, want)


@pytest.mark.parametrize("relu,has_res", COMBOS)
def test_instance_norm_function_gradcheck_float64(relu, has_res):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 5, 6, 4)) * 2 + 0.5).requires_grad_()
    res = torch.from_numpy(rng.normal(size=(2, 5, 6, 4))).requires_grad_() if has_res else None
    assert torch.autograd.gradcheck(
        lambda a, r: instance_norm.FusedInstanceNorm.apply(a, r, relu, 1e-5), (x, res))


def test_instance_norm_bwd_wrapper_counts_and_checks():
    x, g = torch.from_numpy(_x((1, 4, 6, 8))), torch.from_numpy(_x((1, 4, 6, 8), 1))
    before = instance_norm.fused_instance_norm_bwd.launches
    assert torch.equal(instance_norm.fused_instance_norm_bwd(x, g, None, relu=True),
                       instance_norm.fused_instance_norm_bwd_plain(x, g, relu=True))
    assert instance_norm.fused_instance_norm_bwd.launches == before
    with pytest.raises(ValueError, match="differs"):
        instance_norm.fused_instance_norm_bwd(x, g[:, :2], None)
    meta = torch.empty((1, 4, 6, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        instance_norm.fused_instance_norm_bwd(meta, meta, torch.empty((1, 8, 2), device="meta"))


# -- the stochastic sign --------------------------------------------------------

def test_stochastic_sign_equals_jax_formula_given_u_and_passes_gradients():
    x = np.tanh(_x((2, 4, 4, 8)))
    u = np.random.default_rng(5).random(x.shape).astype(np.float32)
    u[0, 0, 0, :4] = (1.0 - x[0, 0, 0, :4]) / 2.0  # on the boundary: +1
    want = np.asarray(jnp.where((1.0 - jnp.asarray(x)) / 2.0 <= jnp.asarray(u), 1.0, -1.0))
    got = quantizers.sign_from_uniform(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    xt = torch.from_numpy(x).requires_grad_()
    w = torch.from_numpy(_x(x.shape, 6))
    gen = torch.Generator().manual_seed(0)
    y = quantizers.stochastic_sign_ste(xt, gen)
    assert set(np.unique(y.detach().numpy())) <= {-1.0, 1.0}
    (gx,) = torch.autograd.grad((y * w).sum(), xt)
    assert torch.equal(gx, w)
    # JAX's gradient is the identity too
    jg = jax.grad(lambda a: jnp.sum(jq.stochastic_sign_ste(a, jax.random.PRNGKey(0))
                                    * jnp.asarray(w.numpy())))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jg), w.numpy())
    # the draws: P(+1) = (1 + x) / 2, and one generator state gives one draw
    big = torch.full((200000,), 0.4)
    mean = quantizers.stochastic_sign_ste(big, torch.Generator().manual_seed(1)).mean().item()
    assert abs(mean - 0.4) < 0.01
    a = quantizers.stochastic_sign_ste(xt, torch.Generator().manual_seed(7))
    b = quantizers.stochastic_sign_ste(xt, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    d = quantizers.deterministic_sign_ste(torch.tensor([-0.5, 0.0, 0.5]))
    assert d.tolist() == [-1.0, 0.0, 1.0]


def test_binarizer_needs_a_generator_in_training():
    b = quantizers.Binarizer(4, 3)
    with pytest.raises(ValueError, match="Generator"):
        b(torch.zeros(1, 2, 2, 4), deterministic=False)


# -- the discriminator, VGG, the pool and the losses ----------------------------

@pytest.mark.parametrize("h,w", [(64, 128), (13, 22)])
def test_avg_pool_3s2_matches_jax(h, w):
    x = _x((2, h, w, 5))
    want = np.asarray(jlayers.avg_pool_3s2(jnp.asarray(x)))
    got = layers.avg_pool_3s2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(layers._pool_valid_counts(h, w), jlayers._pool_valid_counts(h, w))


@pytest.fixture(scope="module")
def disc_pair():
    jd = jdisc.MultiscaleDiscriminator(ndf=8, n_layers=3, num_D=2)
    x = _x((2, 64, 128, 11))
    shapes = jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = _fill(shapes, 1)
    td = MultiscaleDiscriminator(11, ndf=8, n_layers=3, num_D=2)
    td.load_state_dict(from_jax_params(params))
    return jd, params, td, x


@pytest.mark.parametrize("keep_input", [False, True])
def test_discriminator_features_match_jax(disc_pair, keep_input):
    jd, params, td, x = disc_pair
    want = jd.apply({"params": params}, jnp.asarray(x), keep_input)
    with torch.no_grad():
        got = td(torch.from_numpy(x), keep_input)
    assert len(got) == len(want) == 2
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws) == 5 + keep_input
        for g, w in zip(gs, ws):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_discriminator_and_vgg_params_round_trip_bit_equal(disc_pair):
    _, params, td, _ = disc_pair
    back = to_jax_params(td.state_dict())
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert sorted(td.state_dict())[:2] == ["scale0.layer0.conv.bias", "scale0.layer0.conv.weight"]


@pytest.fixture(scope="module")
def vgg_pair(tmp_path_factory):
    jv = jvgg.Vgg19Features()
    x = _x((2, 32, 48, 3))
    shapes = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * (0.5 / np.sqrt(np.prod(s.shape[:-1])) if
                   len(s.shape) == 4 else 0.01)).astype(np.float32), shapes)
    tv = Vgg19Features()
    tv.load_state_dict(from_jax_params(params))
    # the .npz layout JAX reads
    path = tmp_path_factory.mktemp("vgg") / "vgg19.npz"
    np.savez(path, **{f"{n}.{k}": v for n, d in params.items() for k, v in d.items()})
    return jv, params, tv, x, path


def test_vgg_slices_match_jax_and_npz_loads(vgg_pair):
    jv, params, tv, x, path = vgg_pair
    want = jv.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tv(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    loaded = load_vgg19_params(str(path))
    assert all(torch.equal(loaded[k], v) for k, v in tv.state_dict().items())
    jloaded = jvgg.load_vgg19_params(str(path))["params"]
    assert set(jloaded) == set(params)


def _preds(seed, n=2):
    rng = np.random.default_rng(seed)
    shapes = [(2, 33, 65, 8), (2, 17, 33, 16), (2, 9, 17, 32), (2, 10, 18, 64), (2, 11, 19, 1)]
    return [[rng.normal(size=s).astype(np.float32) for s in shapes[:-1]]
            + [rng.random(size=shapes[-1]).astype(np.float32)] for _ in range(n)]


def _to(preds, fn):
    return [[fn(a) for a in scale] for scale in preds]


@pytest.mark.parametrize("use_lsgan", [True, False])
@pytest.mark.parametrize("real", [True, False])
def test_gan_loss_matches_jax(use_lsgan, real):
    p = _preds(0)
    want = float(jlosses.gan_loss(_to(p, jnp.asarray), real, use_lsgan))
    got = float(losses.gan_loss(_to(p, torch.from_numpy), real, use_lsgan))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_feature_matching_and_distortion_losses_match_jax():
    pf, pr = _preds(1), _preds(2)
    want = float(jlosses.feature_matching_loss(_to(pf, jnp.asarray), _to(pr, jnp.asarray), 2))
    got = losses.feature_matching_loss(_to(pf, torch.from_numpy), _to(pr, torch.from_numpy), 2)
    assert abs(float(got) - want) <= 1e-5
    a, b = _x((2, 16, 32, 3), 3), _x((2, 16, 32, 3), 4)
    for kind in ("l1", "mse"):
        want = float(jlosses.distortion_loss(jnp.asarray(a), jnp.asarray(b), kind))
        got = float(losses.distortion_loss(torch.from_numpy(a), torch.from_numpy(b), kind))
        assert abs(got - want) <= 1e-5
    with pytest.raises(ValueError):
        losses.distortion_loss(torch.zeros(1), torch.zeros(1), "l3")


@pytest.mark.parametrize("chunk", [0, 1, 3])
def test_vgg_losses_match_jax(vgg_pair, chunk):
    jv, params, tv, _, _ = vgg_pair
    fake, real = np.tanh(_x((4, 32, 48, 3), 8)), np.tanh(_x((4, 32, 48, 3), 9))
    want = float(jlosses.vgg_loss_chunked(lambda z: jv.apply({"params": params}, z),
                                          jnp.asarray(fake), jnp.asarray(real), chunk))
    with torch.no_grad():
        got = float(losses.vgg_loss_chunked(tv, torch.from_numpy(fake), torch.from_numpy(real),
                                            chunk))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


# -- Adam and the plateau schedule ----------------------------------------------

def test_apply_equals_optax_adam_from_equal_gradients():
    """Three steps of the port's apply against optax.inject_hyperparams(adam)
    from the same gradients, D's second step on zero gradients (what
    loss.no_d_gan_loss hands it), and an lr change between steps."""
    cfg = flagship_config(tiny=True)
    cfg.loss.anneal_lambda, cfg.loss.anneal_interval, cfg.loss.anneal_factor = True, 2, 5.0
    rng = np.random.default_rng(0)
    g_shapes = {"a": (3, 3, 4, 8), "b": (8,)}
    d_shapes = {"c": (4, 4, 2, 5), "d": (5,)}
    params = {k: (rng.normal(size=s) * 0.02).astype(np.float32)
              for k, s in {**g_shapes, **d_shapes}.items()}
    g_mod = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(params[k].copy()))
                                    for k in g_shapes})
    d_mod = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(params[k].copy()))
                                    for k in d_shapes})
    state = GANTrainState(cfg, g_mod, d_mod, None, make_adam(cfg, g_mod.parameters()),
                          make_adam(cfg, d_mod.parameters()))
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=cfg.optim.lr, b1=cfg.optim.beta1,
                                               b2=cfg.optim.beta2, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg_params = {k: jp[k] for k in g_shapes}
    jd_params = {k: jp[k] for k in d_shapes}
    os_g, os_d = opt.init(jg_params), opt.init(jd_params)
    for i in range(3):
        gg = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 0)).astype(np.float32)
              for k, s in g_shapes.items()}
        gd = {k: (np.zeros(s) if i == 1 else rng.normal(size=s) * 1e-3).astype(np.float32)
              for k, s in d_shapes.items()}
        if i == 2:  # the plateau hook between steps
            from jpdse_tpu_torch.train.state import set_lr

            set_lr(state, 2e-5)
            os_g.hyperparams["learning_rate"] = jnp.asarray(2e-5, jnp.float32)
            os_d.hyperparams["learning_rate"] = jnp.asarray(2e-5, jnp.float32)
        step.apply(state, ([torch.from_numpy(gg[k]) for k in g_shapes],
                           [torch.from_numpy(gd[k]) for k in d_shapes]))
        up, os_g = opt.update({k: jnp.asarray(v) for k, v in gg.items()}, os_g, jg_params)
        jg_params = optax.apply_updates(jg_params, up)
        up, os_d = opt.update({k: jnp.asarray(v) for k, v in gd.items()}, os_d, jd_params)
        jd_params = optax.apply_updates(jd_params, up)
        for mod, jtree in ((g_mod, jg_params), (d_mod, jd_params)):
            for k, p in mod.items():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jtree[k]), rtol=0,
                                           atol=1e-7)
    assert state.steps_taken == 3 and state.lambda_distortion_weight == 5.0
    assert all(p.grad is None for p in g_mod.parameters())
    assert int(os_d.inner_state[0].count) == 3
    assert all(s["step"].item() == 3 for s in state.opt_d.state.values())


def test_plateau_schedule_lr_sequence_equals_jax():
    losses_seq = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.5, 3.5, 3.5, 3.5, 3.5, 3.5, 3.5]
    a, b = ReduceLROnPlateau(2e-4, 0.1, 3), JaxPlateau(2e-4, 0.1, 3)
    got = [a.step(v) for v in losses_seq]
    assert got == [b.step(v) for v in losses_seq]
    assert got[-1] < 2e-4 and a.state_dict() == b.state_dict()


def test_image_pool_fills_then_swaps_or_passes_through():
    """The JAX pool's semantics with the draws made explicit: while filling,
    each fake passes through and is stored; once full, a drawn 'use old'
    swaps it with the drawn slot and returns the stored image, else it
    passes through; pool_size 0 is the identity."""
    state = image_pool.init_pool(2, (1, 1, 1), "cpu")
    img = lambda *v: torch.tensor(v, dtype=torch.float32).reshape(-1, 1, 1, 1)  # noqa: E731
    out = image_pool.query(state, img(1.0, 2.0, 3.0, 4.0), [True, True, True, False], [0, 0, 1, 0])
    assert out.flatten().tolist() == [1.0, 2.0, 2.0, 4.0]
    assert state.num_imgs == 2 and state.images.flatten().tolist() == [1.0, 3.0]
    use_old, rid = image_pool.draw(state, 5, torch.Generator().manual_seed(0))
    assert len(use_old) == len(rid) == 5 and all(0 <= r < 2 for r in rid)
    empty = image_pool.init_pool(0, (1, 1, 1), "cpu")
    x = img(5.0, 6.0)
    assert image_pool.query(empty, x, [True] * 2, [0] * 2) is x
