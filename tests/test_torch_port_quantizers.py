"""The port's quantizers (``jpdse_tpu_torch/ops/quantizers.py``) against the
JAX package's (``jpdse_tpu/ops/quantizers.py``) on equal inputs and
parameters, in the cases of ``tests/test_quantizers.py``: the sign's
straight-through gradients, ``rounded_identity``, ``DifferentiableSign``,
and the soft-to-hard vector quantizers ``S2HVQ`` and ``S2HVQV2`` (soft and
hard codes, the decode, the round trip, the pmf and the cross-entropy, and
the gradients of x, the codebook and the MLP). Parameters are drawn in the
Flax layout with numpy and carried by ``convert.from_jax_params``, which
transposes ``S2HVQV2``'s Dense kernels.

Tolerances: in fp32 hard codes, indices, decodes, round trips and signs
equal; the soft codes, pmfs, cross-entropies and gradients in float64 on
both sides (JAX with x64), within 1e-10 of each tensor's max-abs. (In fp32
a soft code carries ``sigma`` times the score's rounding, ~50 x 6e-8 x
|x|^2 in the exponent at sigma 50, past 1e-5 of a code.) The stochastic
sign draws from another generator than JAX's, so it is held by its
distribution, as JAX's test holds its own: P(+1) = (1 + x) / 2 within 0.02
over 20000 draws at x = 0.5 for both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdse_tpu.ops import quantizers as jq
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.ops import quantizers as q
from test_torch_port_threads import port_test_threads  # noqa: F401

TOL = 1e-10


def _close(got, want, tol=TOL):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def test_the_stochastic_sign_has_jax_distribution_and_gradient():
    x = torch.full((20000,), 0.5, requires_grad=True)
    y = q.stochastic_sign_ste(x, torch.Generator().manual_seed(0))
    jy = jq.stochastic_sign_ste(jnp.full((20000,), 0.5), jax.random.PRNGKey(0))
    assert set(y.unique().tolist()) <= {-1.0, 1.0}
    for frac in ((y == 1).float().mean().item(), float(jnp.mean(jy == 1.0))):
        assert abs(frac - 0.75) < 0.02
    (y * 3.0).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jq.stochastic_sign_ste(v, jax.random.PRNGKey(1)) * 3.0))(
        jnp.full((20000,), 0.5))
    _close(x.grad, jg, 0)


def test_the_deterministic_sign_and_rounded_identity_match_jax():
    rng = np.random.default_rng(0)
    v = np.concatenate([[-0.3, 0.0, 0.7, 1.4, 1.5, 1.6, 2.5, -2.5, -0.5, 0.5],
                        rng.normal(size=200) * 3]).astype(np.float32)
    for port_fn, jax_fn in ((q.deterministic_sign_ste, jq.deterministic_sign_ste),
                            (q.rounded_identity, jq.rounded_identity)):
        x = torch.from_numpy(v).requires_grad_(True)
        y = port_fn(x)
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jax_fn(jnp.asarray(v))))
        (y * 2.0).sum().backward()
        _close(x.grad, jax.grad(lambda a: jnp.sum(jax_fn(a) * 2.0))(jnp.asarray(v)), 0)
    # half to even, as torch.round and jnp.round both round
    assert q.rounded_identity(torch.tensor([1.4, 1.5, 1.6, 2.5])).tolist() == [1, 2, 2, 2]


def test_differentiable_sign_modes():
    m = q.DifferentiableSign()
    x = torch.tensor([-0.3, 0.0, 0.7])
    jm = jq.DifferentiableSign()
    want = jm.apply({}, jnp.asarray(x.numpy()), deterministic=True)
    np.testing.assert_array_equal(m(x, deterministic=True).numpy(), np.asarray(want))
    y = m(torch.full((20000,), -0.5), generator=torch.Generator().manual_seed(3))
    jy = jm.apply({}, jnp.full((20000,), -0.5), rngs={"binarize": jax.random.PRNGKey(3)})
    for frac in ((y == 1).float().mean().item(), float(jnp.mean(jy == 1.0))):
        assert abs(frac - 0.25) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        m(x)


# -- soft-to-hard vector quantization ----------------------------------------------
CASES = {  # tests/test_quantizers.py's: (n_centers, center_size, sigma, n, d, code_len)
    "round_trip": (10, 5, 50.0, 7, 15, 3),
    "high_sigma": (4, 2, 1e4, 11, 8, 4),
    "v2": (6, 3, 10.0, 5, 12, 4),
}


def _pair(name: str, v2: bool):
    """JAX's module, its fp32 variables and the port's fp32 module at equal
    parameters (the codebook normal(0, 1) as Flax's ``normal(1.0)``, Dense
    kernels normal(0, 1 / fan_in), biases normal(0, 0.1)), and the case's
    input."""
    n_c, c_size, sigma, n, d, code_len = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + v2)
    x = rng.normal(size=(n, d)).astype(np.float32)
    jm = (jq.S2HVQV2 if v2 else jq.S2HVQ)(n_centers=n_c, center_size=c_size, sigma=sigma)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), code_len))

    def draw(path, s):
        scale = 1.0 if path[-1].key == "codebook" else \
            s.shape[0] ** -0.5 if len(s.shape) == 2 else 0.1
        return (rng.normal(size=s.shape) * scale).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    m = (q.S2HVQV2 if v2 else q.S2HVQ)(n_c, c_size, sigma)
    m.load_state_dict(from_jax_params(params))
    return jm, {"params": params}, m, x, code_len


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("v2", [False, True], ids=["S2HVQ", "S2HVQV2"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_codes_decode_and_rates_match_jax(name, v2):
    jm, variables, m, x, code_len = _pair(name, v2)
    cls = jq.S2HVQV2 if v2 else jq.S2HVQ
    xt = torch.from_numpy(x)
    with torch.no_grad():  # fp32: the hard codes, the decode, the round trip
        hard = m.encode(xt, code_len, False)
        idx = m.encode(xt, code_len, False, raw=False)
        trip = m(xt, code_len, train=False)
        soft32 = m.encode(xt, code_len, True)
    jhard = jm.apply(variables, x, code_len, False, method=cls.encode)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(jhard))
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jm.apply(variables, x, code_len, False, False, method=cls.encode)))
    np.testing.assert_allclose(hard.sum(-1).numpy(), 1.0)
    np.testing.assert_array_equal(m.decode(hard).detach().numpy(),
                                  np.asarray(jm.apply(variables, jhard, method=cls.decode)))
    np.testing.assert_array_equal(trip.numpy(), np.asarray(jm.apply(variables, x, code_len, False)))
    assert abs(q.S2HVQ.get_pmf(soft32).sum().item() - 1.0) < 1e-5
    if name == "high_sigma":
        np.testing.assert_array_equal(soft32.argmax(-1).numpy(), hard.argmax(-1).numpy())
    # float64: the soft codes, the pmfs, the cross-entropies
    m64 = m.double()
    with torch.no_grad():
        soft = m64.encode(xt.double(), code_len, True)
        hard = m64.encode(xt.double(), code_len, False)
    with jax.enable_x64(True):
        v64, x64 = _f64(variables), np.asarray(x, np.float64)
        jsoft = jm.apply(v64, x64, code_len, True, method=cls.encode)
        jhard = jm.apply(v64, x64, code_len, False, method=cls.encode)
        _close(soft, jsoft)
        np.testing.assert_array_equal(hard.numpy(), np.asarray(jhard))
        pmf, hpmf = q.S2HVQ.get_pmf(soft), q.S2HVQ.get_pmf(hard)
        jpmf, jhpmf = jq.S2HVQ.get_pmf(jsoft), jq.S2HVQ.get_pmf(jhard)
        _close(pmf, jpmf)
        _close(hpmf, jhpmf)
        # a hard pmf holds zeros: the centers it skips
        for (a, b), (ja, jb) in zip(((pmf, hpmf), (hpmf, pmf), (pmf, pmf)),
                                    ((jpmf, jhpmf), (jhpmf, jpmf), (jpmf, jpmf))):
            _close(q.S2HVQ.get_cross_entropy(a, b), jq.S2HVQ.get_cross_entropy(ja, jb))
    with pytest.raises(ValueError, match="code_len"):
        m.encode(xt.double(), code_len + 1)


@pytest.mark.parametrize("v2", [False, True], ids=["S2HVQ", "S2HVQV2"])
def test_gradients_match_jax(v2):
    """The soft encode's gradient for x, the codebook and (V2) the MLP, and
    the decode's for the codebook, from equal cotangents."""
    jm, variables, m, x, code_len = _pair("v2" if v2 else "round_trip", v2)
    cls = jq.S2HVQV2 if v2 else jq.S2HVQ
    m = m.double()
    rng = np.random.default_rng(9)
    x = x.astype(np.float64)
    xt = torch.from_numpy(x).requires_grad_(True)
    soft = m.encode(xt, code_len, True)
    cot = rng.normal(size=tuple(soft.shape))
    soft.backward(torch.from_numpy(cot))
    with jax.enable_x64(True):
        params = _f64(variables["params"])
        _, vjp = jax.vjp(lambda p, a: jm.apply({"params": p}, a, code_len, True,
                                               method=cls.encode), params, jnp.asarray(x))
        g_params, g_x = vjp(jnp.asarray(cot))
        _close(xt.grad, g_x)
        # (V2's score reads no codebook: its gradient is None here, zeros in JAX)
        got = {n: torch.zeros_like(p) if p.grad is None else p.grad
               for n, p in m.named_parameters()}
        want = {k: v.double() for k, v in from_jax_params(
            jax.tree_util.tree_map(np.asarray, g_params)).items()}
        # (from_jax_params hands fp32 over: its own rounding, then 1e-7)
        assert got.keys() == want.keys() and len(got) == (7 if v2 else 1)
        for n in want:
            _close(got[n], want[n], 1e-7)
        # the hard decode's gradient reaches the codebook rows it looked up
        m.zero_grad()
        hard = m.encode(xt.detach(), code_len, False)
        dec = m.decode(hard)
        dcot = rng.normal(size=tuple(dec.shape))
        dec.backward(torch.from_numpy(dcot))
        _, dvjp = jax.vjp(lambda p: jm.apply({"params": p}, jnp.asarray(hard.numpy()),
                                             method=cls.decode), params)
        _close(m.codebook.grad, dvjp(jnp.asarray(dcot))[0]["codebook"])


def test_s2hvq_v2_hard_codes_take_the_argmin_of_its_mlp_score():
    jm, variables, m, x, code_len = _pair("v2", True)
    with torch.no_grad():
        score = m._score(torch.from_numpy(x).reshape(x.shape[0], code_len, -1))
        hard = m.encode(torch.from_numpy(x), code_len, False)
    np.testing.assert_array_equal(hard.argmax(-1).numpy(), score.argmin(-1).numpy())
    assert m.fc1.weight.shape == (64, CASES["v2"][1]) and m.fc3.weight.shape == (6, 128)
    with pytest.raises(ValueError, match="sigma"):
        q.S2HVQ(4, 2, sigma=0.0)
