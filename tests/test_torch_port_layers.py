"""Building blocks of the PyTorch port (jpdse_tpu_torch) against their JAX
counterparts, fp32 on the CPU, with the same numpy inputs and weights.

Data movement (padding, s2d layouts, one-hot, edges) is compared exactly;
arithmetic within atol=1e-5 (single layers: float reassociation only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpdse_tpu.models import layers as jl
from jpdse_tpu.models.generator import ConvTransposeNormAct as JaxConvTNA
from jpdse_tpu.ops import s2d as js2d
from jpdse_tpu.ops import semantics as jsem
from jpdse_tpu.ops.quantizers import Binarizer as JaxBinarizer
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.models import layers as tl
from jpdse_tpu_torch.ops import s2d as ts2d
from jpdse_tpu_torch.ops import semantics as tsem
from jpdse_tpu_torch.ops.quantizers import Binarizer
from test_torch_port_threads import port_test_threads  # noqa: F401

ATOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ids(shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_semantics_match_jax():
    label = _ids((2, 12, 10), 7).astype(np.float32)  # float-held ids, as the loader gives
    inst = _ids((2, 12, 10), 4, seed=1)
    want = jsem.prepare_semantics(jnp.asarray(label), jnp.asarray(inst), 6)
    got = tsem.prepare_semantics(_t(label), _t(inst), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tsem.instance_edges(_t(inst)).numpy(), np.asarray(jsem.instance_edges(jnp.asarray(inst))))


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_degrade_ids_matches_jax(factor):
    m = _ids((2, 13, 10), 50)
    np.testing.assert_array_equal(
        tsem.degrade_ids(_t(m), factor).numpy(),
        np.asarray(jsem.degrade_ids(jnp.asarray(m), factor)))


@pytest.mark.parametrize("pad", [1, 3])
def test_reflect_pad_and_instance_norm_match_jax(pad):
    x = _x((2, 9, 7, 5))
    np.testing.assert_array_equal(
        tl.reflect_pad(_t(x), pad).numpy(), np.asarray(jl.reflect_pad(jnp.asarray(x), pad)))
    np.testing.assert_allclose(
        tl.instance_norm(_t(x)).numpy(), np.asarray(jl.instance_norm(jnp.asarray(x))), atol=ATOL)


def _flax(module, x, seed=0):
    """Init a Flax module on x, then redraw its params from numpy."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32),
                                  shapes)


@pytest.mark.parametrize(
    "name,jax_module,port_module,shape",
    [
        ("head", jl.ConvNormAct(8, 7, reflect=3), tl.ConvNormAct(5, 8, 7, reflect=3), (2, 12, 10, 5)),
        ("down", jl.ConvNormAct(8, 3, stride=2, padding=1),
         tl.ConvNormAct(5, 8, 3, stride=2, padding=1), (2, 12, 10, 5)),
        ("res", jl.ResnetBlock(6), tl.ResnetBlock(6), (2, 8, 6, 6)),
        ("up", JaxConvTNA(4), tl.ConvTransposeNormAct(6, 4), (2, 5, 7, 6)),
        ("tail", jl.Conv(3, 7), tl.Conv(6, 3, 7), (2, 12, 10, 6)),
        ("binarizer", JaxBinarizer(16), Binarizer(6, 16), (2, 5, 7, 6)),
    ],
)
def test_layer_matches_jax(name, jax_module, port_module, shape):
    x = _x(shape, seed=2)
    params = _flax(jax_module, x)
    kwargs = {"deterministic": True} if name == "binarizer" else {}
    want = np.asarray(jax_module.apply({"params": params}, jnp.asarray(x), **kwargs))
    port_module.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = port_module(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_s2d_layouts_match_jax():
    x = _x((2, 8, 6, 5))
    y = ts2d.space_to_depth(_t(x))
    np.testing.assert_array_equal(y.numpy(), np.asarray(js2d.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(ts2d.depth_to_space(y).numpy(), x)


def test_instance_norm_s2d_matches_jax():
    x = _x((2, 6, 5, 12)) * 3.0 + 1.0
    np.testing.assert_allclose(
        ts2d.instance_norm_s2d(_t(x)).numpy(),
        np.asarray(js2d.instance_norm_s2d(jnp.asarray(x), use_shift=False)), atol=ATOL)


@pytest.mark.parametrize(
    "fn,shape",
    [
        ("conv_s1_weights_to_s2d", (7, 7, 3, 4)),
        ("conv_s2_weights_from_s2d_nopad", (3, 3, 3, 4)),
        ("convT_s2_weights_to_s2d", (3, 3, 3, 4)),
    ],
)
def test_weight_transforms_equal_jax(fn, shape):
    w = _x(shape, seed=3)
    np.testing.assert_array_equal(getattr(ts2d, fn)(w), getattr(js2d, fn)(w))
