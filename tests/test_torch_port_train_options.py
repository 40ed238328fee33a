"""Training options of the port against the JAX package, on the CPU at the
tiny flagship widths: dropout in the generator's res blocks
(``model.use_dropout``), the bf16 VGG trunk (``optim.vgg_bf16``) and the
profiler trace of the first epoch (``profile_dir``).

Dropout: the same masks (numpy, one per res block, in block order) are
injected into both packages, JAX's through Flax's ``random.bernoulli`` and
the port's through ``models/layers.py::dropout_mask``; the training decode
and its gradients must then match JAX's at the fast-train tolerances
(image atol 2e-5 + rtol 1e-4; each gradient leaf 3e-4 of the largest
gradient + 1e-3 relative), in the default and the kernel configuration.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen.stochastic as flax_stochastic
from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.models.vgg import Vgg19Features as JaxVgg
from jpdse_tpu.train.losses import vgg_loss as jax_vgg_loss
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.models import layers
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.vgg import Vgg19Features
from jpdse_tpu_torch.train import run
from jpdse_tpu_torch.train.losses import vgg_loss
from test_torch_port_codec import _jax_params
from test_torch_port_fast_train import GRAD_ATOL, GRAD_RTOL, _leaves
from test_torch_port_train_e2e import _quiet, train_argv, write_tree
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W, B = 32, 64, 2


def dropout_case(fused: bool):
    cfg = _flagship_cfg(tiny=True)
    m = cfg.model
    m.compute_dtype, m.use_dropout, m.fused_instance_norm = "float32", True, fused
    m.no_label_encoding = m.no_feat_encoding = True
    cfg.validate()
    rng = np.random.default_rng(9)
    batch = {k: np.array(v) for k, v in _batch(cfg, B, H, W, rng).items()}
    inputs = jax_prepare_inputs(cfg, batch["label"], batch["instance"], batch["image"])
    params = _jax_params(JaxCodec(cfg), inputs, seed=6)
    res = m.ngf * 2**m.n_downsample_global
    masks = [rng.random((B, H // 4, W // 4, res)) < 0.5 for _ in range(m.n_blocks_global)]
    return cfg, batch, inputs, params, masks


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused_instance_norm"])
def test_dropout_matches_jax_with_the_same_masks(fused, monkeypatch):
    jcfg, batch, inputs, params, masks = dropout_case(fused)
    probe = np.random.default_rng(3).normal(size=(B, H, W, 3)).astype(np.float32)
    jcodec = JaxCodec(jcfg)

    def jax_loss(p):
        drawn = iter(masks)
        fake_random = types.SimpleNamespace(
            bernoulli=lambda key, p, shape: jnp.asarray(next(drawn)).reshape(shape))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax_stochastic, "random", fake_random)
            fake, _ = jcodec.apply({"params": p}, inputs, train=True, deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0),
                                         "binarize": jax.random.PRNGKey(1)},
                                   method=JaxCodec.decode)
        return jnp.sum(fake * probe), fake

    (_, want), want_g = jax.value_and_grad(jax_loss, has_aux=True)(params)

    cfg = Config.from_dict(jcfg.to_dict())
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(params))
    drawn = iter(masks)
    monkeypatch.setattr(layers, "dropout_mask",
                        lambda shape, gen, device, hg=None: torch.from_numpy(next(drawn)))
    tb = codec.prepare({k: torch.from_numpy(v) for k, v in batch.items()})
    fake, _ = codec.decode(tb, train=True, deterministic=False, generator=torch.Generator())
    assert next(drawn, None) is None  # one mask a res block
    np.testing.assert_allclose(fake.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
    names = [n for n, _ in codec.named_parameters()]
    grads = torch.autograd.grad((fake * torch.from_numpy(probe)).sum(),
                                list(codec.parameters()))
    got_g = _leaves(to_jax_params({n: g.double() for n, g in zip(names, grads)}))
    want_g = _leaves(want_g)
    scale = max(np.abs(v).max() for v in want_g.values())
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], atol=GRAD_ATOL * scale, rtol=GRAD_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_masks_come_from_the_generator_and_replay_under_remat(remat):
    """The masks are drawn from the step's generator (the same seed gives
    the same decode, another seed another), each keeps about half, block
    remat recomputes with the same masks (its gradients equal the
    unrematted decode's), and in evaluation the decode is the codec's
    without dropout, bit for bit."""
    jcfg, batch, *_ = dropout_case(False)
    cfg = Config.from_dict(jcfg.to_dict())
    cfg.optim.remat = remat
    codec = SemanticCodec(cfg, device="cpu", seed=0)
    tb = codec.prepare({k: torch.from_numpy(v) for k, v in batch.items()})

    def run_decode(seed):
        fake, _ = codec.decode(tb, deterministic=False,
                               generator=torch.Generator().manual_seed(seed))
        return fake, torch.autograd.grad(fake.square().sum(), list(codec.parameters()))

    a, ga = run_decode(1)
    b, gb = run_decode(1)
    c, _ = run_decode(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)
    cfg.optim.remat = not remat
    other = SemanticCodec(cfg, device="cpu", seed=0)
    fake, _ = other.decode(tb, deterministic=False, generator=torch.Generator().manual_seed(1))
    g_other = torch.autograd.grad(fake.square().sum(), list(other.parameters()))
    assert torch.equal(fake, a)
    for x, y in zip(ga, g_other):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)
    cfg.model.use_dropout = False
    plain = SemanticCodec(cfg, device="cpu", seed=None)
    plain.load_state_dict(codec.state_dict())
    with torch.no_grad():
        assert torch.equal(codec.decode(tb)[0], plain.decode(tb)[0])
    kept = layers.dropout_mask((64, 64, 64), torch.Generator().manual_seed(0), "cpu")
    assert abs(kept.float().mean().item() - 0.5) < 0.01


BF16_ATOL = 2e-2  # of a slice's max-abs: the two bf16 trunks differ by up to 9.8e-3 here,
# as much as JAX's bf16 trunk differs from its fp32 one (1.0e-2)


def test_bf16_vgg_matches_jax_bf16_trunk():
    """The port's VGG cast to bf16 against JAX's ``Vgg19Features(dtype=
    bf16)`` on bf16-cast weights, from the same fp32 image: each relu
    slice within BF16_ATOL of its max-abs (the two packages round their
    bf16 convolutions differently), and ``vgg_loss`` (slice L1s reduced in
    fp32) within 1e-2 relative; each package's bf16 loss within 5e-2 of
    its fp32 one."""
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda: JaxVgg().init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 32, 32, 3))))["params"]
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * (1.0 / np.sqrt(np.prod(s.shape[:-1]))
                                               if len(s.shape) == 4 else 0.01)
                   ).astype(np.float32), shapes)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    y = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    jbf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    jnet = JaxVgg(dtype=jnp.bfloat16)
    want = [np.asarray(f, np.float32) for f in jnet.apply({"params": jbf}, x)]
    vgg = Vgg19Features()
    vgg.load_state_dict(from_jax_params(params))
    vgg.requires_grad_(False)
    fp32_loss = vgg_loss(vgg, torch.from_numpy(x), torch.from_numpy(y)).item()
    vgg = vgg.to(torch.bfloat16)
    got = vgg(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=BF16_ATOL * np.abs(w).max(), rtol=0)
    loss = vgg_loss(vgg, torch.from_numpy(x), torch.from_numpy(y)).item()
    jloss = float(jax_vgg_loss(lambda a: jnet.apply({"params": jbf}, a), x, y))
    jloss32 = float(jax_vgg_loss(lambda a: JaxVgg().apply({"params": params}, a), x, y))
    assert loss == pytest.approx(jloss, rel=1e-2)
    assert loss == pytest.approx(fp32_loss, rel=5e-2) and jloss == pytest.approx(jloss32, rel=5e-2)
    assert fp32_loss == pytest.approx(jloss32, rel=1e-4)


def test_profile_dir_traces_the_first_epoch_only(tmp_path):
    """``--profile_dir`` writes one Chrome trace, of the first trained epoch,
    naming the step's operators; the second epoch is not traced."""
    root, run_dir, trace_dir = tmp_path / "cityscapes", tmp_path / "run", tmp_path / "trace"
    write_tree(root)
    argv = train_argv(root, run_dir, "--num_epochs", "2", "--val_interval", "5",
                      "--max_dataset_size", "2", "--no_vgg_loss",
                      "--profile_dir", str(trace_dir))
    trainer, _ = _quiet(lambda: run.main(argv, device="cpu"))
    assert trainer.steps_taken == 2  # one step an epoch
    traces = sorted(trace_dir.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::conv") for n in names)
    # the first epoch's one step: G's and D's Adam
    steps = [e for e in events if e.get("name", "").startswith("Optimizer.step#Adam")
             and not e.get("cat", "").startswith("gpu_")]
    assert len(steps) == 2


def test_kept_share_of_many_masks_is_half():
    gen = torch.Generator().manual_seed(5)
    shares = [layers.dropout_mask((2, 8, 16, 32), gen, "cpu").float().mean().item()
              for _ in range(50)]
    assert abs(np.mean(shares) - 0.5) < 0.01 and len(set(shares)) > 1


def test_compiled_cost_counts_a_convolution_on_the_meta_device():
    """``compiled_cost`` counts 2 FLOPs a multiply-add of a convolution, its
    backward too when the function runs one, without memory (meta)."""
    from jpdse_tpu_torch.utils.profiling import compiled_cost

    x = torch.zeros((2, 8, 16, 16), device="meta", requires_grad=True)
    w = torch.zeros((4, 8, 3, 3), device="meta", requires_grad=True)
    fwd = 2 * 2 * 4 * 16 * 16 * 8 * 9
    conv = torch.nn.functional.conv2d
    assert compiled_cost(lambda a, b: conv(a, b, padding=1), x, w) == {"flops": float(fwd)}
    both = compiled_cost(lambda a, b: conv(a, b, padding=1).sum().backward(), x, w)
    assert both["flops"] == 3 * fwd  # forward, and the input's and the weight's gradients


def test_step_timer_counts_megapixels_a_second_after_its_warmup(monkeypatch):
    from jpdse_tpu_torch.utils import profiling

    clock = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 3.5, 4.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(pixels_per_step=2_000_000, warmup=2)
    assert timer.mps == 0.0
    for _ in range(4):
        with timer:
            pass
    assert timer.steps == 4 and timer.elapsed == 1.0 and timer.mps == 4.0
