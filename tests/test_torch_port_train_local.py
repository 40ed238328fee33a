"""Training the hires recipe (``artifacts/flagship_r3_hires``: a
LocalEnhancer over raw semantics and a base codec's decoded image, its
global trunk frozen for ``model.niter_fix_global`` epochs, warm-started
from a trained global generator) in the PyTorch port against the JAX
package, at the tiny widths, fp32 on the CPU.

* Two GAN steps, the first with the global trunk frozen (JAX:
  ``make_train_step(freeze_global=True)``), the second unfrozen, in the
  default and the ``fused_instance_norm`` configuration, with the
  machinery and tolerances of ``test_torch_port_train_step.py`` (metrics
  1e-4 relative, gradients 1e-4 of their max-abs, JAX's float64 step
  arbitrating): the frozen step's global gradients are zeros, its global
  parameters bit-equal afterwards.
* Adam over a frozen and an unfrozen apply against optax from the same
  gradients (1e-7): the frozen trunk's zero gradients step its Adam, as
  optax's one count steps every leaf, so its bias correction after the
  unfreeze is optax's.
* The warm start (``python -m jpdse_tpu_torch.train.warmstart``) against
  ``tools/warmstart_local_from_global.py`` run on the same weights, and the
  leaves a ``--netG local`` model restores from it.
* ``train.run.main`` from the warm start with the trunk frozen for its
  first epoch: bit-equal to the warm start through it, trained in the
  next."""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.train import run, step, warmstart
from jpdse_tpu_torch.train.checkpoint import PARAMS_FILE, restore_params, save_params
from test_torch_port_train_e2e import _quiet, train_argv, write_tree
from test_torch_port_train_step import (
    _flat,
    assert_step_matches,
    jax_config,
    jax_step,
    port_state,
    recipe_weights,
)
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _global(codec):
    return codec.netG.global_trunk


def _snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _frozen_then_unfrozen(fused: bool):
    """The port's two hires steps from the recipe's weights, each held
    against JAX's step from the same point; yields (frozen, state, grads)
    after each step's check; the caller applies it."""
    weights = recipe_weights("hiresA")
    state = port_state("hiresA", fused, weights)
    batch = {k: torch.from_numpy(v) for k, v in weights["batch"].items()}
    gen = torch.Generator().manual_seed(0)
    for frozen in (True, False):
        _global(state.codec).requires_grad_(not frozen)
        want = jax_step("hiresA", fused, weights, state, freeze_global=frozen)
        out = step.loss_and_grads(state, batch, gen)
        assert_step_matches(
            out, want, (state.codec, state.disc),
            lambda: jax_step("hiresA", fused, weights, state, x64=True, freeze_global=frozen))
        yield frozen, state, out[1]


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused_instance_norm"])
def test_two_hires_steps_frozen_then_unfrozen_match_jax(fused):
    for frozen, state, grads in _frozen_then_unfrozen(fused):
        codec = state.codec
        names = [n for n, _ in codec.named_parameters()]
        in_global = [n.startswith("netG.global.") for n in names]
        assert sum(in_global) == len(list(_global(codec).parameters())) > 0
        if frozen:
            assert all(not g.any() for g, ig in zip(grads[0], in_global) if ig)
            before = _snapshot(_global(codec))
            local_before = _snapshot(codec.netG.local1_up)
        else:
            assert all(g.any() for g, ig, n in zip(grads[0], in_global, names)
                       if ig and n.endswith("weight"))
            after = _snapshot(_global(codec))
            assert all(torch.equal(before[k], after[k]) for k in before)  # the frozen step's
            assert any(not torch.equal(local_before[k], v)
                       for k, v in _snapshot(codec.netG.local1_up).items())
        step.apply(state, grads)


def test_hires_adam_over_the_freeze_equals_optax():
    """Two applies on the hires codec and D against optax.adam from equal
    gradients (1e-7): the first as a frozen step hands them (zeros for the
    global trunk, ``step._grads``' zeros for a parameter without
    requires_grad), the second unfrozen. The trunk is unmoved by the first,
    and every G parameter's Adam is at step 2 after the second, as optax's
    one count."""
    cfg = jax_config("hiresA", False)
    opt = optax.adam(cfg.optim.lr, b1=cfg.optim.beta1, b2=cfg.optim.beta2, eps=1e-8)
    state = port_state("hiresA", False, recipe_weights("hiresA"))
    mods = (state.codec, state.disc)
    jp = [{n: jnp.asarray(p.detach().numpy()) for n, p in m.named_parameters()} for m in mods]
    os_ = [opt.init(t) for t in jp]
    first = _snapshot(_global(state.codec))
    rng = np.random.default_rng(4)
    for frozen in (True, False):
        _global(state.codec).requires_grad_(not frozen)
        loss = sum((p * p).sum() for p in state.codec.parameters() if p.requires_grad)
        grads = [step._grads(loss, list(state.codec.parameters())),
                 [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32) * 1e-3)
                  for p in state.disc.parameters()]]
        if frozen:
            assert all(not g.any() for (n, _), g in zip(state.codec.named_parameters(), grads[0])
                       if n.startswith("netG.global."))
        for j, m in enumerate(mods):
            names = [n for n, _ in m.named_parameters()]
            up, os_[j] = opt.update({n: jnp.asarray(g.detach().numpy())
                                     for n, g in zip(names, grads[j])}, os_[j], jp[j])
            jp[j] = optax.apply_updates(jp[j], up)
        step.apply(state, grads)
        for j, m in enumerate(mods):
            for n, p in m.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[j][n]), rtol=0,
                                           atol=1e-7, err_msg=n)
        if frozen:
            assert all(torch.equal(first[k], v) for k, v in _snapshot(_global(state.codec)).items())
    assert {s["step"].item() for s in state.opt_g.state.values()} == {2.0}
    assert len(state.opt_g.state) == len(list(state.codec.parameters()))


def test_warmstart_equals_the_jax_tool(tmp_path, monkeypatch):
    tree = recipe_weights("phaseA")["g"]  # a global netG (ngf 8) as the JAX package saves it
    src_jax, dst_jax = tmp_path / "jax_src", tmp_path / "jax_dst"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(src_jax / "params"), {"params_g": tree}, force=True)
    ckptr.wait_until_finished()
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import warmstart_local_from_global as tool
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["warmstart", "--src", str(src_jax), "--dst", str(dst_jax)])
    _quiet(tool.main)
    want = ocp.PyTreeCheckpointer().restore(str(dst_jax / "params"))["params_g"]

    src, dst = tmp_path / "src", tmp_path / "dst"
    save_params(str(src), from_jax_params(tree))
    _, text = _quiet(lambda: warmstart.main(["--src", str(src), "--dst", str(dst)]))
    assert "moved netG.* -> netG.global.*" in text
    got = to_jax_params(torch.load(dst / PARAMS_FILE, weights_only=True))
    a, b = _flat(want), _flat(got)
    assert a.keys() == b.keys() and not any("tail" in k and "global" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert json.loads((dst / "trainer_meta.json").read_text()) == {
        "epoch": 0, "warmstart_from": str(src)}
    assert json.loads((dst_jax / "trainer_meta.json").read_text())["epoch"] == 0
    assert sorted(p.name for p in dst.iterdir()) == [PARAMS_FILE, "trainer_meta.json"]
    with pytest.raises(ValueError, match="already a LocalEnhancer"):
        warmstart.main(["--src", str(dst), "--dst", str(tmp_path / "again")])

    # a --netG local model at ngf 8 / 2 restores every global-trunk leaf but the tail
    cfg = Config.from_dict(jax_config("hiresA", False).to_dict())
    cfg.model.ngf = 4
    template = SemanticCodec(cfg, device="cpu", seed=None).state_dict()
    (merged, _), _ = _quiet(lambda: restore_params(str(dst), template))
    trunk = [k for k in template if k.startswith("netG.global.")]
    src_params = from_jax_params(tree)
    assert len(trunk) == len([k for k in src_params if not k.startswith("netG.tail.")])
    for k in template:
        expect = src_params["netG." + k[len("netG.global."):]] if k in trunk else template[k]
        assert torch.equal(merged[k], expect), k


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused_instance_norm"])
def test_train_main_holds_the_trunk_for_niter_fix_global_epochs(tmp_path, fused):
    """A global run saves a checkpoint; the warm start re-nests it; a
    --netG local run restores it with --niter_fix_global 2 for two epochs.
    The warm start's sidecar says epoch 0, so the run starts at epoch 1
    (as the JAX package's does) and its first epoch is frozen: the trunk
    equals the warm start after it (the best-val save at epoch 1) and
    differs after the second (save_dir/latest at epoch 2)."""
    root = tmp_path / "cityscapes"
    write_tree(root)
    base = ["--no_feat_encoding", "--no_label_encoding", "--use_compressed", "--ext", "jpg",
            "--quality", "50", "--no_vgg_loss", "--fused_instance_norm", str(int(fused))]
    g_dir, warm, l_dir = tmp_path / "global", tmp_path / "warm", tmp_path / "local"
    _quiet(lambda: run.main(train_argv(root, g_dir, "--num_epochs", "1", "--val_interval", "1",
                                       *base), device="cpu"))
    _quiet(lambda: warmstart.main(["--src", str(g_dir), "--dst", str(warm)]))
    local = base + ["--netG", "local", "--ngf", "4", "--n_blocks_local", "1",
                    "--niter_fix_global", "2", "--load_model", "--checkpoints_dir", str(warm)]
    trainer, text = _quiet(lambda: run.main(train_argv(
        root, l_dir, "--num_epochs", "2", "--val_interval", "2", "--latest_interval", "1",
        *local), device="cpu"))
    n = len([k for k in trainer.state if k.startswith("netG.global.")])
    assert trainer.start_epoch == 1 and trainer.steps_taken == 4
    assert f"restored params from {warm}: {n}/" in text
    assert text.count("now also finetuning global generator") == 1
    warm_p = torch.load(warm / PARAMS_FILE, weights_only=True)
    frozen = torch.load(l_dir / PARAMS_FILE, weights_only=True)
    trained = torch.load(l_dir / "latest" / PARAMS_FILE, weights_only=True)
    assert json.loads((l_dir / "trainer_meta.json").read_text())["epoch"] == 1
    assert json.loads((l_dir / "latest" / "trainer_meta.json").read_text())["epoch"] == 2
    trunk = [k for k in frozen if k.startswith("netG.global.")]
    assert len(trunk) == n and all(torch.equal(frozen[k], warm_p[k]) for k in trunk)
    assert all(not torch.equal(trained[k], warm_p[k]) for k in trunk if k.endswith("weight"))
