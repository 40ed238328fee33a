"""Training the generator-input assemblies in the PyTorch port against the
JAX package at the tiny flagship config (64x128, batch 2, fp32 on the CPU):
one GAN step of phase 2's recipe with ``zero_sem``, with ``use_netE_output``
(D sees netE's output; netG gets gradients of 0 and Adam steps it as optax
does) and with the generator's bottleneck binarized instead of the
encoders, each against JAX's ``make_train_step`` as
tests/test_torch_port_train_step.py holds phases 1-3; and the restore from
phase 1 into phase 2 (netG's head widens, netE is new), whose matched-leaf
count equals that of JAX's ``merge_trees`` on the same trees.
"""

import io
import re
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from jpdse_tpu.train.checkpoint import merge_trees
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.train import step
from jpdse_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from test_torch_port_train_step import port_state, recipe_weights, run_steps
from test_torch_port_threads import port_test_threads  # noqa: F401


@pytest.mark.parametrize("recipe", ["zero_sem", "use_netE_output", "g_binarized"])
def test_one_train_step_matches_jax(recipe, monkeypatch):
    metrics, state = run_steps(recipe, False, 1, monkeypatch)
    if recipe == "use_netE_output":
        # netG is not run: its gradients are 0, and Adam's first step leaves it
        before = from_jax_params(recipe_weights(recipe)["g"])
        for name, p in state.codec.netG.named_parameters():
            assert torch.equal(p.detach(), before[f"netG.{name}"]), name
        assert all(s["step"].item() == 1 and not s["exp_avg"].any()
                   for p, s in state.opt_g.state.items()
                   if any(p is q for q in state.codec.netG.parameters()))
    if recipe == "g_binarized":
        assert state.codec.netG.binarizer is not None and state.codec.netE.binarizer is None
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_phase1_to_phase2_restore_counts_as_jax(tmp_path):
    """A phase-1 checkpoint restored into a phase-2 state: each tensor of the
    same name and shape is taken (netE4label, netG but its head's kernel, D);
    netG's head kernel (8 -> 11 input channels here, 36 -> 39 at the
    flagship's widths) and netE stay fresh, the Adams fall back fresh, and
    the printed count k/n equals JAX's merge_trees over both players'
    trees."""
    w1, w2 = recipe_weights("phase1"), recipe_weights("phase2")
    s1 = port_state("phase1", False, w1)
    s1.steps_taken = 7
    save_checkpoint(str(tmp_path), s1, epoch=3)
    s2 = port_state("phase2", False, w2)
    fresh = {k: v.clone() for k, v in s2.codec.state_dict().items()}
    with redirect_stdout(io.StringIO()) as out:
        restore_checkpoint(str(tmp_path), s2)
    got = re.search(r"restored params from .*: (\d+)/(\d+) leaves matched", out.getvalue())
    assert "optimizer state not restored (shapes differ)" in out.getvalue()
    assert s2.steps_taken == 0

    counter = [0]
    merge_trees({"params_g": w2["g"], "params_d": w2["d"]},
                {"params_g": w1["g"], "params_d": w1["d"]}, counter)
    n_total = len(jax.tree_util.tree_leaves({"params_g": w2["g"], "params_d": w2["d"]}))
    assert (int(got[1]), int(got[2])) == (counter[0], n_total)
    assert counter[0] < n_total

    saved, now = s1.codec.state_dict(), s2.codec.state_dict()
    for k, v in now.items():
        taken = k in saved and saved[k].shape == v.shape
        assert torch.equal(v, saved[k] if taken else fresh[k]), k
        assert taken == (not k.startswith("netE.") and k != "netG.head.conv.conv.weight"), k
    metrics, _ = step.loss_and_grads(
        s2, {k: torch.from_numpy(v) for k, v in w2["batch"].items()}, torch.Generator())
    assert all(np.isfinite(float(v)) for v in metrics.values())
