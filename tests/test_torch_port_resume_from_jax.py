"""A JAX training run resumed by the port: ``tools/torch_port_export_params.py``
carries a JAX (Orbax) checkpoint's whole training state into the port's
``params_g.pt`` / ``params_d.pt`` / ``opt.pt``, and the port's
``Trainer.load`` resumes it.

The JAX package's ``Trainer`` trains the tiny flagship's phase-3 recipe
(``test_torch_port_train_step.py``'s: distortion only, no VGG, D stepped
on zero gradients, the lr on a plateau schedule) from that file's weights
and batch for one step, saves, and takes a second step. Both packages' stochastic sign is the deterministic
one, as in that file. The export is held bit for bit against JAX's state
after the first step (parameters, both Adams' moments, their count as
torch's ``step``, the lr, the counters, the epoch). The port then takes the
second step from the restored state: its metrics and gradients against
JAX's second step by that file's rule (metrics 1e-4 relative, each
gradient tensor 1e-4 of its max-abs, a bias an InstanceNorm follows 0 to
rounding), JAX's gradients recovered from its Adam moments
(g = (mu2 - b1 mu1) / (1 - b1)). Then both Adams step on the port's
gradients, the port's from its carried state and optax's from JAX's state
after the first step: parameters within 1e-7 (the Adam rule of
``test_torch_port_train_parts.py``), the first moments within 1e-7 of
their max-abs and the second within 2e-5 (optax rounds 1 - b2 to fp32);
the bias corrections read the carried count, and an Adam one step off
misses by orders more.
"""

import importlib.util
import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

import jpdse_tpu.ops.quantizers as jq
from jpdse_tpu.train.state import make_optimizers
from jpdse_tpu.trainer import Trainer as JaxTrainer
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import deconv_groups, from_jax_params, to_jax_params
from jpdse_tpu_torch.ops import quantizers
from jpdse_tpu_torch.train import step
from jpdse_tpu_torch.trainer import Trainer
from test_torch_port_parallel import NORMED_BIAS
from test_torch_port_threads import port_test_threads  # noqa: F401
from test_torch_port_train_step import RTOL, jax_config, recipe_weights

REPO = Path(__file__).resolve().parents[1]
ADAM_TOL = 1e-7
# optax weighs g**2 by 1 - b2 rounded to fp32 (9.99987e-4 for b2 0.999), torch by
# 1 - b2 in float64: the second moments part by up to 1.3e-5 of the new term
NU_TOL = 2e-5


def _det_sign(x, key):
    return jq.deterministic_sign_ste(x)


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _adam(opt_state):
    return opt_state.inner_state[0]  # ScaleByAdamState(count, mu, nu)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's run: one step, the checkpoint, the second step; the export."""
    run = tmp_path_factory.mktemp("jax_run")
    cfg = jax_config("phase3", False)
    cfg.save_dir = str(run)
    weights = recipe_weights("phase3")
    batch = weights["batch"]
    with pytest.MonkeyPatch.context() as mp, redirect_stdout(io.StringIO()):
        mp.setattr(jq, "stochastic_sign_ste", _det_sign)
        jt = JaxTrainer(cfg, mode="train")
        # the weights test_torch_port_train_step.py steps phase 3 from
        jt.state = jt.state.replace(
            params_g=jax.tree_util.tree_map(jnp.asarray, weights["g"]),
            params_d=jax.tree_util.tree_map(jnp.asarray, weights["d"]))
        jt.step(batch)
        cfg.save(str(run / "opt.json"))
        jt.save(epoch=0, val_loss=7.5)
        first = _host(jt.state)
        second_metrics = jt.step(batch)
        second = _host(jt.state)
        spec = importlib.util.spec_from_file_location(
            "torch_port_export_params", REPO / "tools/torch_port_export_params.py")
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        written = tool.export(str(run))
    return {"cfg": cfg, "run": run, "batch": batch, "first": first, "second": second,
            "second_metrics": second_metrics, "written": written}


@pytest.fixture(scope="module")
def resumed(jax_run):
    """The port's Trainer restored from the export, as ``--load_model`` does."""
    cfg = Config.from_dict(jax_run["cfg"].to_dict())
    cfg.checkpoints_dir = str(jax_run["run"])
    with redirect_stdout(io.StringIO()) as log:
        trainer = Trainer(cfg, mode="train", device="cpu")
        trainer.load()
    return trainer, log.getvalue()


def test_export_carries_the_whole_state_bit_for_bit(jax_run, resumed):
    trainer, log = resumed
    first, cfg = jax_run["first"], jax_run["cfg"]
    assert sorted(Path(p).name for p in jax_run["written"]) == ["opt.pt", "params_d.pt",
                                                                 "params_g.pt"]
    assert "matched" in log and "optimizer state not restored" not in log
    assert trainer.start_epoch == 1 and trainer.steps_taken == 1
    gan = trainer.gan
    assert gan.best_val_loss == pytest.approx(7.5) and gan.lambda_distortion_weight == 1.0
    groups = deconv_groups(cfg)
    for module, params, opt_state, opt, grp in (
            (gan.codec, first.params_g, first.opt_state_g, gan.opt_g, groups),
            (gan.disc, first.params_d, first.opt_state_d, gan.opt_d, None)):
        want = from_jax_params(params, grp)
        assert all(torch.equal(module.state_dict()[k], want[k]) for k in want)
        adam = _adam(opt_state)
        mu, nu = from_jax_params(adam.mu, grp), from_jax_params(adam.nu, grp)
        names = [n for n, _ in module.named_parameters()]
        for name, p in zip(names, module.parameters()):
            st = opt.state[p]
            assert st["step"].item() == int(adam.count) == 1
            assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])
        assert opt.param_groups[0]["lr"] == pytest.approx(
            float(opt_state.hyperparams["learning_rate"]), rel=1e-7)


def _jax_grads(jax_run, b1: float):
    """JAX's second-step gradients from its Adam's first moments, in the
    port's names and layout."""
    first, second, cfg = jax_run["first"], jax_run["second"], jax_run["cfg"]
    out = []
    for key, grp in (("opt_state_g", deconv_groups(cfg)), ("opt_state_d", None)):
        mu1, mu2 = _adam(getattr(first, key)).mu, _adam(getattr(second, key)).mu
        g = jax.tree_util.tree_map(lambda a, b: (b - b1 * a) / (1 - b1), mu1, mu2)
        out.append(from_jax_params(g, grp))
    return out


def test_the_resumed_second_step_matches_jax(jax_run, resumed, monkeypatch):
    trainer, _ = resumed
    gan, cfg = trainer.gan, jax_run["cfg"]
    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    metrics, grads = step.loss_and_grads(gan, trainer.place(jax_run["batch"]),
                                         torch.Generator().manual_seed(0))
    for k in step.METRICS:
        np.testing.assert_allclose(metrics[k].item(), jax_run["second_metrics"][k], rtol=RTOL,
                                   atol=0, err_msg=k)
    want = _jax_grads(jax_run, cfg.optim.beta1)
    for module, got, ref in ((gan.codec, grads[0], want[0]), (gan.disc, grads[1], want[1])):
        named = dict(zip((n for n, _ in module.named_parameters()), got))
        top = max(g.abs().max().item() for g in named.values())
        for n, r in ref.items():
            g = named[n]
            if NORMED_BIAS.search(n):
                assert max(g.abs().max().item(), r.abs().max().item()) <= 1e-5 * max(top, 1e-30)
                continue
            err = (g - r).abs().max().item()
            assert err <= RTOL * r.abs().max().item(), f"{n}: {err} of {r.abs().max().item()}"

    # the carried Adams, stepped on the same gradients, land where optax does from JAX's state
    first, groups = jax_run["first"], deconv_groups(cfg)
    opt_g, opt_d = make_optimizers(cfg)
    want_state = []
    for module, g, params, opt_state, tx, grp in (
            (gan.codec, grads[0], first.params_g, first.opt_state_g, opt_g, groups),
            (gan.disc, grads[1], first.params_d, first.opt_state_d, opt_d, None)):
        tree = to_jax_params(dict(zip((n for n, _ in module.named_parameters()), g)), grp)
        updates, new_state = tx.update(tree, opt_state, params)
        want_state.append((optax.apply_updates(params, updates), new_state, grp))
    step.apply(gan, grads)
    for (module, opt), (params, opt_state, grp) in zip(
            ((gan.codec, gan.opt_g), (gan.disc, gan.opt_d)), want_state):
        want_p = from_jax_params(params, grp)
        adam = _adam(opt_state)
        mu, nu = from_jax_params(adam.mu, grp), from_jax_params(adam.nu, grp)
        for n, p in module.named_parameters():
            assert (p.detach() - want_p[n]).abs().max().item() <= ADAM_TOL, n
            st = opt.state[p]
            assert st["step"].item() == int(adam.count) == 2
            for got_m, want_m, tol in ((st["exp_avg"], mu[n], ADAM_TOL),
                                       (st["exp_avg_sq"], nu[n], NU_TOL)):
                assert (got_m - want_m).abs().max().item() <= tol * max(
                    want_m.abs().max().item(), 1e-30), n
