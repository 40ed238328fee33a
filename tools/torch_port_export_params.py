#!/usr/bin/env python
"""Export a JAX (Orbax) checkpoint for the PyTorch port: the whole training
state, so that ``python -m jpdse_tpu_torch.train --load_model
--checkpoints_dir D`` resumes the JAX run step for step, and evaluation
reads the generator's weights.

``D/params/`` and ``D/opt/`` are restored with
``jpdse_tpu.train.checkpoint.restore_checkpoint`` into a training-mode
``jpdse_tpu.trainer.Trainer``'s template, carried across with
``jpdse_tpu_torch.convert.from_jax_params`` and written in the format
``jpdse_tpu_torch/train/checkpoint.py`` reads:

* ``D/params_g.pt``, the codec's state dict;
* ``D/params_d.pt``, the discriminator's; under ``model.norm`` 'batch'
  each carries its batch norms' running statistics, the run's
  ``mstate_g`` / ``mstate_d`` (``jpdse_tpu/train/checkpoint.py:75-78``), as
  buffers beside the parameters;
* ``D/opt.pt``: both Adams (optax's ``mu`` / ``nu`` / ``count`` as
  ``torch.optim.Adam``'s ``exp_avg`` / ``exp_avg_sq`` / ``step``, in the
  port's layout and parameter order, the lr from optax's injected
  hyperparameter), the step count, the annealed distortion weight and the
  best validation loss. Optax's bias corrections read the count the next
  step increments, as torch's Adam reads ``step``: the export checks that
  each Adam's counts agree with the run's step count, and raises if not.

The replay pool is not in a JAX checkpoint (JAX resumes with an empty
pool), so none is written and the port's resume starts with an empty pool
too. The epoch and the lr scheduler are in ``D/trainer_meta.json``, which
both packages write alike and which stays as it is. A checkpoint whose
optimizer state does not fit the template (saved by a test-mode trainer)
exports fresh Adams, as the JAX package restores one. The port's machine
then needs neither JAX nor Orbax.

    python tools/torch_port_export_params.py --checkpoints_dir runs/x \\
        [--opt_file runs/x/opt.json]

This is the one tool on the JAX side of the port: it imports both packages.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _template_cfg(checkpoints_dir: str, opt_file: str = None):
    from jpdse_tpu.config import Config

    cfg = Config.load(opt_file or os.path.join(checkpoints_dir, "opt.json"))
    # the parameters do not depend on the image size: build the template small
    pp = cfg.data.preprocess
    pp.preprocess_mode, pp.crop_size, pp.aspect_ratio = "fixed", 128, 2.0
    cfg.data.batch_size = 1
    return cfg


def adam_state_dict(opt_state, port_module, cfg, groups=None) -> dict:
    """A ``torch.optim.Adam`` state dict for ``port_module``'s parameters
    from optax's ``inject_hyperparams(adam)`` state (``jpdse_tpu/train/
    state.py::make_optimizers``): its moments carried across by the weight
    bridge, in the order of ``port_module.parameters()``."""
    import numpy as np
    import torch

    from jpdse_tpu_torch.convert import from_jax_params
    from jpdse_tpu_torch.train.state import make_adam

    adam = opt_state.inner_state[0]  # ScaleByAdamState(count, mu, nu)
    count = int(np.asarray(adam.count))
    if int(np.asarray(opt_state.count)) != count:
        raise ValueError(f"optax counts differ: inject_hyperparams {int(opt_state.count)}, "
                         f"adam {count}")
    mu, nu = from_jax_params(adam.mu, groups), from_jax_params(adam.nu, groups)
    names = [n for n, _ in port_module.named_parameters()]
    if sorted(names) != sorted(mu):
        raise ValueError(f"the JAX moments' leaves {sorted(set(mu) ^ set(names))} do not "
                         "match the port's parameters")
    groups_ = make_adam(cfg, port_module.parameters()).state_dict()["param_groups"]
    groups_[0]["lr"] = float(np.asarray(opt_state.hyperparams["learning_rate"]))
    state = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
             for i, n in enumerate(names)}
    return {"state": state, "param_groups": groups_}


def export(checkpoints_dir: str, opt_file: str = None) -> list:
    """Write the port's files into ``checkpoints_dir``; returns their paths."""
    import numpy as np
    import torch

    from jpdse_tpu.train.checkpoint import restore_checkpoint
    from jpdse_tpu.trainer import Trainer
    from jpdse_tpu_torch.config import Config as PortConfig
    from jpdse_tpu_torch.convert import deconv_groups, from_jax_params
    from jpdse_tpu_torch.train.checkpoint import OPT_FILE, PARAMS_D_FILE, save_params

    cfg = _template_cfg(checkpoints_dir, opt_file)
    trainer = Trainer(cfg, mode="train")
    state, _ = restore_checkpoint(checkpoints_dir, trainer.state, restore_opt=True)
    groups = deconv_groups(cfg)
    paths = [save_params(checkpoints_dir,
                         from_jax_params(state.params_g, groups, state.mstate_g)),
             save_params(checkpoints_dir, from_jax_params(state.params_d, None, state.mstate_d),
                         PARAMS_D_FILE)]

    from jpdse_tpu_torch.models.codec import SemanticCodec
    from jpdse_tpu_torch.models.discriminator import build_discriminator

    port_cfg = PortConfig.from_dict(cfg.to_dict())
    steps = int(np.asarray(state.steps_taken))
    opts = {}
    for key, module, opt_state, grp in (
            ("opt_g", SemanticCodec(port_cfg, device="meta", seed=None), state.opt_state_g,
             groups),
            ("opt_d", build_discriminator(port_cfg, "meta", None), state.opt_state_d, None)):
        opts[key] = adam_state_dict(opt_state, module, port_cfg, grp)
        count = int(opts[key]["state"][0]["step"]) if opts[key]["state"] else steps
        if count != steps:
            raise ValueError(f"{key}: Adam's count {count} is not the run's {steps} steps, so "
                             "the bias corrections would not agree")
    opt = dict(opts, steps_taken=steps,
               lambda_distortion_weight=float(np.asarray(state.lambda_distortion_weight)),
               best_val_loss=float(np.asarray(state.best_val_loss)))
    path = os.path.join(checkpoints_dir, OPT_FILE)
    torch.save(opt, path)
    paths.append(path)
    return paths


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoints_dir", required=True,
                    help="a JAX checkpoint directory (params/, opt/, trainer_meta.json)")
    ap.add_argument("--opt_file", default=None,
                    help="the run's opt.json (default: CHECKPOINTS_DIR/opt.json)")
    args = ap.parse_args(argv)
    from jpdse_tpu.platform import honor_jax_platforms_env

    honor_jax_platforms_env()
    for path in export(args.checkpoints_dir, args.opt_file):
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
