#!/usr/bin/env python
"""Export a JAX (Orbax) checkpoint's generator parameters for the PyTorch
port: restore ``D/params`` with ``jpdse_tpu.train.checkpoint
.restore_checkpoint`` into a test-mode ``jpdse_tpu.trainer.Trainer``'s
template, carry the parameters across with
``jpdse_tpu_torch.convert.from_jax_params`` and write ``D/params_g.pt``, the
file ``jpdse_tpu_torch``'s ``Trainer.load`` reads. The port's machine then
needs neither JAX nor Orbax.

    python tools/torch_port_export_params.py --checkpoints_dir runs/x \\
        [--opt_file runs/x/opt.json]

This is the one tool on the JAX side of the port: it imports both packages.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(checkpoints_dir: str, opt_file: str = None) -> str:
    """Write ``checkpoints_dir/params_g.pt``; returns its path."""
    from jpdse_tpu.config import Config, derive_eval_config
    from jpdse_tpu.train.checkpoint import restore_checkpoint
    from jpdse_tpu.trainer import Trainer
    from jpdse_tpu_torch.convert import deconv_groups, from_jax_params
    from jpdse_tpu_torch.train.checkpoint import save_params

    cfg = derive_eval_config(Config.load(opt_file or os.path.join(checkpoints_dir, "opt.json")),
                             mode="test")
    # the parameters do not depend on the image size: build the template small
    pp = cfg.data.preprocess
    pp.preprocess_mode, pp.crop_size, pp.aspect_ratio = "fixed", 128, 2.0
    trainer = Trainer(cfg, mode="test")
    state, _ = restore_checkpoint(checkpoints_dir, trainer.state, restore_opt=False)
    return save_params(checkpoints_dir, from_jax_params(state.params_g, deconv_groups(cfg)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoints_dir", required=True,
                    help="a JAX checkpoint directory (params/, trainer_meta.json)")
    ap.add_argument("--opt_file", default=None,
                    help="the run's opt.json (default: CHECKPOINTS_DIR/opt.json)")
    args = ap.parse_args(argv)
    from jpdse_tpu.platform import honor_jax_platforms_env

    honor_jax_platforms_env()
    print(f"wrote {export(args.checkpoints_dir, args.opt_file)}")


if __name__ == "__main__":
    main()
