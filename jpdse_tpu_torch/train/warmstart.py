"""Re-nest a trained GlobalGenerator checkpoint for a LocalEnhancer's warm
start, the twin of ``tools/warmstart_local_from_global.py`` on the port's
checkpoints.

The high-resolution recipe trains the global generator first, then wraps
it in a local enhancer (``--netG local``) at 2048x1024 with the global trunk
frozen for ``--niter_fix_global`` epochs. The enhancer nests its trunk as
``netG.global`` and has no global tail, so the checkpoint's ``netG.*``
(minus ``netG.tail``) moves to ``netG.global.*``; netE and netE4label come
across as they are; the discriminator is dropped (the enhancer trains a
fresh one at the new resolution). The result is a params-only checkpoint
(no ``params_d.pt``, no ``opt.pt``: fresh Adams) with ``trainer_meta.json``
``{"epoch": 0, "warmstart_from": src}``, which ``--load_model
--checkpoints_dir DST`` merges by name and shape
(``train/checkpoint.py::merge_state``). The local model takes ngf = the
source's ngf / 2^n_local_enhancers (a trained ``--ngf 64`` global starts
a ``--netG local --ngf 32`` model). Under ``model.norm`` 'batch' the
batch norms' running statistics stay behind, as the JAX tool carries the
params collection alone (no ``mstate_g``): the enhancer's statistics start
fresh (mean 0, variance 1), its scales and biases warm.

    python -m jpdse_tpu_torch.train.warmstart --src RUN --dst INIT
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import torch

from jpdse_tpu_torch.convert import is_stat
from jpdse_tpu_torch.train.checkpoint import META_FILE, PARAMS_FILE, save_params


def renest(params: dict) -> dict:
    """A GlobalGenerator codec's state dict re-nested for a LocalEnhancer:
    ``netG.X`` -> ``netG.global.X`` (``netG.tail.*`` dropped), every other
    network's entries unchanged; the batch norms' running statistics
    dropped (the JAX tool's params-only checkpoint)."""
    if any(k.startswith("netG.global.") for k in params):
        raise ValueError("the source is already a LocalEnhancer checkpoint")
    if not any(k.startswith("netG.") for k in params):
        raise ValueError("the source has no netG")
    out = {}
    for k, v in params.items():
        if is_stat(k):
            continue
        if k.startswith("netG."):
            if k.startswith("netG.tail."):
                continue
            k = "netG.global." + k[len("netG."):]
        out[k] = v
    return out


def warmstart(src: str, dst: str) -> str:
    """Write the warm-start checkpoint of ``src``'s ``params_g.pt`` into
    ``dst``; returns the path of its ``params_g.pt``."""
    params = torch.load(os.path.join(src, PARAMS_FILE), map_location="cpu", weights_only=True)
    out = renest(params)
    path = save_params(dst, out)
    with open(os.path.join(dst, META_FILE), "w") as f:
        json.dump({"epoch": 0, "warmstart_from": src}, f)
    print(f"wrote {path}: {len(out)} leaves; moved netG.* -> netG.global.*; dropped: netG.tail, "
          "params_d (a fresh discriminator at the new resolution)")
    return path


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="trained checkpoint dir (has params_g.pt)")
    ap.add_argument("--dst", required=True, help="output warm-start checkpoint dir")
    args = ap.parse_args(argv)
    return warmstart(args.src, args.dst)


if __name__ == "__main__":
    main()
