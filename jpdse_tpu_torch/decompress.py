"""Deploy-time decoder, the twin of the repository's ``decompress.py``:
``.jpds`` streams -> PNGs in ``save_dir``, from the streams and the
checkpoint alone (no access to the original images or labels).

    python -m jpdse_tpu_torch.decompress --input out/bits --load_opt \\
        --opt_file runs/x/opt.json --checkpoints_dir runs/x --save_dir out/recon

``--input`` is a ``.jpds`` file or a directory of them; every other flag is
the config's. Under a process group every rank decodes the same streams and
rank 0 writes. Runs on the card; ``main(argv, device="cpu")`` runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

import numpy as np
from PIL import Image

from jpdse_tpu_torch.cli import parse_config
from jpdse_tpu_torch.config import derive_eval_config
from jpdse_tpu_torch.parallel import distributed
from jpdse_tpu_torch.platform import init_distributed, resolve_device
from jpdse_tpu_torch.trainer import Trainer
from jpdse_tpu_torch.utils.misc import tensor2im


def main(argv: Optional[List[str]] = None, device="cuda") -> List[str]:
    """Returns the paths of the PNGs written (by rank 0)."""
    init_distributed(device)
    device = resolve_device(device)
    write = distributed.is_main()
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--input", required=True, help=".jpds file or directory")
    own, rest = ap.parse_known_args(argv)

    cfg = parse_config(rest, is_train=False)
    cfg = derive_eval_config(cfg, mode="test")
    trainer = Trainer(cfg, mode="test", device=device)
    trainer.load()

    paths = (
        sorted(glob.glob(os.path.join(own.input, "*.jpds")))
        if os.path.isdir(own.input)
        else [own.input]
    )
    if not paths:
        raise SystemExit(f"no .jpds files under {own.input}")
    if write:
        os.makedirs(cfg.save_dir, exist_ok=True)
    written = []
    for p in paths:
        with open(p, "rb") as f:
            img = trainer.decompress(f.read())
        u8 = tensor2im(img, cfg.data.normalize_mean, cfg.data.normalize_std)
        out = os.path.join(cfg.save_dir, os.path.splitext(os.path.basename(p))[0] + ".png")
        if write:
            Image.fromarray(np.asarray(u8, np.uint8)).save(out)
            print(f"{p} -> {out}")
            written.append(out)
    distributed.barrier()
    return written


if __name__ == "__main__":
    main()
