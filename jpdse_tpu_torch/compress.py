"""Deploy-time encoder, the twin of the repository's ``compress.py``: a
dataset -> one ``.jpds`` stream per image in ``save_dir``, and
``compress_summary.json`` with the average bits per pixel of the files.

    python -m jpdse_tpu_torch.compress --load_opt --opt_file runs/x/opt.json \\
        --checkpoints_dir runs/x --save_dir out/bits --root_dir /data/cityscapes

Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from jpdse_tpu_torch.cli import parse_config, print_config
from jpdse_tpu_torch.config import derive_eval_config
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.platform import resolve_device
from jpdse_tpu_torch.trainer import Trainer


def main(argv: Optional[List[str]] = None, device="cuda") -> dict:
    device = resolve_device(device)
    cfg = parse_config(argv, is_train=False)
    eval_mode = cfg.mode if cfg.mode in ("val", "test") else "test"
    cfg = derive_eval_config(cfg, mode=eval_mode)
    print("\ncompress options:\n")
    print_config(cfg)

    loader = create_dataloader(cfg)
    trainer = Trainer(cfg, mode="test", device=device)
    trainer.load()

    os.makedirs(cfg.save_dir, exist_ok=True)
    total_bits, total_pixels, n = 0, 0, 0
    for batch in loader:
        streams = trainer.compress(batch)
        h, w = batch["image"].shape[1:3]
        for j, stream in enumerate(streams):
            base = os.path.splitext(os.path.basename(batch["path"][j]))[0]
            path = os.path.join(cfg.save_dir, base + ".jpds")
            with open(path, "wb") as f:
                f.write(stream)
            total_bits += len(stream) * 8
            total_pixels += h * w
            n += 1
            print(f"{path}: {len(stream)} bytes ({len(stream) * 8 / (h * w):.4f} bpp)")
    summary = {"n_images": n, "avg_bpp": total_bits / max(total_pixels, 1)}
    with open(os.path.join(cfg.save_dir, "compress_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"\ncompressed {n} images, avg {summary['avg_bpp']:.4f} bpp")
    return summary


if __name__ == "__main__":
    main()
