"""Evaluation entry point, the twin of the repository's ``test.py``: rate
of the binary codes (Shannon estimate, raw length, range-coded bytes), the
reconstruction gallery, code dumps under ``codes/``, and L1 / MSE / MS-SSIM
/ PSNR on denormalized uint8 images, written to ``save_dir/metrics.json``.

    python -m jpdse_tpu_torch.test --load_opt --opt_file runs/x/opt.json \\
        --checkpoints_dir runs/x --save_dir out/x --root_dir /data/cityscapes

Under a process group every rank evaluates the same unsharded set and
rank 0 writes. Runs on the card; ``main(argv, device="cpu")`` runs it on
the CPU.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from jpdse_tpu_torch.cli import parse_config, print_config
from jpdse_tpu_torch.config import derive_eval_config
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.eval.harness import evaluate
from jpdse_tpu_torch.parallel import distributed
from jpdse_tpu_torch.platform import init_distributed, resolve_device
from jpdse_tpu_torch.trainer import Trainer
from jpdse_tpu_torch.utils.visualizer import HTMLGallery, Visualizer


def main(argv: Optional[List[str]] = None, device="cuda") -> dict:
    init_distributed(device)
    device = resolve_device(device)
    write = distributed.is_main()
    cfg = parse_config(argv, is_train=False)
    # evaluate the split asked for (--mode val), else the test split
    eval_mode = cfg.mode if cfg.mode in ("val", "test") else "test"
    cfg = derive_eval_config(cfg, mode=eval_mode)
    print("\ntest options:\n")
    print_config(cfg)

    loader = create_dataloader(cfg)
    trainer = Trainer(cfg, mode="test", device=device)
    trainer.load()

    visualizer = Visualizer(cfg)
    gallery = (HTMLGallery(os.path.join(cfg.save_dir, "test_visualizations"), "visualizations")
               if write else None)
    avgs = evaluate(cfg, trainer, loader, visualizer, gallery, write=write)

    print("\ntest done!\n")
    msg = (
        "test set avg recon loss (L1/MSE/MS-SSIM/PSNR) "
        f"{avgs['L1']:.4f}/{avgs['MSE']:.4f}/{avgs['MS-SSIM']:.4f}/{avgs['PSNR']:.2f}dB"
    )
    if not cfg.do_not_get_codes and cfg.has_binary_codes:
        msg += (
            f", avg pre-/(estimated) post-entropy coding bpp "
            f"{avgs['actual_bpp']:.4f}/{avgs['shannon_bpp']:.4f}"
        )
        if avgs.get("coded_bpp") is not None:
            msg += f", actual entropy-coded bpp {avgs['coded_bpp']:.4f}"
    if avgs.get("total_bpp") is not None:
        msg += f", total bpp {avgs['total_bpp']:.4f}"
    else:
        msg += ", total bpp not measured (codes skipped)"
    print(msg)
    if cfg.save_dir and write:
        with open(os.path.join(cfg.save_dir, "metrics.json"), "w") as f:
            json.dump(avgs, f, indent=2)
    distributed.barrier()
    return avgs


if __name__ == "__main__":
    main()
