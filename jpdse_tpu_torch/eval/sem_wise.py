"""Per-class distortion of a checkpoint over a split, the twin of the
repository's ``tools/sem_wise_eval.py`` (the reference's
``get_sem_wise_distortion`` diagnostic): for each semantic class, the L1
between the real and the reconstructed image on denormalized uint8 pixels,
summed over the channels and averaged over the class's pixels of the whole
split, beside the class's share of those pixels. It asks where a model's
rate goes: what the semantics buy should show class by class (boundaries,
thin structures, rare classes), not only in the global PSNR.

    python -m jpdse_tpu_torch.eval.sem_wise --opt_file RUN/opt.json \\
        --checkpoints_dir RUN --root_dir DATA --mode val --out RUN/sem_wise.json

The label map serves the analysis only, so a model trained without
semantics is scored the same way: the loader is made to read label and
instance maps on a copy of the config, while the ``Trainer`` keeps the
architecture as trained. The reconstruction is whatever path the opt file
selects (the s2d fast path under ``fast_inference``, the standard path,
K3 under ``fused_instance_norm``). ``--checkpoints_dir`` holds the port's
``params_g.pt`` or the reference's ``net_*.pth`` (``Trainer.load``). The
per-class sums are taken in float64 on the device; integer differences
make them exact in any order.

Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
from typing import List, Optional

import numpy as np
import torch

from jpdse_tpu_torch.config import Config, derive_eval_config
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.ops.metrics import denormalize_to_uint8
from jpdse_tpu_torch.platform import resolve_device
from jpdse_tpu_torch.trainer import Trainer

CITYSCAPES_NAMES = [
    "unlabeled", "ego vehicle", "rectification border", "out of roi",
    "static", "dynamic", "ground", "road", "sidewalk", "parking",
    "rail track", "building", "wall", "fence", "guard rail", "bridge",
    "tunnel", "pole", "polegroup", "traffic light", "traffic sign",
    "vegetation", "terrain", "sky", "person", "rider", "car", "truck",
    "bus", "caravan", "trailer", "train", "motorcycle", "bicycle",
    "license plate",
]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--opt_file", required=True)
    ap.add_argument("--checkpoints_dir", required=True)
    ap.add_argument("--root_dir", default="datasets/cityscapes_split")
    ap.add_argument("--mode", default="val")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quality", type=int, default=None,
                    help="override the base codec's quality (a decoder trained at one "
                         "quality fed another's payloads)")
    return ap.parse_args(argv)


def class_sums(label: torch.Tensor, real_u8: torch.Tensor, fake_u8: torch.Tensor,
               num_classes: int):
    """(per-class summed |real - fake| over channels, per-class pixel
    counts), float64 (L,) each, of uint8-valued images (B, H, W, 3) and a
    label map (B, H, W) whose ids are clipped into [0, L)."""
    lab = label.to(torch.int64).clamp(0, num_classes - 1).reshape(-1)
    diff = (real_u8.double() - fake_u8.double()).abs().sum(-1).reshape(-1)
    return (torch.bincount(lab, weights=diff, minlength=num_classes),
            torch.bincount(lab, minlength=num_classes).double())


def summarize(num: np.ndarray, den: np.ndarray, n_images: int) -> dict:
    """The JSON of the tool: the overall per-pixel L1 and one row per class
    present (``class_id``, ``name``, ``l1_uint8``, ``pixel_share``)."""
    per_class = np.where(den > 0, num / np.maximum(den, 1.0), 0.0)
    total_px = den.sum()
    rows = []
    for i in np.flatnonzero(den > 0):
        rows.append({
            "class_id": int(i),
            "name": CITYSCAPES_NAMES[i] if i < len(CITYSCAPES_NAMES) else str(i),
            "l1_uint8": float(per_class[i]),
            "pixel_share": float(den[i] / total_px),
        })
    return {"n_images": n_images, "overall_l1_uint8": float(num.sum() / total_px),
            "per_class": rows}


def main(argv: Optional[List[str]] = None, device="cuda",
         recons: Optional[list] = None) -> dict:
    """Score the split; returns the JSON it writes to ``--out``. With a
    list as ``recons``, each batch's (label ids, real image, reconstruction),
    normalized float32 numpy arrays as the loader and the codec give them,
    is appended to it."""
    device = resolve_device(device)
    args = parse_args(argv)
    cfg = Config.load(args.opt_file)
    cfg.checkpoints_dir = args.checkpoints_dir
    cfg.data.root_dir = args.root_dir
    cfg.save_dir = ""
    if args.quality is not None:
        cfg.codec.quality = (args.quality,)
    cfg = derive_eval_config(cfg, mode="val" if args.mode == "val" else "test")
    cfg.mode = args.mode
    loader_cfg = copy.deepcopy(cfg)
    loader_cfg.model.no_label = False
    loader_cfg.model.no_instance = False
    loader = create_dataloader(loader_cfg)
    trainer = Trainer(cfg, mode="test", device=device)
    trainer.load()

    n_labels = cfg.data.semantic_nc
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    num = torch.zeros(n_labels, dtype=torch.float64, device=device)
    den = torch.zeros(n_labels, dtype=torch.float64, device=device)
    n_images = 0
    for batch in loader:
        placed = trainer.place(batch)
        recon = trainer.get_img(placed)
        s, c = class_sums(placed["label"], denormalize_to_uint8(placed["image"], mean, std),
                          denormalize_to_uint8(recon, mean, std), n_labels)
        num += s
        den += c
        n_images += recon.shape[0]
        if recons is not None:
            recons.append((np.asarray(batch["label"]), np.asarray(batch["image"]),
                           recon.cpu().numpy()))
    result = summarize(num.cpu().numpy(), den.cpu().numpy(), n_images)
    print(f"{n_images} images; overall per-pixel L1 {result['overall_l1_uint8']:.3f}")
    for r in sorted(result["per_class"], key=lambda r: -r["pixel_share"])[:12]:
        print(f"  {r['name']:<20} share {r['pixel_share']:.3f}  L1 {r['l1_uint8']:.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
