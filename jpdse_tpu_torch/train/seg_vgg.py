"""A perceptual-loss trunk trained on segmentation labels, the twin of the
repository's ``tools/train_seg_vgg.py``. The pretrained VGG19 of the
reference's VGGLoss cannot be fetched here, so this trains the same
``Vgg19Features`` trunk (``models/vgg.py``) to predict the split's
Cityscapes label maps from its images, and writes the trunk as the
``conv{s}_{c}.kernel`` (HWIO) / ``.bias`` ``.npz`` that
``--vgg_weights_path`` reads, in either package.

Supervision: 1x1 conv heads on the relu3_1, relu4_1 and relu5_1 slices
(deep supervision, so every slice the VGGLoss weights is trained), each a
pixel-mean cross-entropy against the labels taken every ``f``-th pixel
(``f`` the crop over the head's height), the three averaged. Inputs are in
the trainer's image space, ``/255 - 0.5``. Each step takes ``--batch``
random crops with a random horizontal flip, drawn from an explicit
generator on the device and gathered from the split, which is resident
there. Adam with optax's defaults.

    python -m jpdse_tpu_torch.train.seg_vgg --root DATA --out OUT [--steps 500]

Runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch import nn

from jpdse_tpu_torch.models.layers import conv_nhwc
from jpdse_tpu_torch.models.vgg import Vgg19Features, conv_names
from jpdse_tpu_torch.platform import resolve_device

HEADS = (2, 3, 4)  # relu3_1 (1/4), relu4_1 (1/8), relu5_1 (1/16)
HEAD_CHANNELS = {2: 256, 3: 512, 4: 512}


def load_split(root: str, mode: str, size=(1024, 512), num_labels: int = 35
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The split's images, bicubic to ``size`` (W, H) in the trainer's space
    (N, H, W, 3) float32, and their ``_labelIds`` maps, nearest to ``size``
    and clipped to ``num_labels - 1`` (N, H, W) int32."""
    imgs, labs = [], []
    for p in sorted(glob.glob(os.path.join(root, "leftImg8bit", mode, "*", "*.png"))):
        img = Image.open(p).convert("RGB").resize(size, Image.BICUBIC)
        city_parts = os.path.basename(p).split("_")[:3]
        lp = sorted(glob.glob(os.path.join(root, "gtFine", mode, "*",
                                           "_".join(city_parts) + "*_labelIds.png")))
        if not lp:
            raise FileNotFoundError(f"no label for {p}")
        lab = Image.open(lp[0]).resize(size, Image.NEAREST)
        imgs.append(np.asarray(img, np.float32) / 255.0 - 0.5)
        labs.append(np.clip(np.asarray(lab, np.int32), 0, num_labels - 1))
    return np.stack(imgs), np.stack(labs)


class SegVgg(nn.Module):
    """The trunk and the segmentation heads (scaffolding for the
    supervision; only the trunk is exported). NHWC in and out: the five
    slices and the three heads' logits."""

    def __init__(self, num_labels: int = 35):
        super().__init__()
        self.trunk = Vgg19Features()
        for k in HEADS:
            self.add_module(f"seg_head{k}", nn.Conv2d(HEAD_CHANNELS[k], num_labels, 1))

    def forward(self, x) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        feats = self.trunk(x)
        logits = []
        for k in HEADS:
            head = getattr(self, f"seg_head{k}")
            logits.append(conv_nhwc(feats[k], head.weight, head.bias))
        return feats, logits


def init_seg_vgg(num_labels: int, device, generator: torch.Generator) -> SegVgg:
    """A SegVgg on ``device`` drawn from ``generator``: every conv kernel
    normal with variance 1 / fan_in (the scale of Flax's default init,
    untruncated, as ``models/vgg.py::init_vgg19`` draws the trunk), biases 0."""
    with torch.device("meta"):
        model = SegVgg(num_labels)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for conv in model.modules():
            if isinstance(conv, nn.Conv2d):
                conv.weight.normal_(0.0, 1.0, generator=generator)
                conv.weight.mul_(conv.weight[0].numel() ** -0.5)
                conv.bias.zero_()
    return model


def seg_loss(logits: Sequence[torch.Tensor], y: torch.Tensor) -> torch.Tensor:
    """The mean over the heads of each head's pixel-mean cross-entropy
    against ``y`` (B, H, W) taken every ``H // h``-th pixel."""
    total = 0.0
    for lg in logits:
        f = y.shape[1] // lg.shape[1]
        total = total + F.cross_entropy(lg.permute(0, 3, 1, 2), y[:, ::f, ::f].long())
    return total / len(logits)


def draw_crops(generator: torch.Generator, n: int, h: int, w: int, crop: int, batch: int):
    """One step's draws on the generator's device: (image index, crop top,
    crop left, horizontal flip), each (batch,)."""
    dev = generator.device
    idx = torch.randint(0, n, (batch,), generator=generator, device=dev)
    y0 = torch.randint(0, h - crop + 1, (batch,), generator=generator, device=dev)
    x0 = torch.randint(0, w - crop + 1, (batch,), generator=generator, device=dev)
    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    return idx, y0, x0, flip


def gather_crops(imgs: torch.Tensor, labs: torch.Tensor, idx, y0, x0, flip, crop: int):
    """The crops the draws name, gathered where the split lives: images
    (B, crop, crop, 3) and labels (B, crop, crop) int64, a flipped crop
    reversed along W."""
    r = torch.arange(crop, device=imgs.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = torch.where(flip[:, None], x0[:, None] + (crop - 1) - r, x0[:, None] + r)[:, None, :]
    at = idx[:, None, None]
    return imgs[at, rows, cols], labs[at, rows, cols].long()


def loss_and_grads(model: SegVgg, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """The loss of a batch, its gradients left in the parameters' ``grad``."""
    model.zero_grad(set_to_none=True)
    loss = seg_loss(model(xb)[1], yb)
    loss.backward()
    return loss.detach()


def train_step(model: SegVgg, opt: torch.optim.Optimizer, xb: torch.Tensor,
               yb: torch.Tensor) -> torch.Tensor:
    loss = loss_and_grads(model, xb, yb)
    opt.step()
    return loss


@torch.no_grad()
def pixel_accuracy(model: SegVgg, imgs: torch.Tensor, labs: torch.Tensor) -> float:
    """Held-out pixel accuracy of the deepest head (1/16 resolution), each
    image whole, the labels strided to its logits; the mean over images."""
    accs = []
    for j in range(imgs.shape[0]):
        pred = model(imgs[j:j + 1])[1][-1].argmax(-1)
        y = labs[j:j + 1]
        yd = y[:, ::y.shape[1] // pred.shape[1], ::y.shape[2] // pred.shape[2]]
        accs.append((pred == yd).float().mean())
    return float(np.mean(torch.stack(accs).tolist()))


def export_trunk(trunk: Vgg19Features, out_path: str) -> str:
    """The trunk as the ``.npz`` that ``init_vgg19(weights_path=...)`` and
    ``--vgg_weights_path`` read (either package): ``conv{s}_{c}.kernel``
    HWIO and ``.bias``, fp32."""
    arrays = {}
    for name in conv_names():
        conv = getattr(trunk, name)
        arrays[f"{name}.kernel"] = np.ascontiguousarray(
            conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0))
        arrays[f"{name}.bias"] = conv.bias.detach().float().cpu().numpy()
    np.savez(out_path, **arrays)
    return out_path


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default="datasets/cityscapes_split")
    ap.add_argument("--out", default="artifacts/seg_vgg")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--crop", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--num_labels", type=int, default=35)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, device="cuda") -> dict:
    """Train, score the val split, write the trunk and ``TRAIN_META.txt``
    under ``--out``; returns the losses, each step's host-clock ms (the loss
    fetched), the held-out accuracy, the ``.npz`` path and the model."""
    device = resolve_device(device)
    args = parse_args(argv)
    imgs, labs = load_split(args.root, "train", num_labels=args.num_labels)
    print(f"{imgs.shape[0]} train images {imgs.shape[1:]} -> device")
    n, h, w = imgs.shape[:3]
    imgs_d = torch.from_numpy(imgs).to(device)
    labs_d = torch.from_numpy(labs).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_seg_vgg(args.num_labels, device, gen)
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)

    losses, step_ms = [], []
    t_start = time.time()
    for i in range(args.steps):
        t0 = time.perf_counter()
        xb, yb = gather_crops(imgs_d, labs_d, *draw_crops(gen, n, h, w, args.crop, args.batch),
                              args.crop)
        losses.append(float(train_step(model, opt, xb, yb)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: seg CE {losses[-1]:.4f}  ({time.time() - t_start:.0f}s)")

    val_imgs, val_labs = load_split(args.root, "val", num_labels=args.num_labels)
    acc = pixel_accuracy(model, torch.from_numpy(val_imgs).to(device),
                         torch.from_numpy(val_labs).to(device))
    print(f"held-out seg pixel acc (1/16 res): {acc:.4f}")

    os.makedirs(args.out, exist_ok=True)
    out_path = export_trunk(model.trunk, os.path.join(args.out, "vgg19_seg.npz"))
    with open(os.path.join(args.out, "TRAIN_META.txt"), "w") as f:
        f.write(f"steps={args.steps} batch={args.batch} crop={args.crop} "
                f"lr={args.lr} seed={args.seed}\n"
                f"heldout_pixel_acc_1_16={acc:.4f}\n")
    print(f"wrote {out_path} (load with --vgg_weights_path)")
    return {"losses": losses, "step_ms": step_ms, "heldout_pixel_acc": acc,
            "out_path": out_path, "model": model}


if __name__ == "__main__":
    main()
