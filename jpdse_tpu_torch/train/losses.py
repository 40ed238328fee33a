"""GAN, feature-matching, perceptual and distortion losses, the port of
``jpdse_tpu/train/losses.py``: pure functions reducing in fp32. A target the
JAX package wraps in ``stop_gradient`` is detached here.
"""

from __future__ import annotations

from typing import Callable, List

import torch

VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def _single_gan_loss(pred: torch.Tensor, target: float, use_lsgan: bool) -> torch.Tensor:
    p = pred.float()
    if use_lsgan:
        return ((p - target) ** 2).mean()
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p)).mean()


def gan_loss(preds: List[List[torch.Tensor]], target_is_real: bool,
             use_lsgan: bool = True) -> torch.Tensor:
    """LSGAN MSE (or BCE) on each scale's final prediction, summed over the
    scales."""
    target = 1.0 if target_is_real else 0.0
    loss = 0.0
    for scale in preds:
        loss = loss + _single_gan_loss(scale[-1], target, use_lsgan)
    return loss


def feature_matching_loss(pred_fake: List[List[torch.Tensor]],
                          pred_real: List[List[torch.Tensor]], num_D: int) -> torch.Tensor:
    """L1 over every intermediate D feature (all but the prediction), the
    real side detached, scaled by 1 / num_D."""
    loss = 0.0
    d_w = 1.0 / num_D
    for pf, pr in zip(pred_fake, pred_real):
        for f, r in zip(pf[:-1], pr[:-1]):
            loss = loss + d_w * (f.float() - r.detach().float()).abs().mean()
    return loss


def vgg_loss(vgg_apply: Callable, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """The five VGG19 slices' L1 with weights 1/32 .. 1, the target
    detached; ``vgg_apply(x)`` returns [relu1_1, .., relu5_1]. The real
    image's features need no graph, so they are taken without one."""
    f_feats = vgg_apply(fake)
    with torch.no_grad():
        r_feats = vgg_apply(real.detach())
    loss = 0.0
    for w, f, r in zip(VGG_SLICE_WEIGHTS, f_feats, r_feats):
        loss = loss + w * (f.float() - r.float()).abs().mean()
    return loss


def vgg_loss_chunked(vgg_apply: Callable, fake: torch.Tensor, real: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """:func:`vgg_loss` over ``chunk`` images at a time, the mean of the
    chunks' losses (equal to the whole batch's: each slice loss is a mean
    over equal chunks); ``chunk`` falls to the largest divisor of the
    batch."""
    b = fake.shape[0]
    if chunk <= 0 or chunk >= b:
        return vgg_loss(vgg_apply, fake, real)
    while b % chunk:
        chunk -= 1
    losses = [vgg_loss(vgg_apply, fake[i:i + chunk], real[i:i + chunk])
              for i in range(0, b, chunk)]
    return torch.stack(losses).mean()


def distortion_loss(fake: torch.Tensor, real: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    d = fake.float() - real.float()
    if kind == "l1":
        return d.abs().mean()
    if kind == "mse":
        return (d * d).mean()
    raise ValueError(f"unknown distortion loss {kind}")
