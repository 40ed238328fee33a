"""GAN, feature-matching, perceptual and distortion losses, the port of
``jpdse_tpu/train/losses.py``: pure functions reducing in fp32. A target the
JAX package wraps in ``stop_gradient`` is detached here.

Each loss is a sum of global means. Under the spatial axis
(``parallel/spatial.py``) a mean is this rank's share, its sum over its own
rows over the whole tensor's count (``spatial.mean``): the group's shares
add up to the loss, and the step sums them with the gradients
(``train/step.py``).
"""

from __future__ import annotations

from typing import Callable, List

import torch

from jpdse_tpu_torch.parallel.spatial import global_h, like, mark, mean as global_mean

VGG_SLICE_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def _single_gan_loss(pred: torch.Tensor, target: float, use_lsgan: bool) -> torch.Tensor:
    p = pred.float()
    hg = global_h(pred)
    if use_lsgan:
        return global_mean(mark((p - target) ** 2, hg))
    p = p.clamp(1e-7, 1.0 - 1e-7)
    return -global_mean(mark(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p), hg))


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
            loss = loss + d_w * global_mean(mark((f.float() - r.detach().float()).abs(),
                                                 global_h(f)))
    return loss


def vgg_loss(vgg_apply: Callable, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """The five VGG19 slices' L1 with weights 1/32 .. 1, the target
    detached; ``vgg_apply(x)`` returns [relu1_1, .., relu5_1]. The real
    image's features need no graph, so they are taken without one."""
    f_feats = vgg_apply(fake)
    with torch.no_grad():
        r_feats = vgg_apply(like(real.detach(), real))
    loss = 0.0
    for w, f, r in zip(VGG_SLICE_WEIGHTS, f_feats, r_feats):
        loss = loss + w * global_mean(like((f.float() - r.float()).abs(), f))
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
    losses = [vgg_loss(vgg_apply, like(fake[i:i + chunk], fake), like(real[i:i + chunk], real))
              for i in range(0, b, chunk)]
    return torch.stack(losses).mean()


def distortion_loss(fake: torch.Tensor, real: torch.Tensor, kind: str = "l1") -> torch.Tensor:
    d = like(fake.float() - real.float(), fake)
    if kind == "l1":
        return global_mean(like(d.abs(), d))
    if kind == "mse":
        return global_mean(like(d * d, d))
    raise ValueError(f"unknown distortion loss {kind}")
