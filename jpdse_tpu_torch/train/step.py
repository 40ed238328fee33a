"""The GAN training step and the evaluation loss, the port of
``jpdse_tpu/train/step.py`` (``make_train_step`` :54-313, ``make_eval_step``
:316).

The JAX package jits one function; here it is two, held apart by the tests
and ``chip_smoke.py``:

* :func:`loss_and_grads` returns the eight metrics and both players'
  gradients, both taken from the pre-update parameters as the reference
  builds both loss graphs before either update (``step.py:1-13``): G's
  from ``torch.autograd.grad`` over G's parameters alone, through D's
  passes on the fake; D's from the detached (and pool-replayed) fake;
* :func:`apply` steps G's Adam, then D's, then anneals the distortion
  weight. Under ``loss.no_d_gan_loss`` D still steps, on zero gradients:
  optax advances its Adam count on every step, and so must this one, or
  the bias correction drifts.

``optim.remat`` recomputes the decode's blocks (``models/layers.py``) and,
as the JAX package's whole-function ``jax.checkpoint`` does, D's passes and
VGG's pass on the fake in the backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from jpdse_tpu_torch.models.layers import remat_call
from jpdse_tpu_torch.ops.metrics import denormalize_to_uint8
from jpdse_tpu_torch.train.losses import (
    distortion_loss,
    feature_matching_loss,
    gan_loss,
    vgg_loss_chunked,
)
from jpdse_tpu_torch.train.state import GANTrainState
from jpdse_tpu_torch.utils import image_pool

METRICS = ("D_fake", "D_real", "G_Distortion", "G_GAN", "G_GAN_Feat", "G_VGG", "loss_D",
           "loss_G")  # sorted, the order of the stacked fetch

Grads = Tuple[List[torch.Tensor], List[torch.Tensor]]


def _d_concat(input_label: Optional[torch.Tensor], image: torch.Tensor) -> torch.Tensor:
    if input_label is None:
        return image
    return torch.cat([input_label, image.to(input_label.dtype)], dim=-1)


def _grads(loss: torch.Tensor, params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
    if not loss.requires_grad:  # every loss of the player switched off
        return [torch.zeros_like(p) for p in params]
    got = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]


def loss_and_grads(state: GANTrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Tuple[Dict[str, torch.Tensor], Grads]:
    """(metrics, (G's gradients, D's gradients)) of one batch on the device:
    the metrics are 0-d fp32 tensors named as :data:`METRICS`; the
    gradients follow ``codec.parameters()`` and ``disc.parameters()``. The
    binarizers' draws, then the pool's, come from ``generator``."""
    cfg, L = state.cfg, state.cfg.loss
    codec, disc = state.codec, state.disc
    remat = cfg.optim.remat
    use_lsgan = not cfg.model.no_lsgan
    keep = L.match_raw_feat
    inputs = codec.prepare(batch)
    real = inputs["real_image"]
    dev = real.device
    zero = torch.zeros((), device=dev)
    with torch.enable_grad():
        fake, input_label = codec.decode(inputs, train=True, deterministic=False,
                                         generator=generator)
        l_g_gan = l_feat = l_vgg = l_dist = zero
        if not (L.no_g_gan_loss and L.no_gan_feat_loss):
            pred_fake = remat_call(remat, disc, _d_concat(input_label, fake), keep)
            if not L.no_g_gan_loss:
                l_g_gan = gan_loss(pred_fake, True, use_lsgan)
            if not L.no_gan_feat_loss:
                with torch.no_grad():  # targets only: detached in the loss
                    pred_real = disc(_d_concat(input_label, real), keep)
                l_feat = feature_matching_loss(pred_fake, pred_real, cfg.model.num_D)
        if not L.no_vgg_loss and state.vgg is not None:
            vgg = state.vgg
            l_vgg = vgg_loss_chunked(lambda x: remat_call(remat, vgg, x), fake, real,
                                     cfg.optim.vgg_chunk)
        if not L.no_distortion_loss:
            l_dist = distortion_loss(fake, real, L.distortion_loss_fn)
        loss_g = (l_g_gan + l_feat * L.lambda_feat + l_vgg * L.lambda_feat
                  + l_dist * L.lambda_distortion * state.lambda_distortion_weight)
        g_params = list(codec.parameters())
        grads_g = _grads(loss_g, g_params)

    d_params = list(disc.parameters())
    if L.no_d_gan_loss:
        loss_d = l_real = l_fake = zero
        grads_d = [torch.zeros_like(p) for p in d_params]
    else:
        label_sg = None if input_label is None else input_label.detach()
        fake_concat = _d_concat(label_sg, fake.detach())
        if state.pool is not None:
            use_old, rid = image_pool.draw(state.pool, fake_concat.shape[0], generator)
            fake_concat = image_pool.query(state.pool, fake_concat, use_old, rid)
        with torch.enable_grad():
            l_fake = gan_loss(disc(fake_concat), False, use_lsgan)
            l_real = gan_loss(disc(_d_concat(label_sg, real)), True, use_lsgan)
            loss_d = 0.5 * (l_fake + l_real)
            grads_d = _grads(loss_d, d_params)

    metrics = {"G_GAN": l_g_gan, "G_GAN_Feat": l_feat, "G_VGG": l_vgg, "G_Distortion": l_dist,
               "D_real": l_real, "D_fake": l_fake, "loss_G": loss_g, "loss_D": loss_d}
    return {k: torch.as_tensor(v, device=dev).detach().float() for k, v in metrics.items()}, \
        (grads_g, grads_d)


def apply(state: GANTrainState, grads: Grads) -> None:
    """Step G's Adam on G's gradients, then D's on D's, then count the step
    and anneal the distortion weight (``loss.anneal_lambda``)."""
    L = state.cfg.loss
    for opt, params, g in ((state.opt_g, state.codec.parameters(), grads[0]),
                           (state.opt_d, state.disc.parameters(), grads[1])):
        params = list(params)
        for p, gi in zip(params, g):
            p.grad = gi
        opt.step()
        for p in params:
            p.grad = None
    state.steps_taken += 1
    if L.anneal_lambda and state.steps_taken % L.anneal_interval == 0:
        state.lambda_distortion_weight *= L.anneal_factor


@torch.inference_mode()
def eval_loss(state: GANTrainState, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """get_eval_loss: the deterministic reconstruction and the real image,
    both denormalized and quantized as uint8 images are, and the distortion
    between them (a 0-d tensor on the device)."""
    cfg, codec = state.cfg, state.codec
    inputs = codec.prepare(batch)
    fake, _ = codec.decode(inputs)
    mean, std = cfg.data.normalize_mean, cfg.data.normalize_std
    return distortion_loss(denormalize_to_uint8(fake, mean, std),
                           denormalize_to_uint8(inputs["real_image"], mean, std),
                           cfg.loss.distortion_loss_fn)
