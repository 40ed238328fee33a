"""The GAN training step and the evaluation loss, the port of
``jpdse_tpu/train/step.py`` (``make_train_step`` :54-313, ``make_eval_step``
:316, ``raw_side_inputs`` :377).

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
  the bias correction drifts. So does a frozen parameter (a
  LocalEnhancer's global trunk for ``model.niter_fix_global`` epochs,
  ``trainer.py``): its ``requires_grad`` is off, so autograd skips it (and
  where nothing upstream trains, records no graph through it), and its
  gradient is zeros, as ``step.py:273-277`` zeroes the trunk's.

Under a process group (``state.mesh``, ``parallel/mesh.py``) the step is
the global step of JAX's mesh, done by hand: the batch is this rank's shard
of the global batch; the binarizers' and dropout's draws are made for the
global batch and each rank keeps its rows; the replay pool, replicated
state, is queried with the whole global batch of detached fakes (gathered
from the ranks, as ``step.py:259-264`` queries it); and G's and D's
gradients and the metrics are all-reduced as means (:func:`reduce_over_ranks`)
before either Adam steps, so every rank steps alike. (Not
``DistributedDataParallel``: the step already hands its gradients over
explicitly, D runs inside both players' losses, and block remat re-runs
forwards that DDP's hooks do not expect.)

Under ``optim.fast_train`` the decode is the s2d train decode
(``models/fast_train.py``, ``state.fast_decode``), as the JAX package swaps
it in (:87-98). ``optim.remat`` recomputes the decode's blocks
(``models/layers.py``) and, as the JAX package's whole-function
``jax.checkpoint`` does, D's passes and VGG's pass on the fake in the
backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from jpdse_tpu_torch.models.layers import remat_call
from jpdse_tpu_torch.ops.metrics import denormalize_to_uint8
from jpdse_tpu_torch.parallel import distributed
from jpdse_tpu_torch.parallel.mesh import drawing as mesh_draws
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
    """The gradient of ``loss`` for each parameter, zeros where there is
    none: every loss of the player switched off, or a frozen parameter
    (``requires_grad`` off), which Adam then still steps as optax steps a
    zeroed leaf."""
    live = [p for p in params if p.requires_grad]
    got = {}
    if loss.requires_grad and live:
        got = dict(zip(map(id, live), torch.autograd.grad(loss, live, allow_unused=True)))
    out = []
    for p in params:
        g = got.get(id(p))
        out.append(torch.zeros_like(p) if g is None else g)
    return out


def loss_and_grads(state: GANTrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Tuple[Dict[str, torch.Tensor], Grads]:
    """(metrics, (G's gradients, D's gradients)) of one batch on the device:
    the metrics are 0-d fp32 tensors named as :data:`METRICS`; the
    gradients follow ``codec.parameters()`` and ``disc.parameters()``. The
    binarizers' draws, then the pool's, come from ``generator``. Under
    ``state.mesh`` they are the global step's: the means over the ranks."""
    inputs = state.codec.prepare(batch)
    mesh = state.mesh
    with mesh_draws(mesh):
        metrics, grads = _local(state, inputs, generator)
    if mesh is not None:
        reduce_over_ranks(metrics, grads)
    return metrics, grads


def reduce_over_ranks(metrics: Dict[str, torch.Tensor], grads: Grads) -> None:
    """Replace this rank's metrics and gradients in place by their means over
    the process group's ranks: one bucketed all-reduce, in each tensor's
    dtype (fp32 for the port's parameters)."""
    stacked = torch.stack([metrics[k] for k in METRICS])
    distributed.all_reduce_mean_(list(grads[0]) + list(grads[1]) + [stacked])
    for k, v in zip(METRICS, stacked):
        metrics[k] = v


def _local(state: GANTrainState, inputs: Dict, generator: torch.Generator
           ) -> Tuple[Dict[str, torch.Tensor], Grads]:
    """loss_and_grads on this process's batch (its rank's shard)."""
    cfg, L = state.cfg, state.cfg.loss
    codec, disc = state.codec, state.disc
    remat = cfg.optim.remat
    use_lsgan = not cfg.model.no_lsgan
    keep = L.match_raw_feat
    real = inputs["real_image"]
    dev = real.device
    zero = torch.zeros((), device=dev)
    with torch.enable_grad():
        if state.fast_decode is not None:  # optim.fast_train (step.py:87-98)
            fake, input_label = state.fast_decode(inputs, generator, deterministic=False)
        else:
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
        if state.pool is not None:  # queried with the global batch (one rank: its own)
            mesh = state.mesh
            full = fake_concat if mesh is None else mesh.gather_rows(fake_concat)
            use_old, rid = image_pool.draw(state.pool, full.shape[0], generator)
            full = image_pool.query(state.pool, full, use_old, rid)
            fake_concat = full if mesh is None else full[mesh.rows(fake_concat.shape[0])]
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


def raw_side_inputs(side_batch: Dict[str, torch.Tensor], dtype=None) -> Dict:
    """A decoder's inputs from a stream's side info where the semantics ride
    in the codes (no label in ``side_batch``): the visuals, the base codec's
    decoded image, and the instance ids where an unbinarized encoder pools
    over them. ``prepare_inputs`` would one-hot the missing label, so the
    dict is assembled directly; both packages' decoders share it."""
    def cast(t):
        return t if t is None or dtype is None else t.to(dtype)

    return {"input_label": None, "real_image": cast(side_batch["image"]),
            "instance_ids": side_batch.get("instance"), "masked_img": None,
            "compressed_img": cast(side_batch.get("compressed"))}


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
