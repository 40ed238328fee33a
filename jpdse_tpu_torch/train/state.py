"""The GAN's training state, the port of ``jpdse_tpu/train/state.py``: both
players' modules, their Adams, the step count, the annealed distortion
weight, the best validation loss and the replay pool, in one object that
the step (``train/step.py``) reads and updates.

The two optimizers are ``torch.optim.Adam`` with the reference's
hyperparameters (lr, betas (beta1, beta2), eps 1e-8); the lr lives in the
param group, where ``set_lr`` changes it without rebuilding anything, as
``optax.inject_hyperparams`` keeps it in the optimizer state. Under
``optim.fast_train`` the state also holds the s2d train decode, which the
step runs in place of the codec's decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.utils.image_pool import ImagePoolState, init_pool


@dataclass
class GANTrainState:
    cfg: Config
    codec: nn.Module  # SemanticCodec: netG, netE, netE4label
    disc: nn.Module  # MultiscaleDiscriminator
    vgg: Optional[nn.Module]  # frozen Vgg19Features, or None under loss.no_vgg_loss
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    steps_taken: int = 0
    lambda_distortion_weight: float = 1.0
    best_val_loss: float = 1e12
    pool: Optional[ImagePoolState] = None
    # under optim.fast_train the s2d train decode (models/fast_train.py), else None
    fast_decode: Optional[Callable] = None


def make_adam(cfg: Config, params) -> torch.optim.Adam:
    o = cfg.optim
    return torch.optim.Adam(params, lr=o.lr, betas=(o.beta1, o.beta2), eps=1e-8)


def create_train_state(cfg: Config, codec: nn.Module, disc: nn.Module,
                       vgg: Optional[nn.Module] = None,
                       pool_image_shape=None) -> GANTrainState:
    pool = None
    if cfg.model.pool_size > 0:
        if pool_image_shape is None:
            raise ValueError("pool_size > 0 requires pool_image_shape (H, W, C)")
        pool = init_pool(cfg.model.pool_size, tuple(pool_image_shape),
                         next(codec.parameters()).device)
    fast_decode = None
    if cfg.optim.fast_train:
        # raises ValueError with the failed gate for an ineligible config
        from jpdse_tpu_torch.models.fast_train import make_fast_train_decode

        fast_decode = make_fast_train_decode(cfg, codec)
    return GANTrainState(cfg, codec, disc, vgg, make_adam(cfg, codec.parameters()),
                         make_adam(cfg, disc.parameters()), pool=pool, fast_decode=fast_decode)


def get_lr(state: GANTrainState) -> float:
    return float(state.opt_g.param_groups[0]["lr"])


def set_lr(state: GANTrainState, lr_g: float, lr_d: Optional[float] = None) -> None:
    """The ReduceLROnPlateau hook: both players' lr (D's defaults to G's)."""
    for group in state.opt_g.param_groups:
        group["lr"] = lr_g
    for group in state.opt_d.param_groups:
        group["lr"] = lr_g if lr_d is None else lr_d
