"""The GAN's replay buffer of fakes, the port of
``jpdse_tpu/utils/image_pool.py``: while the pool fills, each fake passes
through and is stored; once full, each fake is swapped with a random stored
one (p = 0.5, returning the stored image) or passes through. The draws are
explicit: :func:`draw` takes them from a ``torch.Generator`` and
:func:`query` applies them. ``pool_size`` 0 is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class ImagePoolState:
    images: torch.Tensor  # (pool_size, H, W, C) fp32
    num_imgs: int = 0


def init_pool(pool_size: int, image_shape: Tuple[int, ...], device) -> ImagePoolState:
    return ImagePoolState(torch.zeros((pool_size, *image_shape), device=device))


def draw(state: ImagePoolState, batch: int, generator: torch.Generator):
    """Per image: whether a full pool returns a stored image (u > 0.5) and
    which slot it swaps."""
    dev = state.images.device
    use_old = torch.rand((batch,), generator=generator, device=dev) > 0.5
    rid = torch.randint(0, max(1, state.images.shape[0]), (batch,), generator=generator,
                        device=dev)
    return use_old.tolist(), rid.tolist()


def query(state: ImagePoolState, images: torch.Tensor, use_old, rid) -> torch.Tensor:
    """Run a batch of detached fakes through the pool, in place; returns the
    batch D sees."""
    size = state.images.shape[0]
    if size == 0:
        return images
    out = []
    for img, old, r in zip(images, use_old, rid):
        if state.num_imgs < size:
            state.images[state.num_imgs] = img
            state.num_imgs += 1
            out.append(img)
        elif old:
            out.append(state.images[r].clone().to(img.dtype))
            state.images[r] = img
        else:
            out.append(img)
    return torch.stack(out)
