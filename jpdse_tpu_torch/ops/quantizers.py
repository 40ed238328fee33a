"""Binarizer and the sign with a straight-through gradient, the port of
``jpdse_tpu/ops/quantizers.py`` (``stochastic_sign_ste`` :28-47,
``deterministic_sign_ste`` :50-58, ``Binarizer`` :84). The stochastic sign
takes its uniform draws from an explicit ``torch.Generator``; the JAX
package's ``S2HVQ``, ``S2HVQV2`` and ``rounded_identity`` are ROADMAP Queue
1 item 7's remainder (no model of either package uses them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jpdse_tpu_torch.models.layers import conv_nhwc


class _SignSTE(torch.autograd.Function):
    """``sign`` (``u`` None) or the stochastic sign against the uniform draws
    ``u``, with an identity gradient."""

    @staticmethod
    def forward(ctx, x, u):
        if u is None:
            return torch.sign(x)
        return sign_from_uniform(x, u)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sign_from_uniform(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """+1 where (1 - x) / 2 <= u, else -1, in x's dtype: P(+1) = (1 + x) / 2
    for u uniform on [0, 1)."""
    return torch.where((1.0 - x) / 2.0 <= u, 1.0, -1.0).to(x.dtype)


def stochastic_sign_ste(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Stochastic binarization with a straight-through gradient: u drawn by
    ``torch.rand`` in x's dtype from ``generator``."""
    u = torch.rand(x.shape, dtype=x.dtype, device=x.device, generator=generator)
    return _SignSTE.apply(x, u)


def deterministic_sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) (0 at 0, as ``jnp.sign``) with an identity gradient."""
    return _SignSTE.apply(x, None)


class Binarizer(nn.Module):
    """1x1 bias-free conv + tanh + sign, NHWC: the sign in evaluation, the
    stochastic sign in training (``deterministic`` False)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def presign(self, x: torch.Tensor) -> torch.Tensor:
        """tanh(conv1x1(x)): the value whose sign is the code bit."""
        return torch.tanh(conv_nhwc(x, self.conv.weight))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.presign(x)
        if deterministic:
            return deterministic_sign_ste(h)
        if generator is None:
            raise ValueError("stochastic binarization needs an explicit torch.Generator")
        return stochastic_sign_ste(h, generator)
