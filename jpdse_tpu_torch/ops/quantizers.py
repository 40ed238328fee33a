"""Eval-mode binarizer, the port of ``jpdse_tpu/ops/quantizers.py:84``
(``Binarizer`` with ``deterministic_sign_ste``). Training's stochastic sign
waits for the training slice."""

from __future__ import annotations

import torch
from torch import nn

from jpdse_tpu_torch.models.layers import conv_nhwc


class Binarizer(nn.Module):
    """1x1 bias-free conv + tanh + sign, NHWC. ``sign(0) = 0``, as
    ``jnp.sign`` gives."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)

    def presign(self, x: torch.Tensor) -> torch.Tensor:
        """tanh(conv1x1(x)): the value whose sign is the code bit."""
        return torch.tanh(conv_nhwc(x, self.conv.weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sign(self.presign(x))
