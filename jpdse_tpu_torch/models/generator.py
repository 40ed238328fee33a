"""Generator and encoder (NHWC), the port of ``jpdse_tpu/models/generator.py``
(``GlobalGenerator`` :35-160 without its bottleneck binarizer, ``Encoder``
:311-393 at groups=1). Submodule names are the Flax ones. ``fused`` runs
every norm site through kernel K3 (``models/layers.py::_fused_norm``);
``remat`` recomputes each block in the backward (``models/layers.py``)."""

from __future__ import annotations

import torch
from torch import nn

from jpdse_tpu_torch.models.layers import (
    Conv,
    ConvNormAct,
    ConvTransposeNormAct,
    ResnetBlock,
    reflect_pad,
)
from jpdse_tpu_torch.ops.quantizers import Binarizer


def _down(ngf: int, n: int, fused: bool, remat: bool) -> nn.ModuleList:
    return nn.ModuleList(
        ConvNormAct(ngf * 2**i, ngf * 2 ** (i + 1), 3, stride=2, padding=1, fused=fused,
                    remat=remat)
        for i in range(n)
    )


def _up(ngf: int, n: int, in_ch: int, fused: bool, remat: bool) -> nn.ModuleList:
    """Mirrored upsamples; ``in_ch`` is the first one's input width."""
    out = [int(ngf * 2 ** (n - i) / 2) for i in range(n)]
    return nn.ModuleList(
        ConvTransposeNormAct(i, o, fused, remat) for i, o in zip([in_ch] + out[:-1], out))


class GlobalGenerator(nn.Module):
    """c7s1-ngf, n strided convs, n_blocks residual blocks, mirrored
    transposed convs, c7s1-out + tanh."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9, fused: bool = False,
                 remat: bool = False):
        super().__init__()
        self.head = ConvNormAct(input_nc, ngf, 7, reflect=3, fused=fused, remat=remat)
        self.down = _down(ngf, n_downsampling, fused, remat)
        self.res = nn.ModuleList(
            ResnetBlock(ngf * 2**n_downsampling, fused, remat) for _ in range(n_blocks))
        self.up = _up(ngf, n_downsampling, ngf * 2**n_downsampling, fused, remat)
        self.tail = Conv(ngf, output_nc, 7)

    def forward(self, x):
        h = self.head(x)
        for blk in self.down:
            h = blk(h)
        for blk in self.res:
            h = blk(h)
        for blk in self.up:
            h = blk(h)
        return torch.tanh(self.tail(reflect_pad(h, 3)))


class Encoder(nn.Module):
    """c7s1 + n strided convs, [binarizer], mirrored transposed convs,
    c7s1 + tanh, split into ``encode`` (through the binarizer) and
    ``decode_from_code``."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_downsampling: int = 4, binarize: bool = False,
                 binarizer_out_channels: int = 128, fused: bool = False, remat: bool = False):
        super().__init__()
        self.head = ConvNormAct(input_nc, ngf, 7, reflect=3, fused=fused, remat=remat)
        self.down = _down(ngf, n_downsampling, fused, remat)
        mid = ngf * 2**n_downsampling
        self.binarizer = Binarizer(mid, binarizer_out_channels) if binarize else None
        self.up = _up(ngf, n_downsampling, binarizer_out_channels if binarize else mid, fused,
                      remat)
        self.tail = Conv(ngf, output_nc, 7)

    def features(self, x):
        """Head and downsamples: the binarizer's input."""
        h = self.head(x)
        for blk in self.down:
            h = blk(h)
        return h

    def encode(self, x, deterministic: bool = True, generator=None):
        """Through the binarizer: its sign, or in training (``deterministic``
        False) its stochastic sign drawn from ``generator``."""
        h = self.features(x)
        return self.binarizer(h, deterministic, generator) if self.binarizer is not None else h

    def decode_from_code(self, h):
        for blk in self.up:
            h = blk(h)
        return torch.tanh(self.tail(reflect_pad(h, 3)))

    def forward(self, x, deterministic: bool = True, generator=None):
        return self.decode_from_code(self.encode(x, deterministic, generator))
