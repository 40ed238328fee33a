"""Generator and encoder (NHWC), the port of ``jpdse_tpu/models/generator.py``
(``GlobalGenerator`` :35-150 with its bottleneck binarizer, ``Encoder``
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
    """c7s1-ngf, n strided convs, [binarizer], n_blocks residual blocks,
    [binarizer], mirrored transposed convs, c7s1-out + tanh. ``binarize``
    puts a binarizer in the bottleneck, after the residual blocks or, with
    ``bin_before_res``, before them (the blocks then run at its width);
    ``encode`` and ``decode_from_code`` split the trunk there."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9, fused: bool = False,
                 remat: bool = False, binarize: bool = False,
                 binarizer_out_channels: int = 128, bin_before_res: bool = False):
        super().__init__()
        mid = ngf * 2**n_downsampling
        self.bin_before_res = binarize and bin_before_res
        self.head = ConvNormAct(input_nc, ngf, 7, reflect=3, fused=fused, remat=remat)
        self.down = _down(ngf, n_downsampling, fused, remat)
        self.binarizer = Binarizer(mid, binarizer_out_channels) if binarize else None
        res_dim = binarizer_out_channels if self.bin_before_res else mid
        self.res = nn.ModuleList(ResnetBlock(res_dim, fused, remat) for _ in range(n_blocks))
        self.up = _up(ngf, n_downsampling, binarizer_out_channels if binarize else mid, fused,
                      remat)
        self.tail = Conv(ngf, output_nc, 7)

    def _res(self, h):
        for blk in self.res:
            h = blk(h)
        return h

    def features(self, x):
        """The trunk up to the binarizer's input (the whole front without
        one)."""
        h = self.head(x)
        for blk in self.down:
            h = blk(h)
        return h if self.bin_before_res else self._res(h)

    def encode(self, x, deterministic: bool = True, generator=None):
        """Through the binarizer: the {-1, +1} bottleneck code (the
        stochastic sign from ``generator`` in training)."""
        if self.binarizer is None:
            raise AttributeError("GlobalGenerator: no binarizer found")
        return self.binarizer(self.features(x), deterministic, generator)

    def _back(self, h):
        for blk in self.up:
            h = blk(h)
        return torch.tanh(self.tail(reflect_pad(h, 3)))

    def decode_from_code(self, code):
        """Resume the trunk after the binarizer."""
        if self.binarizer is None:
            raise AttributeError("GlobalGenerator: no binarizer found")
        return self._back(self._res(code) if self.bin_before_res else code)

    def forward(self, x, deterministic: bool = True, generator=None):
        if self.binarizer is None:
            return self._back(self.features(x))
        return self.decode_from_code(self.encode(x, deterministic, generator))


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
