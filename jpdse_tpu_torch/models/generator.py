"""Generators and encoder (NHWC), the port of ``jpdse_tpu/models/generator.py``:
``GlobalGenerator`` (:35-150) with its bottleneck binarizer,
``LocalEnhancer`` (:181-261) with ``LocalDownsample`` (:264-279) and
``LocalUpsample`` (:282-308), and the (grouped) ``Encoder`` (:311-391).
Submodule names are the Flax ones: the enhancer's global trunk is
``global`` (a ``GlobalGenerator`` without its tail, which Flax never
creates), its stacks ``local{n}_down`` and ``local{n}_up``. ``fused`` runs
every instance-norm site through kernel K3 (``models/layers.py::_fused_norm``);
``remat`` recomputes each block in the backward (``models/layers.py``), and
each enhancer stack as one block, as JAX's ``nn.remat`` does (:204-207)."""

from __future__ import annotations

import torch
from torch import nn

from jpdse_tpu_torch.models.layers import (
    Conv,
    ConvNormAct,
    ConvTransposeNormAct,
    ResnetBlock,
    avg_pool_3s2,
    instance_wise_avg_pool,
    reflect_pad,
    remat_call,
)
from jpdse_tpu_torch.ops.quantizers import Binarizer


def _down(ngf: int, n: int, fused: bool, remat: bool, norm: str, groups: int = 1):
    return nn.ModuleList(
        ConvNormAct(ngf * 2**i, ngf * 2 ** (i + 1), 3, stride=2, padding=1, fused=fused,
                    remat=remat, groups=groups, norm=norm)
        for i in range(n)
    )


def _up(ngf: int, n: int, in_ch: int, fused: bool, remat: bool, norm: str, groups: int = 1):
    """Mirrored upsamples; ``in_ch`` is the first one's input width."""
    out = [int(ngf * 2 ** (n - i) / 2) for i in range(n)]
    return nn.ModuleList(
        ConvTransposeNormAct(i, o, fused, remat, groups=groups, norm=norm)
        for i, o in zip([in_ch] + out[:-1], out))


class GlobalGenerator(nn.Module):
    """c7s1-ngf, n strided convs, [binarizer], n_blocks residual blocks,
    [binarizer], mirrored transposed convs, c7s1-out + tanh. ``binarize``
    puts a binarizer in the bottleneck, after the residual blocks or, with
    ``bin_before_res``, before them (the blocks then run at its width);
    ``encode`` and ``decode_from_code`` split the trunk there. Without
    ``tail`` it is a LocalEnhancer's global trunk: no tail parameters."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9, fused: bool = False,
                 remat: bool = False, binarize: bool = False,
                 binarizer_out_channels: int = 128, bin_before_res: bool = False,
                 norm: str = "instance", padding_type: str = "reflect", tail: bool = True):
        super().__init__()
        mid = ngf * 2**n_downsampling
        self.bin_before_res = binarize and bin_before_res
        self.head = ConvNormAct(input_nc, ngf, 7, reflect=3, fused=fused, remat=remat, norm=norm)
        self.down = _down(ngf, n_downsampling, fused, remat, norm)
        self.binarizer = Binarizer(mid, binarizer_out_channels) if binarize else None
        res_dim = binarizer_out_channels if self.bin_before_res else mid
        self.res = nn.ModuleList(ResnetBlock(res_dim, fused, remat, padding_type, norm)
                                 for _ in range(n_blocks))
        self.up = _up(ngf, n_downsampling, binarizer_out_channels if binarize else mid, fused,
                      remat, norm)
        self.tail = Conv(ngf, output_nc, 7) if tail else None

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

    def ups(self, h):
        for blk in self.up:
            h = blk(h)
        return h

    def _back(self, h):
        return torch.tanh(self.tail(reflect_pad(self.ups(h), 3)))

    def decode_from_code(self, code):
        """Resume the trunk after the binarizer."""
        if self.binarizer is None:
            raise AttributeError("GlobalGenerator: no binarizer found")
        return self._back(self._res(code) if self.bin_before_res else code)

    def forward(self, x, deterministic: bool = True, generator=None):
        if self.binarizer is None:
            return self._back(self.features(x))
        return self.decode_from_code(self.encode(x, deterministic, generator))


class LocalDownsample(nn.Module):
    """An enhancer's full-resolution stack: c7s1-ngf, then a stride-2 conv
    to 2 ngf."""

    def __init__(self, in_ch: int, ngf: int, norm: str = "instance", fused: bool = False):
        super().__init__()
        self.c7 = ConvNormAct(in_ch, ngf, 7, reflect=3, fused=fused, norm=norm)
        self.d1 = ConvNormAct(ngf, 2 * ngf, 3, stride=2, padding=1, fused=fused, norm=norm)

    def forward(self, x):
        return self.d1(self.c7(x))


class LocalUpsample(nn.Module):
    """An enhancer's residual blocks at 2 ngf, a transposed conv to ngf and,
    in the last enhancer (``final``), c7s1-out + tanh."""

    def __init__(self, ngf: int, output_nc: int, n_blocks: int = 3, norm: str = "instance",
                 padding_type: str = "reflect", final: bool = False, fused: bool = False):
        super().__init__()
        self.res = nn.ModuleList(ResnetBlock(2 * ngf, fused, False, padding_type, norm)
                                 for _ in range(n_blocks))
        self.up = ConvTransposeNormAct(2 * ngf, ngf, fused, norm=norm)
        self.tail = Conv(ngf, output_nc, 7) if final else None

    def forward(self, x):
        for blk in self.res:
            x = blk(x)
        x = self.up(x)
        if self.tail is not None:
            x = torch.tanh(self.tail(reflect_pad(x, 3)))
        return x


class LocalEnhancer(nn.Module):
    """The coarse-to-fine pyramid: the global trunk (ngf 2^n_local x ngf,
    no tail) on the input pooled n_local times; then each enhancer n adds
    its downsample stack of the input pooled n_local - n times to the
    previous output and refines it through its upsample stack. It has no
    binarizer."""

    binarizer = None

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_downsample_global: int = 4, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3, norm: str = "instance",
                 padding_type: str = "reflect", fused: bool = False, remat: bool = False):
        super().__init__()
        self.n_local, self.remat = n_local_enhancers, remat
        self.add_module("global", GlobalGenerator(
            input_nc, output_nc, ngf * 2**n_local_enhancers, n_downsample_global,
            n_blocks_global, fused, remat, norm=norm, padding_type=padding_type, tail=False))
        for n in range(1, n_local_enhancers + 1):
            ngf_n = ngf * 2 ** (n_local_enhancers - n)
            self.add_module(f"local{n}_down", LocalDownsample(input_nc, ngf_n, norm, fused))
            self.add_module(f"local{n}_up", LocalUpsample(
                ngf_n, output_nc, n_blocks_local, norm, padding_type,
                final=n == n_local_enhancers, fused=fused))

    @property
    def global_trunk(self) -> GlobalGenerator:
        return getattr(self, "global")

    def forward(self, x, deterministic: bool = True, generator=None):
        pyramid = [x]
        for _ in range(self.n_local):
            pyramid.append(avg_pool_3s2(pyramid[-1]))
        trunk = self.global_trunk
        h = trunk.ups(trunk.features(pyramid[-1]))
        for n in range(1, self.n_local + 1):
            down, up = getattr(self, f"local{n}_down"), getattr(self, f"local{n}_up")
            d = remat_call(self.remat, down, pyramid[self.n_local - n])
            h = remat_call(self.remat, up, d + h)
        return h


class Encoder(nn.Module):
    """c7s1 + n strided convs, [binarizer], mirrored transposed convs,
    c7s1 + tanh, every conv in ``groups`` groups, split into ``encode``
    (through the binarizer) and ``decode_from_code``. With
    ``inst_wise_pool`` its output is averaged over each instance of the ids
    ``inst`` the call is given (``num_segments`` of them at most)."""

    def __init__(self, input_nc: int, output_nc: int, ngf: int = 32,
                 n_downsampling: int = 4, binarize: bool = False,
                 binarizer_out_channels: int = 128, fused: bool = False, remat: bool = False,
                 norm: str = "instance", groups: int = 1, inst_wise_pool: bool = False,
                 num_segments: int = 40960):
        super().__init__()
        g = groups
        self.inst_wise_pool, self.num_segments = inst_wise_pool, num_segments
        self.head = ConvNormAct(input_nc, ngf, 7, reflect=3, fused=fused, remat=remat, groups=g,
                                norm=norm)
        self.down = _down(ngf, n_downsampling, fused, remat, norm, g)
        mid = ngf * 2**n_downsampling
        self.binarizer = Binarizer(mid, binarizer_out_channels, g) if binarize else None
        self.up = _up(ngf, n_downsampling, binarizer_out_channels if binarize else mid, fused,
                      remat, norm, g)
        self.tail = Conv(ngf, output_nc, 7, groups=g)

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

    def forward(self, x, deterministic: bool = True, generator=None, inst=None):
        out = self.decode_from_code(self.encode(x, deterministic, generator))
        if self.inst_wise_pool:
            if inst is None:
                raise ValueError("inst_wise_pool requires instance ids")
            out = instance_wise_avg_pool(out, inst, self.num_segments)
        return out
