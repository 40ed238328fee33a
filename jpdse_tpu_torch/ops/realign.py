"""Grid re-alignment of an s2d tensor (kernel K1), the port of
``jpdse_tpu/ops/pallas/realign.py::s2d_realign_pad3_pallas``, and its
front-side sibling (kernel K2), the port of ``s2d_pad3_pallas``.

Every fast trunk's back stage re-aligns the s2d grid before its 7x7 tail:
``space_to_depth(reflect_pad(depth_to_space(y), 3))``. A front enters the
s2d domain through ``space_to_depth(reflect_pad(x, 3))`` of its fine input.
The CUDA kernels (``csrc/realign.cu``) do each in one pass;
:func:`s2d_realign_pad3_plain` and :func:`s2d_pad3_plain` are their plain
PyTorch versions, which the wrappers take for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jpdse_tpu_torch.models.layers import reflect_pad_hw
from jpdse_tpu_torch.ops import build
from jpdse_tpu_torch.ops.s2d import depth_to_space, space_to_depth


def _reflect(m, n):
    """Reflect once into [0, n), as the kernels' ``reflect`` does."""
    m = np.abs(m)
    return np.where(m > n - 1, 2 * (n - 1) - m, m)


def _taps(hp: int, wp: int, c: int):
    """Broadcastable (j, k, tap, c) index grids of an (hp, wp, 4c) output."""
    return (np.arange(hp)[:, None, None, None], np.arange(wp)[None, :, None, None],
            np.arange(4)[None, None, :, None], np.arange(c)[None, None, None, :])


# -- K1: s2d -> padded s2d ---------------------------------------------------

def _check(y: torch.Tensor, extra_rows: int) -> int:
    """Validate the input; return the output's row count."""
    if y.ndim != 4:
        raise ValueError(f"expected (B, hs, ws, 4C), got shape {tuple(y.shape)}")
    _, hs, ws, c4 = y.shape
    if hs < 2 or ws < 2 or c4 % 4 or c4 == 0:
        raise ValueError(f"need hs, ws >= 2 and 4C channels, got shape {tuple(y.shape)}")
    hp = hs + 3 + extra_rows
    if extra_rows < 0 or 2 * hp - 3 > 2 * (2 * hs - 1) + 1:
        raise ValueError(f"extra_rows={extra_rows} exceeds the reflect range of hs={hs}")
    return hp


def s2d_realign_pad3_plain(y: torch.Tensor, extra_rows: int = 0) -> torch.Tensor:
    """(B, hs, ws, 4C) -> (B, hs+3+extra_rows, ws+3, 4C): the composition
    d2s -> reflect pad 3 (plus 2*extra_rows more fine rows at the bottom)
    -> s2d."""
    _check(y, extra_rows)
    return space_to_depth(reflect_pad_hw(depth_to_space(y), 3, 3 + 2 * extra_rows, 3, 3))


def _source_index(hs: int, ws: int, c: int, extra_rows: int = 0) -> np.ndarray:
    """K1's index map in numpy: flat offset into one batch element of y for
    each output element, shape (hs+3+extra_rows, ws+3, 4c)."""
    hp = hs + 3 + extra_rows
    j, k, tap, cc = _taps(hp, ws + 3, c)
    fm = _reflect(2 * j + tap // 2 - 3, 2 * hs)
    fn = _reflect(2 * k + tap % 2 - 3, 2 * ws)
    src = (((fm // 2) * ws + fn // 2) * 4 + (fm % 2) * 2 + fn % 2) * c + cc
    return src.reshape(hp, ws + 3, 4 * c)


@functools.cache
def _launcher():
    return build.c_function("realign", "s2d_realign_pad3_launch", "ppliiiii")


def s2d_realign_pad3(y: torch.Tensor, extra_rows: int = 0) -> torch.Tensor:
    """(B, hs, ws, 4C) s2d tensor -> (B, hs+3+extra_rows, ws+3, 4C); rows
    [0, hs+3) equal ``space_to_depth(reflect_pad(depth_to_space(y), 3))``.
    A CUDA tensor runs the kernel (or raises); a CPU tensor takes the plain
    version. ``s2d_realign_pad3.launches`` counts kernel launches."""
    if y.device.type == "cpu":
        return s2d_realign_pad3_plain(y, extra_rows)
    hp = _check(y, extra_rows)
    build.check_operand("s2d_realign_pad3", y)
    b, hs, ws, c4 = y.shape
    out = y.new_empty((b, hp, ws + 3, c4))
    build.launch("s2d_realign_pad3", _launcher(), y, y.data_ptr(), out.data_ptr(), b, hs, ws,
                 c4 // 4, y.element_size(), hp)
    s2d_realign_pad3.launches += 1
    return out


s2d_realign_pad3.launches = 0


# -- K2: fine -> padded s2d --------------------------------------------------

def _check_front(x: torch.Tensor, extra_rows: int) -> int:
    """Validate K2's input; return the output's row count."""
    if x.ndim != 4:
        raise ValueError(f"expected (B, H, W, C), got shape {tuple(x.shape)}")
    _, h, w, c = x.shape
    if h < 4 or w < 4 or h % 2 or w % 2 or c == 0:
        raise ValueError(f"need even H, W >= 4 and C >= 1, got shape {tuple(x.shape)}")
    hp = h // 2 + 3 + extra_rows
    if extra_rows < 0 or 2 * hp - 3 > 2 * (h - 1) + 1:
        raise ValueError(f"extra_rows={extra_rows} exceeds the reflect range of H={h}")
    return hp


def s2d_pad3_plain(x: torch.Tensor, extra_rows: int = 0) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2+3+extra_rows, W/2+3, 4C): reflect pad 3 (plus
    2*extra_rows more rows at the bottom), then s2d."""
    _check_front(x, extra_rows)
    return space_to_depth(reflect_pad_hw(x, 3, 3 + 2 * extra_rows, 3, 3))


def _front_source_index(h: int, w: int, c: int, extra_rows: int = 0) -> np.ndarray:
    """K2's index map in numpy: flat offset into one batch element of x for
    each output element, shape (H/2+3+extra_rows, W/2+3, 4c)."""
    hp, wp = h // 2 + 3 + extra_rows, w // 2 + 3
    j, k, tap, cc = _taps(hp, wp, c)
    fm = _reflect(2 * j + tap // 2 - 3, h)
    fn = _reflect(2 * k + tap % 2 - 3, w)
    return ((fm * w + fn) * c + cc).reshape(hp, wp, 4 * c)


@functools.cache
def _front_launcher():
    return build.c_function("realign", "s2d_pad3_launch", "ppliiiii")


def s2d_pad3(x: torch.Tensor, extra_rows: int = 0) -> torch.Tensor:
    """(B, H, W, C) fine tensor -> (B, H/2+3+extra_rows, W/2+3, 4C); rows
    [0, H/2+3) equal ``space_to_depth(reflect_pad(x, 3))`` bit for bit.
    A CUDA tensor runs the kernel (or raises); a CPU tensor takes the plain
    version. ``s2d_pad3.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return s2d_pad3_plain(x, extra_rows)
    hp = _check_front(x, extra_rows)
    build.check_operand("s2d_pad3", x)
    b, h, w, c = x.shape
    out = x.new_empty((b, hp, w // 2 + 3, 4 * c))
    build.launch("s2d_pad3", _front_launcher(), x, x.data_ptr(), out.data_ptr(), b, h, w, c,
                 x.element_size(), hp)
    s2d_pad3.launches += 1
    return out


s2d_pad3.launches = 0
