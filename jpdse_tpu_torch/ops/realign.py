"""Grid re-alignment of an s2d tensor (kernel K1), the port of
``jpdse_tpu/ops/pallas/realign.py::s2d_realign_pad3_pallas``.

Every fast trunk's back stage re-aligns the s2d grid before its 7x7 tail:
``space_to_depth(reflect_pad(depth_to_space(y), 3))``. The CUDA kernel
(``csrc/realign.cu``) does it in one pass; :func:`s2d_realign_pad3_plain`
is its plain PyTorch version, which the wrapper takes for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from jpdse_tpu_torch.models.layers import reflect_pad_hw
from jpdse_tpu_torch.ops.s2d import depth_to_space, space_to_depth

_DTYPES = (torch.float32, torch.bfloat16)


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
    """The kernel's index map in numpy: flat offset into one batch element
    of y for each output element, shape (hs+3+extra_rows, ws+3, 4c)."""
    hp = hs + 3 + extra_rows

    def reflect(m, n):
        m = np.abs(m)
        return np.where(m > n - 1, 2 * (n - 1) - m, m)

    j = np.arange(hp)[:, None, None, None]
    k = np.arange(ws + 3)[None, :, None, None]
    tap = np.arange(4)[None, None, :, None]
    cc = np.arange(c)[None, None, None, :]
    fm = reflect(2 * j + tap // 2 - 3, 2 * hs)
    fn = reflect(2 * k + tap % 2 - 3, 2 * ws)
    src = (((fm // 2) * ws + fn // 2) * 4 + (fm % 2) * 2 + fn % 2) * c + cc
    return src.reshape(hp, ws + 3, 4 * c)


@functools.cache
def _launcher():
    from jpdse_tpu_torch.ops.build import load_library

    fn = load_library("realign").s2d_realign_pad3_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def s2d_realign_pad3(y: torch.Tensor, extra_rows: int = 0) -> torch.Tensor:
    """(B, hs, ws, 4C) s2d tensor -> (B, hs+3+extra_rows, ws+3, 4C); rows
    [0, hs+3) equal ``space_to_depth(reflect_pad(depth_to_space(y), 3))``.
    A CUDA tensor runs the kernel (or raises); a CPU tensor takes the plain
    version. ``s2d_realign_pad3.launches`` counts kernel launches."""
    if y.device.type == "cpu":
        return s2d_realign_pad3_plain(y, extra_rows)
    if y.device.type != "cuda":
        raise ValueError(f"s2d_realign_pad3: unsupported device {y.device}")
    hp = _check(y, extra_rows)
    if y.dtype not in _DTYPES:
        raise TypeError(f"s2d_realign_pad3: unsupported dtype {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("s2d_realign_pad3: input must be contiguous")
    b, hs, ws, c4 = y.shape
    out = torch.empty((b, hp, ws + 3, c4), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = _launcher()(
            y.data_ptr(), out.data_ptr(), b, hs, ws, c4 // 4, y.element_size(), hp,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"s2d_realign_pad3: kernel launch failed with CUDA error {rc}")
    s2d_realign_pad3.launches += 1
    return out


s2d_realign_pad3.launches = 0
