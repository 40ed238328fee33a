"""The s2d head conv (kernel K4), the port of
``jpdse_tpu/ops/pallas/head_conv.py::head_conv_s2d_pallas``.

With ``fast.head_pallas`` on, a wide trunk head's 7x7 conv runs as a VALID
kp x kp (kp=4) conv of the s2d-padded input against w-folded weights
(``ops/s2d.py::weights_fold_w``), one kernel row's kp width taps folded
into one contraction of kp*C channels. The CUDA kernel
(``csrc/head_conv.cu``) computes it as an implicit GEMM with no im2col
copy: in bf16 on wgmma fed by a TMA ring, which needs C and N to be
multiples of 8 (:func:`padded_channels`: the serving producer writes xp's
channels padded and the weights get zero rows; the wrapper zero-pads a
copy of any other shape), and in fp32 on CUDA cores. :func:`head_conv_s2d_plain` is its plain PyTorch
version (the convolution against the unfolded weights), which the wrapper
takes for CPU tensors.

:func:`head_conv_gemm` is the same main loop on a materialised (M, K)
matrix (the port of the TPU probes ``tools/bench_pallas_matmul.py::
pallas_mm`` and ``tools/bench_head_kernel_probe.py``'s ``nocopy``): it
measures the GEMM without the windowing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jpdse_tpu_torch.ops import build
from jpdse_tpu_torch.ops.s2d import conv_valid

# output rows a grid step of the Pallas kernel emits: its producer pads xp
# with head_conv_extra_rows so the kernel's row views stay in bounds
_PALLAS_BH = 4


def head_conv_extra_rows(ho: int, kp: int = 4, bh: int = _PALLAS_BH) -> int:
    """Bottom rows beyond the VALID conv's ho + kp - 1 that the JAX
    package's producer appends to xp (``head_conv.py:54``); the port keeps
    its producer. The CUDA kernel reads none of them."""
    n_tiles = -(-ho // bh)
    return max(0, (n_tiles + 1) * bh - (ho + kp - 1))


def padded_channels(c: int) -> int:
    """xp's channel count as K4's producer writes it: C rounded up to a
    multiple of 8, so that a bf16 pixel row is a multiple of the 16 bytes a
    TMA stride needs (the netG head's 156 -> 160)."""
    return -(-c // 8) * 8


_WGMMA_BM, _WGMMA_BN, _WGMMA_BK = 128, 256, 32  # csrc/head_conv.cu wgmma_path kBM, kBN, kBK


def _wgmma_tiles(b: int, ho: int, wo: int) -> int:
    """Output tiles of the wgmma route: 128 pixels of one output row each."""
    return b * ho * -(-wo // _WGMMA_BM)


def _wgmma_boxes(hp: int, wp: int, c: int, kp: int, ho: int, wo: int, t: int):
    """The TMA boxes the wgmma route's producer loads for output tile t, in
    order, as (A row, A column, B row): A is xp viewed as (B*Hp*Wp, C), a
    box 128 rows x 32 columns; B is w viewed as (kp*kp*C, N), a box 32 rows
    x N. Columns past C and rows past the end read as zeros. The mirror of
    the producer loop in ``csrc/head_conv.cu``."""
    tpr = -(-wo // _WGMMA_BM)
    jt, bi = t % tpr, t // tpr
    i, bb = bi % ho, bi // ho
    a_row = (bb * hp + i) * wp + jt * _WGMMA_BM
    steps = -(-c // _WGMMA_BK)
    for s in range(kp * kp * steps):
        tap, cb = divmod(s, steps)
        yield a_row + (tap // kp) * wp + tap % kp, cb * _WGMMA_BK, tap * c + cb * _WGMMA_BK


def _wgmma_tile_pixels(ho: int, wo: int, t: int):
    """The output pixel (flat index into (B*ho*wo)) of each of tile t's 128
    rows, or -1 past the output row's end: the epilogue's map."""
    tpr = -(-wo // _WGMMA_BM)
    jt, bi = t % tpr, t // tpr
    j = jt * _WGMMA_BM + np.arange(_WGMMA_BM)
    return np.where(j < wo, bi * wo + j, -1)


def _check(xp: torch.Tensor, w_folded: torch.Tensor, kp: int, ho):
    """Validate the operands; return (ho, wo, N)."""
    if xp.ndim != 4 or w_folded.ndim != 3:
        raise ValueError(f"expected xp (B, Hp, Wp, C) and w (kp, kp*C, N), got "
                         f"{tuple(xp.shape)} and {tuple(w_folded.shape)}")
    _, hp, wp, c = xp.shape
    kdy, ktap, n = w_folded.shape
    if kdy != kp or ktap != kp * c:
        raise ValueError(f"w_folded {tuple(w_folded.shape)} does not fold kp={kp} taps of C={c}")
    ho = hp - kp + 1 if ho is None else ho
    wo = wp - kp + 1
    if ho < 1 or wo < 1 or ho + kp - 1 > hp:
        raise ValueError(f"ho={ho} needs {ho + kp - 1} input rows, xp has {hp} (kp={kp})")
    return ho, wo, n


def _unfold(w_folded: torch.Tensor, kp: int, c: int) -> torch.Tensor:
    """(kp, kp*C, N) -> the OIHW weight of the same conv."""
    return w_folded.reshape(kp, kp, c, -1).permute(3, 2, 0, 1)


def head_conv_s2d_plain(xp: torch.Tensor, w_folded: torch.Tensor, kp: int = 4,
                        ho: int | None = None) -> torch.Tensor:
    """VALID (kp, kp) conv of xp's rows [0, ho+kp-1) against the unfolded
    weights: (B, Hp, Wp, C) -> (B, ho, Wp-kp+1, N)."""
    ho, _, _ = _check(xp, w_folded, kp, ho)
    return conv_valid(xp[:, : ho + kp - 1], _unfold(w_folded, kp, xp.shape[-1]))


@functools.cache
def _launcher():
    return build.c_function("head_conv", "head_conv_s2d_launch", "pppliiiiiii")


def _pad_operands(xp: torch.Tensor, w_folded: torch.Tensor, kp: int, cp: int, np_: int):
    """xp with its channels zero-padded to cp, and w_folded with zero rows
    for the new channels of each tap and zero columns up to np_ outputs."""
    c, n = xp.shape[-1], w_folded.shape[-1]
    xp = torch.nn.functional.pad(xp, (0, cp - c))
    w = torch.nn.functional.pad(w_folded.reshape(kp, kp, c, n), (0, np_ - n, 0, cp - c))
    return xp, w.reshape(kp, kp * cp, np_)


def head_conv_s2d(xp: torch.Tensor, w_folded: torch.Tensor, kp: int = 4,
                  ho: int | None = None) -> torch.Tensor:
    """VALID (kp, kp) conv of ``xp`` (B, Hp, Wp, C) against w-folded weights
    ``w_folded`` (kp, kp*C, N), accumulated in fp32; returns
    (B, ho, Wp-kp+1, N) in xp's dtype. ``ho`` defaults to Hp - kp + 1; rows
    of xp past ho + kp - 1 are never read. A CUDA tensor runs the kernel
    (or raises); a CPU tensor takes the plain version.
    ``head_conv_s2d.launches`` counts kernel launches."""
    if xp.device.type == "cpu":
        return head_conv_s2d_plain(xp, w_folded, kp, ho)
    ho, wo, n = _check(xp, w_folded, kp, ho)
    build.check_operand("head_conv_s2d", xp)
    build.check_operand("head_conv_s2d", w_folded, (xp.dtype,))
    b, hp, wp, c = xp.shape
    cp, np_ = c, n
    if xp.dtype == torch.bfloat16:
        if n > _WGMMA_BN:
            raise ValueError(f"head_conv_s2d: bf16 takes N <= {_WGMMA_BN}, got N={n}")
        cp, np_ = padded_channels(c), padded_channels(n)
        if (cp, np_) != (c, n):  # no serving path sends these: zero-pad a copy
            xp, w_folded = _pad_operands(xp, w_folded, kp, cp, np_)
    elif c % 4 or n % 4:
        raise ValueError(f"head_conv_s2d: fp32 takes C={c} and N={n} in multiples of 4")
    out = xp.new_empty((b, ho, wo, np_))
    build.launch("head_conv_s2d", _launcher(), xp, xp.data_ptr(), w_folded.data_ptr(),
                 out.data_ptr(), b, hp, wp, cp, np_, kp, ho, xp.element_size())
    head_conv_s2d.launches += 1
    return out if np_ == n else out[..., :n].contiguous()


head_conv_s2d.launches = 0


# -- dense-A mode: the same main loop on a materialised (M, K) matrix --------

def head_conv_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N), accumulated in fp32, one cast to a's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


@functools.cache
def _gemm_launcher():
    return build.c_function("head_conv", "head_conv_gemm_launch", "ppplii")


def head_conv_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K4's dense-A mode: bf16 (M, K) @ (K, N) -> (M, N), fp32 accumulate,
    K and N multiples of 8, N <= 256. A CUDA tensor runs K4's wgmma main
    loop (or raises); a CPU tensor takes the plain version.
    ``head_conv_gemm.launches`` counts kernel launches."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) and (K, N), got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device.type == "cpu":
        return head_conv_gemm_plain(a, b)
    build.check_operand("head_conv_gemm", a, (torch.bfloat16,))
    build.check_operand("head_conv_gemm", b, (torch.bfloat16,))
    m, k = a.shape
    n = b.shape[1]
    if k % 8 or n % 8 or n > 256:
        raise ValueError(f"head_conv_gemm: K={k} and N={n} must be multiples of 8, N <= 256")
    out = a.new_empty((m, n))
    build.launch("head_conv_gemm", _gemm_launcher(), a, a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), m, k, n)
    head_conv_gemm.launches += 1
    return out


head_conv_gemm.launches = 0
