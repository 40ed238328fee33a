"""The s2d head conv (kernel K4), the port of
``jpdse_tpu/ops/pallas/head_conv.py::head_conv_s2d_pallas``.

With ``fast.head_pallas`` on, a wide trunk head's 7x7 conv runs as a VALID
kp x kp (kp=4) conv of the s2d-padded input against w-folded weights
(``ops/s2d.py::weights_fold_w``), one kernel row's kp width taps folded
into one contraction of kp*C channels. The CUDA kernel
(``csrc/head_conv.cu``) computes it as an implicit GEMM with no im2col
copy; :func:`head_conv_s2d_plain` is its plain PyTorch version (the
convolution against the unfolded weights), which the wrapper takes for
CPU tensors.
"""

from __future__ import annotations

import functools

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
    if c % 4 or n % 4:
        raise ValueError(f"head_conv_s2d: C={c} and N={n} must be multiples of 4")
    out = xp.new_empty((b, ho, wo, n))
    build.launch("head_conv_s2d", _launcher(), xp, xp.data_ptr(), w_folded.data_ptr(),
                 out.data_ptr(), b, hp, wp, c, n, kp, ho, xp.element_size())
    head_conv_s2d.launches += 1
    return out


head_conv_s2d.launches = 0
