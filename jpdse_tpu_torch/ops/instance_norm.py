"""Fused InstanceNorm (+ReLU) (+residual) (kernel K3, forward), the port of
``jpdse_tpu/ops/pallas/instance_norm.py::fused_instance_norm``.

With ``model.fused_instance_norm`` on, every norm site of the standard
path's modules (``models/layers.py``, ``models/generator.py``) runs as one
call: fp32 statistics over H x W (mean, then the biased variance about it,
eps 1e-5, no affine), then ReLU if asked, then the residual added in fp32,
then one cast to the input's dtype. The CUDA kernel
(``csrc/instance_norm.cu``) splits the statistics across blocks, so it takes
a slab of any size; :func:`fused_instance_norm_plain` is its plain PyTorch
version, which the wrapper takes for CPU tensors.

Forward only: the backward comes with training.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from jpdse_tpu_torch.ops import build

_SM_COUNT = 132  # H100 SXM
_STATS_BLOCKS = _SM_COUNT * 8  # aim for ~8 statistics blocks per SM
_CHANNELS_PER_BLOCK = 32  # csrc/instance_norm.cu kChannels
_MIN_ROWS_PER_CHUNK = 64


def fused_instance_norm_plain(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                              relu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm(x) [+ReLU] [+residual] over (H, W) of an NHWC tensor:
    two-pass fp32 statistics, the residual added in fp32, one cast."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2), keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=(1, 2), keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def _chunks(b: int, hw: int, c: int):
    """(chunks, rows_per_chunk) splitting each slab's hw rows across blocks."""
    tiles = b * -(-c // _CHANNELS_PER_BLOCK)
    want = max(1, min(-(-hw // _MIN_ROWS_PER_CHUNK), -(-_STATS_BLOCKS // tiles)))
    rows = -(-hw // want)
    return -(-hw // rows), rows


@functools.cache
def _launcher():
    return build.c_function("instance_norm", "instance_norm_launch", "ppppplliiiiif")


def fused_instance_norm(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                        relu: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm(x) [+ReLU] [+residual] of an NHWC tensor (B, H, W, C),
    in x's dtype. A CUDA tensor runs the kernel (or raises); a CPU tensor
    takes the plain version. Forward only: raises when autograd would need
    a gradient. ``fused_instance_norm.launches`` counts kernel launches."""
    if torch.is_grad_enabled() and (
            x.requires_grad or (residual is not None and residual.requires_grad)):
        raise RuntimeError("fused_instance_norm is forward only: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.ndim != 4:
        raise ValueError(f"expected (B, H, W, C), got shape {tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} differs from x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_instance_norm_plain(x, residual, relu, eps)
    build.check_operand("fused_instance_norm", x)
    if residual is not None:
        build.check_operand("fused_instance_norm", residual, (x.dtype,))
    b, h, w, c = x.shape
    hw = h * w
    if hw * c >= 2**31 or b > 65535:
        raise ValueError(f"fused_instance_norm: slab {tuple(x.shape)} too large for the kernel")
    chunks, rows = _chunks(b, hw, c)
    y = x.new_empty(x.shape)
    partial = x.new_empty((b, chunks, c, 3), dtype=torch.float32)
    stats = x.new_empty((b, c, 2), dtype=torch.float32)
    build.launch("fused_instance_norm", _launcher(), x, x.data_ptr(),
                 0 if residual is None else residual.data_ptr(), y.data_ptr(),
                 partial.data_ptr(), stats.data_ptr(), hw, rows, b, c, chunks, int(relu),
                 x.element_size(), eps)
    fused_instance_norm.launches += 1
    return y


fused_instance_norm.launches = 0
