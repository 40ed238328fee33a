"""Fused InstanceNorm (+ReLU) (+residual) (kernel K3, forward), the port of
``jpdse_tpu/ops/pallas/instance_norm.py::fused_instance_norm``.

With ``model.fused_instance_norm`` on, every norm site of the standard
path's modules (``models/layers.py``, ``models/generator.py``) runs as one
call: fp32 statistics over H x W (mean, then the biased variance about it,
eps 1e-5, no affine), then ReLU if asked, then the residual added in fp32,
then one cast to the input's dtype. The CUDA kernel
(``csrc/instance_norm.cu``) is one cooperative launch that splits each slab
across the blocks resident on the card (:func:`plan`), so it takes a slab
of any size; :func:`fused_instance_norm_plain` is its plain PyTorch
version, which the wrapper takes for CPU tensors.

Forward only: the backward comes with training.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from jpdse_tpu_torch.ops import build

THREADS = 512  # csrc/instance_norm.cu kThreads
MAX_CHUNKS = 1024  # bounds the partials' workspace; the launcher keeps to it


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


def vector_width(c: int, elt_size: int, aligned: bool = True) -> int:
    """Channels a thread moves as one word: 16 bytes' worth when C divides
    into them and the pointers are 16-byte aligned, else 1."""
    v = 16 // elt_size
    return v if aligned and c % v == 0 else 1


def _tiling(c: int, vec: int):
    """(channel groups, groups per item, channel tiles, pixel lanes), as
    the kernel's ``Plan`` derives them."""
    groups = c // vec
    tile = min(groups, THREADS)
    return groups, tile, -(-groups // tile), THREADS // tile


def max_chunks(hw: int, c: int, vec: int) -> int:
    """The most chunks :func:`plan` cuts a slab into, on any card: the
    partials' workspace is sized by it."""
    return min(MAX_CHUNKS, -(-hw // _tiling(c, vec)[3]))


def plan(b: int, hw: int, c: int, vec: int, max_blocks: int):
    """(grid, chunks, rows_per_chunk) of one launch on a card that holds
    ``max_blocks`` resident blocks (SM count x blocks per SM), the mirror
    of the launcher's ``make_plan``. Each slab, a batch element's rows for
    one channel tile, is cut into ``chunks`` chunks of ``rows_per_chunk``
    rows, one block item each; with more slabs than blocks, a block takes
    whole slabs in turn (:func:`block_items`)."""
    _, _, tiles, _ = _tiling(c, vec)
    slabs = b * tiles
    chunks = 1 if slabs >= max_blocks else min(max_blocks // slabs, max_chunks(hw, c, vec))
    rows = -(-hw // chunks)
    chunks = -(-hw // rows)
    return min(max_blocks, slabs * chunks), chunks, rows


def block_items(b: int, hw: int, c: int, vec: int, grid: int, chunks: int, rows: int):
    """Block k's items in the kernel's order, as (batch element, first and
    end channel, first and end row): the numpy-free mirror of the kernel's
    ``item`` and its loop ``q = blockIdx.x; q < items; q += gridDim.x``."""
    groups, tile, tiles, _ = _tiling(c, vec)
    out = [[] for _ in range(grid)]
    for k in range(grid):
        for q in range(k, b * tiles * chunks, grid):
            slab, chunk = divmod(q, chunks)
            bi, t = divmod(slab, tiles)
            g0, g1 = t * tile, min((t + 1) * tile, groups)
            out[k].append((bi, g0 * vec, g1 * vec, chunk * rows, min((chunk + 1) * rows, hw)))
    return out


@functools.cache
def _launcher():
    return build.c_function("instance_norm", "instance_norm_launch", "pppppliiiiiif")


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
    y = x.new_empty(x.shape)
    ptrs = [x.data_ptr(), y.data_ptr()] + ([] if residual is None else [residual.data_ptr()])
    vec = vector_width(c, x.element_size(), all(p % 16 == 0 for p in ptrs))
    cap = max_chunks(hw, c, vec)
    # one fp32 workspace: the partials (b, cap, c, 3), then the statistics (b, c, 2)
    work = x.new_empty(b * c * (3 * cap + 2), dtype=torch.float32)
    build.launch("fused_instance_norm", _launcher(), x, x.data_ptr(),
                 0 if residual is None else residual.data_ptr(), y.data_ptr(),
                 work.data_ptr(), work.data_ptr() + 4 * b * c * 3 * cap, hw, b, c, cap,
                 int(relu), int(vec > 1), x.element_size(), eps)
    fused_instance_norm.launches += 1
    return y


fused_instance_norm.launches = 0
