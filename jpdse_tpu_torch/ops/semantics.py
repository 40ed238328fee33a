"""Semantic-input transforms (NHWC), the port of ``jpdse_tpu/ops/semantics.py``:
one-hot label map plus instance-edge channel, the netE4label input, and the
semantic masking of the visuals (``sem_mask``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def one_hot_label(label: torch.Tensor, num_channels: int, dtype=torch.float32) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 1) integer (or integer-valued float) label map ->
    one-hot (B, H, W, num_channels). Values are clipped into range."""
    if label.ndim == 4:
        label = label[..., 0]
    label = label.to(torch.int64).clamp(0, num_channels - 1)
    return F.one_hot(label, num_channels).to(dtype)


def instance_edges(inst: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Instance-id map -> (B, H, W, 1) boundary map in {0, 1}: both pixels
    on either side of an id change are marked."""
    if inst.ndim == 3:
        inst = inst[..., None]
    edge = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    diff_w = inst[:, :, 1:] != inst[:, :, :-1]
    diff_h = inst[:, 1:] != inst[:, :-1]
    edge[:, :, 1:] |= diff_w
    edge[:, :, :-1] |= diff_w
    edge[:, 1:] |= diff_h
    edge[:, :-1] |= diff_h
    return edge.to(dtype)


def degrade_ids(m: Optional[torch.Tensor], factor: int) -> Optional[torch.Tensor]:
    """Nearest down-then-up of an id map (the decoder-side view of semantics
    shipped at 1/factor resolution); sizes need not divide."""
    if m is None or factor <= 1:
        return m
    had_c = m.ndim == 4
    x = m[..., 0] if had_c else m
    h, w = x.shape[1], x.shape[2]
    s = x[:, ::factor, ::factor]
    up = s.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)[:, :h, :w]
    return up[..., None] if had_c else up


def prepare_semantics(
    label: Optional[torch.Tensor],
    instance: Optional[torch.Tensor],
    num_channels: int,
    no_label: bool = False,
    no_instance: bool = False,
    dtype=torch.float32,
) -> Optional[torch.Tensor]:
    """One-hot label (+ edge channel concatenated last), or None when both
    are disabled."""
    label_tensor = None
    if not no_label:
        label_tensor = one_hot_label(label, num_channels, dtype=dtype)
    if not no_instance:
        edge = instance_edges(instance, dtype=dtype)
        label_tensor = edge if label_tensor is None else torch.cat([label_tensor, edge], dim=-1)
    return label_tensor


def sem_mask(img: torch.Tensor, label: torch.Tensor, binary_mask: bool = False,
             img_nc: int = 3) -> torch.Tensor:
    """Semantic masking, NHWC: ``img`` (B, H, W, img_nc), or (B, H, W,
    L * img_nc) with one image per semantic channel, gated by each of the
    ``label`` (B, H, W, L) channels in turn (channel block i is the image,
    or ones with ``binary_mask``, times label channel i). Returns
    (B, H, W, L * img_nc)."""
    b, h, w, n = label.shape
    c_in = img.shape[-1]
    if c_in > img_nc:
        if c_in // img_nc != n:
            raise ValueError(
                f"img channels {c_in} not compatible with {n} semantic channels x {img_nc}")
        block = img.reshape(b, h, w, n, img_nc)
    else:
        block = img[..., None, :].expand(b, h, w, n, img_nc)
    if binary_mask:
        block = torch.ones_like(block)
    return (block * label[..., :, None]).reshape(b, h, w, n * img_nc)
