"""Semantic-input transforms (NHWC), the port of ``jpdse_tpu/ops/semantics.py``:
one-hot label map plus instance-edge channel, the netE4label input, and the
semantic masking of the visuals (``sem_mask``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from jpdse_tpu_torch.parallel import spatial


def one_hot_label(label: torch.Tensor, num_channels: int, dtype=torch.float32) -> torch.Tensor:
    """(B, H, W) or (B, H, W, 1) integer (or integer-valued float) label map ->
    one-hot (B, H, W, num_channels). Values are clipped into range."""
    if label.ndim == 4:
        label = label[..., 0]
    label = label.to(torch.int64).clamp(0, num_channels - 1)
    return F.one_hot(label, num_channels).to(dtype)


def instance_edges(inst: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Instance-id map -> (B, H, W, 1) boundary map in {0, 1}: both pixels
    on either side of an id change are marked. Under the spatial axis the H
    differences take one row of the neighbours' ids on each side (a repeat
    of the edge row at the global edges, which marks nothing)."""
    shard = spatial.current()
    hg = spatial.global_h(inst)
    if inst.ndim == 3:
        inst = inst[..., None]
    edge = torch.zeros(inst.shape, dtype=torch.bool, device=inst.device)
    diff_w = inst[:, :, 1:] != inst[:, :, :-1]
    edge[:, :, 1:] |= diff_w
    edge[:, :, :-1] |= diff_w
    if shard is not None:
        b = shard.bounds(hg)
        ext = spatial.take_rows(inst, hg, lambda s: range(b[s] - 1, b[s + 1] + 1), "replicate")
        diff_h = ext[:, 1:] != ext[:, :-1]
        edge |= diff_h[:, 1:] | diff_h[:, :-1]
    else:
        diff_h = inst[:, 1:] != inst[:, :-1]
        edge[:, 1:] |= diff_h
        edge[:, :-1] |= diff_h
    return spatial.mark(edge.to(dtype), hg) if shard is not None else edge.to(dtype)


def degrade_ids(m: Optional[torch.Tensor], factor: int) -> Optional[torch.Tensor]:
    """Nearest down-then-up of an id map (the decoder-side view of semantics
    shipped at 1/factor resolution); sizes need not divide. Under the
    spatial axis each of this rank's rows r takes global row
    ``factor (r // factor)``, fetched from its owner."""
    if m is None or factor <= 1:
        return m
    had_c = m.ndim == 4
    x = m[..., 0] if had_c else m
    h, w = x.shape[1], x.shape[2]
    shard = spatial.current()
    if shard is not None:
        hg = spatial.global_h(m)
        b = shard.bounds(hg)
        rows = spatial.take_rows(x, hg, lambda s: [r - r % factor for r in range(b[s], b[s + 1])])
        up = rows[:, :, ::factor].repeat_interleave(factor, dim=2)[:, :, :w]
        up = spatial.mark(up, hg)
    else:
        s = x[:, ::factor, ::factor]
        up = s.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)[:, :h, :w]
    return spatial.like(up[..., None], up) if had_c else up


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
    return spatial.like((block * label[..., :, None]).reshape(b, h, w, n * img_nc), img)


def sem_wise_distortion(label: torch.Tensor, real: torch.Tensor,
                        fake: torch.Tensor) -> torch.Tensor:
    """Per-class mean L1 distortion (the diagnostic of the reference's
    ``get_sem_wise_distortion``): for each channel of the one-hot ``label``
    (B, H, W, L), the sum over channels of |real - fake| ((B, H, W, C)
    each), summed over the class's pixels and divided by its pixel count;
    0 for a class with no pixels. Returns (L,). The reference passes
    ``sem_mask`` its arguments swapped, which mixes classes across image
    channels; this is the per-class reading its docstring describes, as
    the JAX package's."""
    diff = torch.sum(torch.abs(real - fake), dim=-1)
    num = torch.einsum("bhwl,bhw->l", label.to(diff.dtype), diff)
    den = torch.sum(label.to(diff.dtype), dim=(0, 1, 2))
    return torch.where(den > 0, num / torch.clamp(den, min=1.0), torch.zeros_like(num))
