"""Space-to-depth transforms, the port of ``jpdse_tpu/ops/s2d.py``.

An (H, W, C) tensor is stored as (H/2, W/2, 4C) with channel index
``(su*2 + sv)*C + c``. The fast path runs the codec's full-resolution layers
(7x7 head, first stride-2 downsample, last transposed conv, 7x7 tail) in
that domain with transformed weights: the same math, equal up to float
reassociation. The weight transforms are numpy copies of the JAX package's,
in its (kh, kw, Cin, Cout) layout; ``hwio_to_oihw`` hands them to PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from jpdse_tpu_torch.models.layers import conv_nhwc


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C); channel = (su*2 + sv)*C + c."""
    b, h, w, c = x.shape
    assert h % 2 == 0 and w % 2 == 0, (h, w)
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    """Inverse of space_to_depth."""
    b, h2, w2, c4 = y.shape
    c = c4 // 4
    y = y.reshape(b, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, h2 * 2, w2 * 2, c)


def hwio_to_oihw(w: np.ndarray, device, dtype) -> torch.Tensor:
    """(kh, kw, Cin, Cout) numpy weight -> OIHW tensor in channels-last
    memory, the layout cuDNN reads beside NHWC activations."""
    t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    return t.to(device=device, dtype=dtype).contiguous(memory_format=torch.channels_last)


def oihw_to_hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().float().cpu().numpy().transpose(2, 3, 1, 0)


def conv_s1_weights_to_s2d(w: np.ndarray) -> np.ndarray:
    """(k, k, Cin, Cout) stride-1 odd-k conv -> s2d-domain weights
    (k', k', 4Cin, 4Cout), k' = k//2 + 1, for a fine input already padded by
    (k-1)/2 and converted with space_to_depth; a VALID conv then yields the
    s2d form of the fine output. Fine output (2i+di, 2j+dj) reads padded fine
    row 2(i+u') + su through tap u = 2u' + su - di when 0 <= u < k."""
    k, k2, cin, cout = w.shape
    assert k == k2 and k % 2 == 1
    kp = k // 2 + 1
    wp = np.zeros((kp, kp, 4 * cin, 4 * cout), w.dtype)
    for di in range(2):
        for dj in range(2):
            for su in range(2):
                for sv in range(2):
                    for up in range(kp):
                        u = 2 * up + su - di
                        if not (0 <= u < k):
                            continue
                        for vp in range(kp):
                            v = 2 * vp + sv - dj
                            if not (0 <= v < k):
                                continue
                            ci = su * 2 + sv
                            co = di * 2 + dj
                            wp[up, vp, ci * cin : (ci + 1) * cin,
                               co * cout : (co + 1) * cout] = w[u, v]
    return wp


def conv_s2_weights_from_s2d_nopad(w: np.ndarray) -> np.ndarray:
    """(3, 3, Cin, Cout) stride-2 pad-1 conv -> (2, 2, 4Cin, Cout) weights
    for an unpadded s2d input with a (1, 0) zero pad on each spatial dim:
    out[i] reads fine rows [2i-1, 2i+2) = s2d row i-1 / su=1, then s2d row
    i / su=0,1."""
    k, k2, cin, cout = w.shape
    assert k == 3 and k2 == 3
    taps = {(0, 1): 0, (1, 0): 1, (1, 1): 2}  # (u', su) -> fine tap
    wp = np.zeros((2, 2, 4 * cin, cout), w.dtype)
    for (up, su), t in taps.items():
        for (vp, sv), s in taps.items():
            ci = su * 2 + sv
            wp[up, vp, ci * cin : (ci + 1) * cin, :] = w[t, s]
    return wp


def convT_s2_weights_to_s2d(w: np.ndarray) -> np.ndarray:
    """(3, 3, Cin, Cout) effective correlation kernel g of a ConvTranspose
    (stride 2, pad 1, output_padding 1) -> (2, 2, Cin, 4Cout) weights giving
    the 2x-upsampled output directly in s2d form, for the input padded by
    (0, 1) per spatial dim and a VALID stride-1 conv. Per axis: di=0 ->
    g[1] x[i]; di=1 -> g[0] x[i] + g[2] x[i+1]."""
    k, k2, cin, cout = w.shape
    assert k == 3 and k2 == 3
    taps = {0: [(0, 1)], 1: [(0, 0), (1, 2)]}
    wp = np.zeros((2, 2, cin, 4 * cout), w.dtype)
    for di in range(2):
        for dj in range(2):
            co = di * 2 + dj
            for up, u in taps[di]:
                for vp, v in taps[dj]:
                    wp[up, vp, :, co * cout : (co + 1) * cout] += w[u, v]
    return wp


def instance_norm_s2d(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the fine (H, W) extent of an s2d tensor: the
    statistics of each fine channel pool its 4 sub-position groups. One-pass
    fp32 moments, as the JAX package computes them (its default, unshifted
    form)."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x32 = x.float()
    n = h * w * 4
    s1 = x32.sum(dim=(1, 2)).view(b, 4, c).sum(dim=1)
    s2 = (x32 * x32).sum(dim=(1, 2)).view(b, 4, c).sum(dim=1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    mean4 = mean.repeat(1, 4)[:, None, None, :]
    rstd4 = torch.rsqrt(var + eps).repeat(1, 4)[:, None, None, :]
    return ((x32 - mean4) * rstd4).to(x.dtype)


# VALID conv of an NHWC tensor with an OIHW weight, bias fused
conv_valid = conv_nhwc
