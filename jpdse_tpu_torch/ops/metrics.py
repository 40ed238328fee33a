"""Distortion and rate metrics on the device, the port of
``jpdse_tpu/ops/metrics.py`` (NHWC tensors).

L1 / MSE / PSNR / MS-SSIM are computed on denormalized, uint8-quantized
images. MS-SSIM follows the package the original evaluation used
(pytorch-msssim by jorge-pessoa): an 11x11 Gaussian window (sigma 1.5)
applied with VALID padding, 5 levels with the Wang et al. weights, 2x2
average-pool (floor) downsampling, and prod(cs[:-1]^w[:-1]) *
ssim_last^w[-1]. Where that package would fail, as the JAX package does: a
level smaller than the window is zero-padded, and negative cs terms are
clamped at 0 before the weighted product. The Gaussian filter is a
depthwise ``F.conv2d`` in fp32 (TF32 off: a metric must not inherit a
reduced-precision default).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB."""
    m = mse(a.float(), b.float())
    return 10.0 * torch.log10(data_range**2 / torch.clamp(m, min=1e-12))


def denormalize_to_uint8(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Normalized NHWC float -> uint8-quantized float in [0, 255]:
    denormalize, x255, clip and floor, as ``tensor2im`` truncates."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    y = (x.float() * std + mean) * 255.0
    return torch.floor(torch.clamp(y, 0.0, 255.0))


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _gaussian_filter(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable depthwise Gaussian blur of an NHWC fp32 tensor, VALID
    padding; zero padding only where the input is smaller than the window."""
    c = img.shape[-1]
    g = torch.from_numpy(_gaussian_window(size, sigma)).to(img.device)
    kh = g.view(1, 1, size, 1).expand(c, 1, size, 1)
    kw = g.view(1, 1, 1, size).expand(c, 1, 1, size)
    pad = 0 if min(img.shape[1], img.shape[2]) >= size else size // 2
    x = img.permute(0, 3, 1, 2)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = F.conv2d(x, kh, padding=(pad, 0), groups=c)
        x = F.conv2d(x, kw, padding=(0, pad), groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return x.permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0, window_size: int = 11,
         sigma: float = 1.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean SSIM and contrast-structure (cs) term over an NHWC batch. The
    inputs are scaled to [0, 1] first: the E[x^2] - E[x]^2 variance form
    cancels badly in fp32 at the 255 scale."""
    scale = 1.0 / data_range
    a = a.float() * scale
    b = b.float() * scale
    c1 = 0.01**2
    c2 = 0.03**2

    def blur(x):
        return _gaussian_filter(x, window_size, sigma)

    mu_a, mu_b = blur(a), blur(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sig_a = blur(a * a) - mu_a2
    sig_b = blur(b * b) - mu_b2
    sig_ab = blur(a * b) - mu_ab
    cs_map = (2.0 * sig_ab + c2) / (sig_a + sig_b + c2)
    ssim_map = ((2.0 * mu_ab + c1) / (mu_a2 + mu_b2 + c1)) * cs_map
    return torch.mean(ssim_map), torch.mean(cs_map)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of an NHWC tensor, odd edges dropped."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 255.0, window_size: int = 11,
            sigma: float = 1.5, weights: Tuple[float, ...] = MSSSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM (5 levels) of NHWC inputs of any dtype."""
    a = a.float()
    b = b.float()
    mcs = []
    ssim_val = None
    for i in range(len(weights)):
        ssim_val, cs = ssim(a, b, data_range, window_size, sigma)
        mcs.append(cs)
        if i < len(weights) - 1:
            a, b = _avg_pool2(a), _avg_pool2(b)
    w = torch.tensor(weights, dtype=torch.float32, device=a.device)
    mcs_arr = torch.clamp(torch.stack(mcs[:-1]), min=0.0)
    ssim_last = torch.clamp(ssim_val, min=0.0)
    return torch.prod(mcs_arr ** w[:-1]) * ssim_last ** w[-1]


def bernoulli_shannon_bpp(code: torch.Tensor, num_pixels: int,
                          natural_log: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(shannon_bpp, actual_bpp) of one image's flat {0, 1} code: the
    entropy of a Bernoulli with p = mean(code), times the code's length,
    over the pixel count. log2 by default; ``natural_log`` gives the nats
    the original evaluation reported under the name bpp. The log itself is
    the device library's: it can differ from XLA's in the last bit."""
    code = code.reshape(-1).float()
    n_bits = code.shape[0]
    # the mean as XLA evaluates it (the sum, exact for a {0, 1} code, times
    # the fp32 reciprocal); 1e-6 keeps 1 - p representable in fp32
    p = torch.clamp(code.sum() * torch.tensor(1.0 / n_bits, dtype=torch.float32,
                                               device=code.device), 1e-6, 1.0 - 1e-6)
    if natural_log:
        ent = -p * torch.log(p) - (1 - p) * torch.log(1 - p)
    else:  # log2 as XLA evaluates it: log times the fp32 1 / ln 2
        inv_ln2 = torch.tensor(1.0 / np.log(2.0), dtype=torch.float32, device=code.device)
        ent = -p * (torch.log(p) * inv_ln2) - (1 - p) * (torch.log(1 - p) * inv_ln2)
    return ent * n_bits / num_pixels, torch.tensor(n_bits / num_pixels, dtype=torch.float32,
                                                   device=code.device)
