"""Per-channel mean / std of a dataset's images, for setting
``data.normalize_mean`` / ``data.normalize_std``; the port of
``jpdse_tpu/data/stats.py``.

Cityscapes' train split is roughly mean (0.287, 0.325, 0.284), std
(0.176, 0.181, 0.178) in [0, 1] scale."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
from PIL import Image

CITYSCAPES_MEAN = (0.287, 0.325, 0.284)
CITYSCAPES_STD = (0.176, 0.181, 0.178)


def get_mean_and_std_from_paths(
    paths: Iterable[str],
) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming (Welford-style by moments) per-channel mean/std of images in
    [0, 1] scale."""
    n_pix = 0
    s1 = np.zeros(3, np.float64)
    s2 = np.zeros(3, np.float64)
    for p in paths:
        arr = np.asarray(Image.open(p).convert("RGB"), np.float64) / 255.0
        n_pix += arr.shape[0] * arr.shape[1]
        s1 += arr.sum(axis=(0, 1))
        s2 += (arr**2).sum(axis=(0, 1))
    if n_pix == 0:
        raise ValueError("no images")
    mean = s1 / n_pix
    var = s2 / n_pix - mean**2
    return mean.astype(np.float32), np.sqrt(np.maximum(var, 0)).astype(np.float32)


def get_mean_and_std(dataset) -> Tuple[np.ndarray, np.ndarray]:
    """Mean/std over a PairedDataset's image paths."""
    return get_mean_and_std_from_paths(dataset.image_paths)
