"""Label colormaps for the evaluation gallery, the port of
``jpdse_tpu/utils/colormap.py``.

The Cityscapes 35-color table and the procedural bit-twiddling colormap are
standard published palettes (originally from the Cityscapes scripts and
pytorch-seg); regenerated here.
"""

from __future__ import annotations

import numpy as np

CITYSCAPES_COLORS = np.array(
    [
        (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0), (0, 0, 0),
        (111, 74, 0), (81, 0, 81), (128, 64, 128), (244, 35, 232),
        (250, 170, 160), (230, 150, 140), (70, 70, 70), (102, 102, 156),
        (190, 153, 153), (180, 165, 180), (150, 100, 100), (150, 120, 90),
        (153, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
        (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
        (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 0, 90),
        (0, 0, 110), (0, 80, 100), (0, 0, 230), (119, 11, 32), (0, 0, 142),
    ],
    dtype=np.uint8,
)


# COCO-stuff: a handful of semantically important stuff classes get fixed
# natural colors instead of the procedural palette (misc.py:248-259);
# ids per the COCO-stuff label map (sea=155, sky-other=157, tree=169,
# clouds=106, grass=124).
COCO_COLOR_OVERRIDES = {
    155: (54, 62, 167),  # sea
    157: (95, 219, 255),  # sky-other
    169: (140, 104, 47),  # tree
    106: (170, 170, 170),  # clouds
    124: (29, 195, 49),  # grass
}


def label_colormap(n: int) -> np.ndarray:
    """(n, 3) uint8 colormap; the Cityscapes palette for n==35, else the
    procedural bit-reversal palette (misc.py:229-247), with the COCO-stuff
    natural-color overrides when n==182."""
    if n == 35:
        return CITYSCAPES_COLORS.copy()
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        idx = i + 1
        for j in range(7):
            bits = [(idx >> k) & 1 for k in range(3)]
            r ^= bits[0] << (7 - j)
            g ^= bits[1] << (7 - j)
            b ^= bits[2] << (7 - j)
            idx >>= 3
        cmap[i] = (r, g, b)
    if n == 182:
        for i, color in COCO_COLOR_OVERRIDES.items():
            cmap[i] = color
    return cmap


def colorize_labels(label_ids: np.ndarray, n: int) -> np.ndarray:
    """(H, W) integer ids -> (H, W, 3) uint8 color image."""
    cmap = label_colormap(n)
    ids = np.clip(label_ids.astype(np.int64), 0, n - 1)
    return cmap[ids]
