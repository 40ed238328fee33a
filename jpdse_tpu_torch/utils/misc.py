"""Small host-side helpers, the port of ``jpdse_tpu/utils/misc.py:12-36``."""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np


def atoi(text: str):
    return int(text) if text.isdigit() else text


def natural_keys(text: str):
    """Human-order sort key: digit runs compare as numbers."""
    return [atoi(c) for c in re.split(r"(\d+)", text)]


def natural_sort(items: List[str]) -> List[str]:
    items.sort(key=natural_keys)
    return items


def mkdirs(path: str):
    os.makedirs(path, exist_ok=True)


def tensor2im(arr: np.ndarray, mean, std) -> np.ndarray:
    """Normalized HWC / NHWC float -> uint8: denormalize, x255, clip, and
    truncate (``astype(uint8)``)."""
    arr = np.asarray(arr, np.float32)
    x = (arr * np.asarray(std, np.float32) + np.asarray(mean, np.float32)) * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)
