"""Directory walking for image datasets, the port of
``jpdse_tpu/data/folder.py``."""

from __future__ import annotations

import os
from typing import List

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG",
    ".png", ".PNG", ".ppm", ".PPM", ".bmp", ".BMP", ".tiff", ".webp",
)


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def make_dataset(directory: str, recursive: bool = True) -> List[str]:
    """Every image path under ``directory``, walking the whole tree
    (``recursive`` is kept for the callers' signature)."""
    if not (os.path.isdir(directory) or os.path.islink(directory)):
        raise ValueError(f"{directory} is not a valid directory")
    images = []
    for root, _, fnames in sorted(os.walk(directory, followlinks=True)):
        for fname in fnames:
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images
