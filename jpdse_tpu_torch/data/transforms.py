"""Host-side image preprocessing with PIL and numpy, the port of
``jpdse_tpu/data/transforms.py``: one random parameter set (crop position
and a 50% flip) shared by the image, label and instance maps, the resize
modes (resize, scale_width, scale_shortside, crop, the power-of-32 snap of
'none', 'fixed' = crop_size x crop_size/aspect), bicubic for images and
nearest for id maps, then normalization to the model's space.
``sample_params`` takes a numpy Generator, so a seed fixes every draw."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from jpdse_tpu_torch.config import PreprocessConfig


def sample_params(
    pp: PreprocessConfig, size: Tuple[int, int], rng: np.random.Generator, no_flip: bool
) -> Dict:
    """Random crop position + flip decision (base_dataset.py:29-49)."""
    w, h = size
    new_w, new_h = w, h
    mode = pp.preprocess_mode
    if mode == "resize_and_crop":
        new_w = new_h = pp.load_size
    elif mode == "scale_width_and_crop":
        new_w = pp.load_size
        new_h = pp.load_size * h // w
    elif mode == "scale_shortside_and_crop":
        ss, ls = min(w, h), max(w, h)
        width_is_shorter = w == ss
        ls = int(pp.load_size * ls / ss)
        new_w, new_h = (ss, ls) if width_is_shorter else (ls, ss)
    x = int(rng.integers(0, max(0, new_w - pp.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - pp.crop_size) + 1))
    flip = (not no_flip) and bool(rng.random() > 0.5)
    return {"crop_pos": (x, y), "flip": flip}


def _make_power_2(img: Image.Image, base: int, method) -> Image.Image:
    ow, oh = img.size
    h = int(round(oh / base) * base)
    w = int(round(ow / base) * base)
    if (h == oh) and (w == ow):
        return img
    return img.resize((w, h), method)


def _scale_width(img: Image.Image, target_width: int, method) -> Image.Image:
    ow, oh = img.size
    if ow == target_width:
        return img
    return img.resize((target_width, int(target_width * oh / ow)), method)


def _scale_shortside(img: Image.Image, target: int, method) -> Image.Image:
    ow, oh = img.size
    ss, ls = min(ow, oh), max(ow, oh)
    if ss == target:
        return img
    width_is_shorter = ow == ss
    ls = int(target * ls / ss)
    nw, nh = (target, ls) if width_is_shorter else (ls, target)
    return img.resize((nw, nh), method)


def apply_transform(
    img: Image.Image,
    pp: PreprocessConfig,
    params: Dict,
    method=Image.BICUBIC,
    is_train: bool = True,
) -> Image.Image:
    """The geometric part of get_transform (base_dataset.py:52-86)."""
    mode = pp.preprocess_mode
    if "resize" in mode:
        img = img.resize((pp.load_size, pp.load_size), method)
    elif "scale_width" in mode:
        img = _scale_width(img, pp.load_size, method)
    elif "scale_shortside" in mode:
        img = _scale_shortside(img, pp.load_size, method)
    if "crop" in mode:
        x, y = params["crop_pos"]
        img = img.crop((x, y, x + pp.crop_size, y + pp.crop_size))
    if mode == "none":
        img = _make_power_2(img, 32, method)
    if mode == "fixed":
        w = pp.crop_size
        h = round(pp.crop_size / pp.aspect_ratio)
        img = img.resize((w, h), method)
    if is_train and params.get("flip"):
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def image_to_normalized(img: Image.Image, mean, std) -> np.ndarray:
    """PIL RGB -> float32 HWC in model space ((x/255 - mean) / std), matching
    ToTensor + Normalize (base_dataset.py:79-85)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def denormalize_to_pil(arr: np.ndarray, mean, std) -> Image.Image:
    """Model space -> PIL uint8 (host-side tensor2im, misc.py:64-95)."""
    x = (arr * np.asarray(std, np.float32) + np.asarray(mean, np.float32)) * 255.0
    return Image.fromarray(np.clip(x, 0, 255).astype(np.uint8))


def label_to_array(img: Image.Image, num_labels: int) -> np.ndarray:
    """Label map -> float32 (H, W) ids, remapping 255 -> num_labels ('unknown',
    ctu_dataset.py:104-105)."""
    arr = np.asarray(img).astype(np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr[arr == 255] = num_labels
    return arr


def instance_to_array(img: Image.Image) -> np.ndarray:
    """Instance map -> int32 (H, W). 'L'-mode maps scale like labels
    (ctu_dataset.py:118-122); 'I'/'I;16' keep raw ids."""
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.int32)
