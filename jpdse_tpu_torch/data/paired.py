"""Paired (image, label, instance) datasets, the port of
``jpdse_tpu/data/paired.py``: natural-sorted paths with a pairing check, one
shared random parameter set so image, label and instance get the same crop
and flip, bicubic image and nearest id-map resampling, the 255 ->
num_labels remap of unknown labels, memoized decoding for deterministic
preprocessing (``data.cache_images``), and under ``codec.use_compressed``
the base codec's round trip of the transformed image: its decoded image
(``compressed``), its streams, their bytes and the codec that decodes them.
Under ``cache_images`` the round trip is memoized per (index, flip), bit for
bit the inline path's, so a base codec's encode runs once per image and
flip, not once per training step.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from jpdse_tpu_torch.codecs.bridge import compress_for_model
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.data.transforms import (
    apply_transform,
    image_to_normalized,
    instance_to_array,
    label_to_array,
    sample_params,
)
from jpdse_tpu_torch.utils.misc import natural_sort, tensor2im


class PairedDataset:
    """Base class; subclasses implement get_paths / paths_match."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        label_paths, image_paths, instance_paths = self.get_paths(cfg)
        natural_sort(label_paths)
        natural_sort(image_paths)
        if not cfg.model.no_instance:
            natural_sort(instance_paths)
        n = cfg.data.max_dataset_size
        label_paths, image_paths, instance_paths = (
            label_paths[:n], image_paths[:n], instance_paths[:n],
        )
        if not cfg.data.no_pairing_check:
            for p1, p2 in zip(label_paths, image_paths):
                if not self.paths_match(p1, p2):
                    raise ValueError(
                        f"label/image pair {p1}, {p2} do not look paired; "
                        "use data.no_pairing_check to bypass"
                    )
        self.label_paths = label_paths
        self.image_paths = image_paths
        self.instance_paths = instance_paths
        # data.cache_images: the decoded + resized (pre-flip, pre-normalize)
        # arrays per index; valid only for a deterministic geometric
        # transform (no random crop): 'fixed' and 'none'
        self._cache: Dict[int, Tuple] = {}
        # the base codec's round trips per (index, flip), under the same rule
        self._comp_cache: Dict[Tuple[int, bool], Tuple] = {}
        self._cache_enabled = cfg.data.cache_images and (
            cfg.data.preprocess.preprocess_mode in ("fixed", "none")
        )
        if cfg.data.cache_images and not self._cache_enabled:
            print(
                f"note: cache_images ignored for random-crop preprocess mode "
                f"{cfg.data.preprocess.preprocess_mode!r}"
            )

    # -- subclass hooks --------------------------------------------------
    def get_paths(self, cfg: Config) -> Tuple[List[str], List[str], List[str]]:
        raise NotImplementedError

    def paths_match(self, path1: str, path2: str) -> bool:
        f1 = os.path.splitext(os.path.basename(path1))[0]
        f2 = os.path.splitext(os.path.basename(path2))[0]
        return f1 == f2

    def postprocess(self, sample: Dict) -> Dict:
        return sample

    # ---------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.image_paths)

    def _load_triplet(self, index: int):
        image_path = self.image_paths[index]
        label_img = instance_img = None
        if not self.cfg.model.no_label:
            label_path = self.label_paths[index]
            if not self.paths_match(label_path, image_path):
                raise ValueError(f"label {label_path} / image {image_path} mismatch")
            label_img = Image.open(label_path)
        if not self.cfg.model.no_instance:
            instance_path = self.instance_paths[index]
            if not self.paths_match(instance_path, image_path):
                raise ValueError(f"instance {instance_path} / image {image_path} mismatch")
            instance_img = Image.open(instance_path)
        return Image.open(image_path), label_img, instance_img, image_path

    def _resized_arrays(self, index: int):
        """(uint8 image HWC, label ids, instance ids, path, original size)
        after the geometric transform, before flip and normalization;
        memoized when cache_images is on."""
        cached = self._cache.get(index)
        if cached is not None:
            return cached
        cfg = self.cfg
        image, label, instance, image_path = self._load_triplet(index)
        pp = cfg.data.preprocess
        noflip = {"crop_pos": (0, 0), "flip": False}
        orig_size = image.size  # sample_params draws from the original size
        image_arr = np.asarray(
            apply_transform(image.convert("RGB"), pp, noflip, Image.BICUBIC, False), np.uint8
        )
        label_arr = inst_arr = None
        if label is not None:
            label_arr = label_to_array(
                apply_transform(label, pp, noflip, Image.NEAREST, False), cfg.data.num_labels
            )
        if instance is not None:
            inst_arr = instance_to_array(
                apply_transform(instance, pp, noflip, Image.NEAREST, False))
        out = (image_arr, label_arr, inst_arr, image_path, orig_size)
        if self._cache_enabled:
            self._cache[index] = out
        return out

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.cfg
        rng = rng if rng is not None else np.random.default_rng()
        pp = cfg.data.preprocess
        is_train = cfg.is_train

        if self._cache_enabled:
            image_u8, label_arr, inst_arr, image_path, orig_size = self._resized_arrays(index)
            params = sample_params(pp, orig_size, rng, cfg.data.no_flip)
            flip = is_train and params["flip"]
            if flip:
                image_u8 = image_u8[:, ::-1]
            mean = np.asarray(cfg.data.normalize_mean, np.float32)
            std = np.asarray(cfg.data.normalize_std, np.float32)
            image_arr = (image_u8.astype(np.float32) / 255.0 - mean) / std
            sample: Dict = {"image": image_arr, "path": image_path}
            if label_arr is not None:
                sample["label"] = label_arr[:, ::-1].copy() if flip else label_arr
            if inst_arr is not None:
                sample["instance"] = inst_arr[:, ::-1].copy() if flip else inst_arr
        else:
            image, label, instance, image_path = self._load_triplet(index)
            params = sample_params(pp, image.size, rng, cfg.data.no_flip)
            image_t = apply_transform(image.convert("RGB"), pp, params, Image.BICUBIC, is_train)
            sample = {
                "image": image_to_normalized(image_t, cfg.data.normalize_mean,
                                             cfg.data.normalize_std),
                "path": image_path,
            }
            if label is not None:
                label_t = apply_transform(label, pp, params, Image.NEAREST, is_train)
                sample["label"] = label_to_array(label_t, cfg.data.num_labels)
            if instance is not None:
                inst_t = apply_transform(instance, pp, params, Image.NEAREST, is_train)
                sample["instance"] = instance_to_array(inst_t)
        if cfg.codec.use_compressed:
            if self._cache_enabled:
                comp = self._compressed_arrays(index, flip)
            else:
                comp = self._round_trip(sample["image"])
            add_compressed(sample, comp)
        return self.postprocess(sample)

    def _round_trip(self, image_arr: np.ndarray):
        """The base codec's round trip of a normalized image, as uint8:
        (decoded and normalized float32 (H, W, 3 * len(quality)), total
        bytes, streams, the codec that decodes them)."""
        d = self.cfg.data
        return compress_for_model(tensor2im(image_arr, d.normalize_mean, d.normalize_std),
                                  self.cfg.codec.ext, self.cfg.codec.quality, d.normalize_mean,
                                  d.normalize_std, return_streams=True)

    def _compressed_arrays(self, index: int, flip: bool):
        """:meth:`_round_trip` of the cached sample at ``flip``, memoized:
        the same ops on the same arrays as the inline path, so bit-equal."""
        key = (index, bool(flip))
        hit = self._comp_cache.get(key)
        if hit is None:
            image_u8 = self._resized_arrays(index)[0]
            if flip:
                image_u8 = image_u8[:, ::-1]
            mean = np.asarray(self.cfg.data.normalize_mean, np.float32)
            std = np.asarray(self.cfg.data.normalize_std, np.float32)
            hit = self._round_trip((image_u8.astype(np.float32) / 255.0 - mean) / std)
            self._comp_cache[key] = hit
        return hit


def add_compressed(sample: Dict, comp) -> None:
    """The base codec's round trip (:meth:`PairedDataset._round_trip`) into
    a sample: ``compressed``, ``base_codec_bytes``, ``base_codec_streams``
    and ``base_codec_ext``."""
    keys = ("compressed", "base_codec_bytes", "base_codec_streams", "base_codec_ext")
    sample.update(zip(keys, comp))
