"""ADE20K, the port of ``jpdse_tpu/data/ade20k.py``: one RGB ``*_seg.png``
holds the class ids (R channel) and instance ids (B channel); the unknown
label 0 becomes the last class, as in the other datasets."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.data.folder import make_dataset
from jpdse_tpu_torch.data.paired import PairedDataset
from jpdse_tpu_torch.data.transforms import (
    apply_transform,
    image_to_normalized,
    sample_params,
)


class ADE20KDataset(PairedDataset):
    def get_paths(self, cfg: Config) -> Tuple[List[str], List[str], List[str]]:
        root = cfg.data.root_dir
        if cfg.mode == "val":
            root = os.path.join(root, "validation")
        elif cfg.mode == "test":
            root = os.path.join(root, "testing")
        else:
            root = os.path.join(root, "training")
        mode = "val" if cfg.mode in ("val", "test") else "train"
        all_images = make_dataset(root, recursive=True)
        image_paths, label_paths = [], []
        for p in all_images:
            if f"_{mode}_" not in p:
                continue
            if p.endswith(".jpg"):
                image_paths.append(p)
            elif p.endswith("_seg.png"):
                label_paths.append(p)
        # instances ride in the same seg file (ade20k_dataset.py:53-56)
        return label_paths, image_paths, list(label_paths)

    def paths_match(self, path1: str, path2: str) -> bool:
        f1 = os.path.splitext(os.path.basename(path1))[0]
        f2 = os.path.splitext(os.path.basename(path2))[0]
        return "_".join(f1.split("_")[:3]) == "_".join(f2.split("_")[:3])

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.cfg
        rng = rng if rng is not None else np.random.default_rng()
        image_path = self.image_paths[index]
        pp = cfg.data.preprocess
        image = Image.open(image_path)
        params = sample_params(pp, image.size, rng, cfg.data.no_flip)
        is_train = cfg.is_train

        image = image.convert("RGB")
        image_t = apply_transform(image, pp, params, Image.BICUBIC, is_train)
        sample: Dict = {
            "image": image_to_normalized(
                image_t, cfg.data.normalize_mean, cfg.data.normalize_std
            ),
            "path": image_path,
        }

        need_seg = (not cfg.model.no_label) or (not cfg.model.no_instance)
        if need_seg:
            label_path = self.label_paths[index]
            if not self.paths_match(label_path, image_path):
                raise ValueError(f"seg {label_path} / image {image_path} mismatch")
            seg = np.array(Image.open(label_path).convert("RGB"))
            if not cfg.model.no_label:
                label = Image.fromarray(seg[..., 0])  # R channel: classes
                label_t = apply_transform(label, pp, params, Image.NEAREST, is_train)
                arr = np.asarray(label_t).astype(np.float32)
                arr[arr == 255] = cfg.data.num_labels
                # unknown(0) -> last class (ade20k_dataset.py:60-66)
                arr = arr - 1
                arr[arr == -1] = cfg.data.num_labels
                sample["label"] = arr
            if not cfg.model.no_instance:
                inst = Image.fromarray(seg[..., 2])  # B channel: instances
                inst_t = apply_transform(inst, pp, params, Image.NEAREST, is_train)
                sample["instance"] = np.asarray(inst_t).astype(np.int32)

        return sample
