"""Cityscapes (``leftImg8bit`` / ``gtFine``), the port of
``jpdse_tpu/data/cityscapes.py``."""

from __future__ import annotations

import os
from typing import List, Tuple

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.data.folder import make_dataset
from jpdse_tpu_torch.data.paired import PairedDataset


class CityscapesDataset(PairedDataset):
    def get_paths(self, cfg: Config) -> Tuple[List[str], List[str], List[str]]:
        root, mode = cfg.data.root_dir, cfg.mode
        if cfg.data.use_gt_semantics:
            label_dir = os.path.join(root, "gtFine", mode)
        else:
            # learned semantics live in gtFine_learned with gt-identical names
            # (cityscapes_dataset.py:36-41)
            label_dir = os.path.join(root, "gtFine_learned", mode)
        label_paths_all = make_dataset(label_dir, recursive=True)
        label_paths = [p for p in label_paths_all if p.endswith("_labelIds.png")]
        image_dir = os.path.join(root, "leftImg8bit", mode)
        image_paths = make_dataset(image_dir, recursive=True)
        if not cfg.model.no_instance:
            instance_paths = [p for p in label_paths_all if p.endswith("_instanceIds.png")]
        else:
            instance_paths = []
        return label_paths, image_paths, instance_paths

    def paths_match(self, path1: str, path2: str) -> bool:
        # compare [city]_[id1]_[id2] (cityscapes_dataset.py:55-60)
        n1 = os.path.basename(path1)
        n2 = os.path.basename(path2)
        return "_".join(n1.split("_")[:3]) == "_".join(n2.split("_")[:3])
