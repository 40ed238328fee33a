"""CLIC (``<mode>/img`` with ``<mode>/sem`` maps), the port of
``jpdse_tpu/data/clic.py``."""

from __future__ import annotations

import os
from typing import List, Tuple

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.data.folder import make_dataset
from jpdse_tpu_torch.data.paired import PairedDataset


class ClicDataset(PairedDataset):
    def get_paths(self, cfg: Config) -> Tuple[List[str], List[str], List[str]]:
        root, mode = cfg.data.root_dir, cfg.mode
        label_dir = os.path.join(root, mode, "sem")
        label_paths_all = make_dataset(label_dir, recursive=True)
        label_paths = [p for p in label_paths_all if p.endswith("_sem_map.png")]
        image_paths = make_dataset(os.path.join(root, mode, "img"), recursive=True)
        if not cfg.model.no_instance:
            instance_paths = [p for p in label_paths_all if p.endswith("_ins_map.png")]
        else:
            instance_paths = []
        return label_paths, image_paths, instance_paths

    def paths_match(self, path1: str, path2: str) -> bool:
        # path1 is the semantics, path2 the image (clic_dataset.py:47-51)
        n1 = os.path.basename(path1)
        n2 = os.path.basename(path2)
        return n1.startswith(os.path.splitext(n2)[0])
