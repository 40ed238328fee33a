"""Image-only folders (``root/<mode>``, no semantics), the port of
``jpdse_tpu/data/custom.py``. Requires model.no_label and model.no_instance
(set by the 'custom' dataset defaults)."""

from __future__ import annotations

import os
from typing import List, Tuple

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.data.folder import make_dataset
from jpdse_tpu_torch.data.paired import PairedDataset


class CustomDataset(PairedDataset):
    def __init__(self, cfg: Config):
        if not (cfg.model.no_label and cfg.model.no_instance):
            raise ValueError(
                "custom (image-only) dataset requires model.no_label and "
                "model.no_instance"
            )
        super().__init__(cfg)

    def get_paths(self, cfg: Config) -> Tuple[List[str], List[str], List[str]]:
        image_dir = os.path.join(cfg.data.root_dir, cfg.mode)
        image_paths = make_dataset(image_dir, recursive=True)
        return list(image_paths), image_paths, list(image_paths)

    def paths_match(self, path1: str, path2: str) -> bool:
        return True
