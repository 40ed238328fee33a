"""The HTML gallery of an evaluation, the port of
``jpdse_tpu/utils/visualizer.py``: each image's (label, image,
reconstruction) go to ``web_dir/images/<key>/<name>.png``, listed in an
``index.html`` table."""

from __future__ import annotations

import datetime
import html as _html
import os
from typing import Dict, List, Sequence

import numpy as np
from PIL import Image

from jpdse_tpu_torch.utils.colormap import colorize_labels
from jpdse_tpu_torch.utils.misc import tensor2im


class HTMLGallery:
    def __init__(self, web_dir: str, title: str):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.title = title
        self.blocks: List[str] = [
            f"<h1>{_html.escape(datetime.datetime.now().strftime('%I:%M%p on %B %d, %Y'))}</h1>"
        ]

    def add_header(self, text: str):
        self.blocks.append(f"<h3>{_html.escape(text)}</h3>")

    def add_images(self, ims: Sequence[str], txts: Sequence[str], width: int = 512):
        cells = []
        for im, txt in zip(ims, txts):
            rel = os.path.join("images", im)
            cells.append(
                f'<td style="word-wrap: break-word;" valign="top">'
                f'<p><a href="{rel}"><img style="width:{width}px" src="{rel}"></a>'
                f"<br><p>{_html.escape(txt)}</p></p></td>"
            )
        self.blocks.append(
            '<table border="1" style="table-layout: fixed;"><tr>' + "".join(cells) + "</tr></table>"
        )

    def save(self):
        doc = (
            f"<!DOCTYPE html><html><head><title>{_html.escape(self.title)}</title>"
            f"</head><body>{''.join(self.blocks)}</body></html>"
        )
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(doc)


class Visualizer:
    def __init__(self, cfg):
        self.cfg = cfg
        self.win_size = cfg.display_winsize

    def _to_uint8(self, key: str, arr: np.ndarray) -> np.ndarray:
        arr = np.asarray(arr)
        if key == "label":
            return colorize_labels(arr, self.cfg.data.num_labels + 2)
        return tensor2im(arr, self.cfg.data.normalize_mean, self.cfg.data.normalize_std)

    def save_images(self, gallery: HTMLGallery, visuals: Dict[str, np.ndarray], image_path: str):
        name = os.path.splitext(os.path.basename(image_path))[0]
        gallery.add_header(name)
        ims, txts = [], []
        for key, arr in visuals.items():
            img = self._to_uint8(key, arr)
            rel = os.path.join(key, f"{name}.png")
            full = os.path.join(gallery.img_dir, rel)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            Image.fromarray(img).save(full)
            ims.append(rel)
            txts.append(key)
        gallery.add_images(ims, txts, width=self.win_size)
