"""Checkpoints, the params half of ``jpdse_tpu/train/checkpoint.py``
(``restore_checkpoint`` :130-181) on the port's own file: ``params_g.pt``,
the codec's state dict written with ``torch.save``, beside the JSON sidecar
``trainer_meta.json``.

Restore is partial, as the JAX package's: a tensor replaces the template's
where its name exists and its shape agrees, and every other entry keeps the
template's value. ``tools/torch_port_export_params.py`` writes the file from
a JAX (Orbax) checkpoint. Optimizer state and saving wait for the training
slice (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Tuple

import torch

PARAMS_FILE = "params_g.pt"
META_FILE = "trainer_meta.json"


def save_params(checkpoints_dir: str, state: Mapping[str, torch.Tensor]) -> str:
    """Write a codec state dict as ``checkpoints_dir/params_g.pt`` (CPU
    tensors); returns the path."""
    os.makedirs(checkpoints_dir, exist_ok=True)
    path = os.path.join(checkpoints_dir, PARAMS_FILE)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)
    return path


def merge_state(template: Mapping[str, torch.Tensor],
                loaded: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], int]:
    """(merged state, entries taken from ``loaded``): each template entry is
    replaced by the loaded tensor of the same name and shape, in the
    template's dtype and device."""
    out, n = {}, 0
    for k, t in template.items():
        v = loaded.get(k)
        if isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(t.shape):
            out[k] = v.to(dtype=t.dtype, device=t.device)
            n += 1
        else:
            out[k] = t
    return out, n


def restore_params(checkpoints_dir: str,
                   template: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(merged state, sidecar meta) from ``checkpoints_dir``. A missing
    ``params_g.pt`` raises ``FileNotFoundError``."""
    path = os.path.join(checkpoints_dir, PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {PARAMS_FILE} in {checkpoints_dir}")
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    merged, n = merge_state(template, loaded)
    print(f"restored params from {checkpoints_dir}: {n}/{len(template)} leaves matched")
    meta = {}
    meta_path = os.path.join(checkpoints_dir, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return merged, meta
