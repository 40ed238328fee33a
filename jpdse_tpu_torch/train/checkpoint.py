"""Checkpoints, the port of ``jpdse_tpu/train/checkpoint.py`` on the port's
own files, written with ``torch.save``:

* ``params_g.pt``, the codec's state dict (what evaluation loads);
* ``params_d.pt``, the discriminator's; under ``model.norm`` 'batch' each
  holds its batch norms' running statistics as buffers (the JAX package's
  ``mstate_g`` / ``mstate_d``), restored and counted with the parameters;
* ``opt.pt``, both Adams' state dicts and the counters (steps taken, the
  annealed distortion weight, the best validation loss) and the pool;
* ``trainer_meta.json``, the host-side sidecar (epoch, best validation
  loss, the lr scheduler).

Restore is partial, as the JAX package's: a tensor replaces the template's
where its name exists and its shape agrees, and every other entry keeps the
template's value. Optimizer state restores whole or not at all (a phase
change keeps the fresh Adams, as the JAX package falls back).
``tools/torch_port_export_params.py`` writes all three from a JAX (Orbax)
checkpoint, the Adams' moments and counts among them, so a JAX run resumes
here step for step (its ``trainer_meta.json`` is this format already). A
directory that holds the reference's ``net_*.pth`` and no ``params_g.pt``
is imported by ``convert/torch_import.py`` instead (:func:`is_reference_dir`).
Under a process group rank 0 writes and every rank restores
(``trainer.py``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch

PARAMS_FILE = "params_g.pt"
PARAMS_D_FILE = "params_d.pt"
OPT_FILE = "opt.pt"
META_FILE = "trainer_meta.json"


def save_params(checkpoints_dir: str, state: Mapping[str, torch.Tensor],
                name: str = PARAMS_FILE) -> str:
    """Write a state dict as ``checkpoints_dir/<name>`` (CPU tensors; the
    codec's ``params_g.pt`` by default); returns the path."""
    os.makedirs(checkpoints_dir, exist_ok=True)
    path = os.path.join(checkpoints_dir, name)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)
    return path


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(save_dir: str, state, epoch: int, extra_meta: Optional[Dict] = None) -> None:
    """Write the whole training state (``train/state.py::GANTrainState``)
    and the sidecar with ``epoch`` and ``extra_meta``."""
    save_params(save_dir, state.codec.state_dict())
    save_params(save_dir, state.disc.state_dict(), PARAMS_D_FILE)
    opt = {
        "opt_g": _to_cpu(state.opt_g.state_dict()),
        "opt_d": _to_cpu(state.opt_d.state_dict()),
        "steps_taken": state.steps_taken,
        "lambda_distortion_weight": state.lambda_distortion_weight,
        "best_val_loss": state.best_val_loss,
    }
    if state.pool is not None:
        opt["pool"] = {"images": state.pool.images.cpu(), "num_imgs": state.pool.num_imgs}
    torch.save(opt, os.path.join(save_dir, OPT_FILE))
    meta = {"epoch": epoch, "best_val_loss": state.best_val_loss}
    meta.update(extra_meta or {})
    with open(os.path.join(save_dir, META_FILE), "w") as f:
        json.dump(meta, f)


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


def is_reference_dir(checkpoints_dir: str) -> bool:
    """A reference checkpoint directory: ``net_G.pth`` and no
    ``params_g.pt`` (``convert/torch_import.py`` imports it)."""
    return (not os.path.exists(os.path.join(checkpoints_dir, PARAMS_FILE))
            and os.path.exists(os.path.join(checkpoints_dir, "net_G.pth")))


def _load_params(checkpoints_dir: str) -> Dict[str, torch.Tensor]:
    path = os.path.join(checkpoints_dir, PARAMS_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {PARAMS_FILE} in {checkpoints_dir}")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_params(checkpoints_dir: str,
                   template: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """(merged state, sidecar meta) from ``checkpoints_dir``. A missing
    ``params_g.pt`` raises ``FileNotFoundError``."""
    merged, n = merge_state(template, _load_params(checkpoints_dir))
    print(f"restored params from {checkpoints_dir}: {n}/{len(template)} leaves matched")
    return merged, _read_meta(checkpoints_dir)


def _read_meta(checkpoints_dir: str) -> Dict:
    meta_path = os.path.join(checkpoints_dir, META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def meta_epoch(checkpoints_dir: str) -> int:
    """The sidecar's epoch, or -1 where there is none."""
    try:
        return int(_read_meta(checkpoints_dir).get("epoch", -1))
    except (OSError, ValueError):
        return -1


def _adam_fits(saved: Dict, opt: torch.optim.Optimizer) -> bool:
    """Whether a saved Adam state dict belongs to ``opt``'s parameters: the
    same count, and each moment shaped as its parameter."""
    params = [p for g in opt.param_groups for p in g["params"]]
    groups = saved.get("param_groups", [])
    if sum(len(g["params"]) for g in groups) != len(params):
        return False
    ids = [i for g in groups for i in g["params"]]
    for i, p in zip(ids, params):
        st = saved.get("state", {}).get(i)
        if st is not None and tuple(st["exp_avg"].shape) != tuple(p.shape):
            return False
    return True


def restore_checkpoint(checkpoints_dir: str, state, restore_opt: bool = True) -> Dict:
    """Restore ``checkpoints_dir`` into a freshly built training state in
    place: both players' parameters partially (by name and shape), then,
    with ``restore_opt``, the Adams and counters whole or not at all.
    Returns the sidecar's meta."""
    template_g, template_d = state.codec.state_dict(), state.disc.state_dict()
    merged_g, n_g = merge_state(template_g, _load_params(checkpoints_dir))
    merged_d, n_d = template_d, 0
    d_path = os.path.join(checkpoints_dir, PARAMS_D_FILE)
    if os.path.exists(d_path):
        merged_d, n_d = merge_state(
            template_d, torch.load(d_path, map_location="cpu", weights_only=True))
    state.codec.load_state_dict(merged_g)
    state.disc.load_state_dict(merged_d)
    # one count over both players' leaves, as the JAX package's merge_trees counts them
    print(f"restored params from {checkpoints_dir}: {n_g + n_d}/{len(template_g) + len(template_d)}"
          " leaves matched")
    meta = _read_meta(checkpoints_dir)
    opt_path = os.path.join(checkpoints_dir, OPT_FILE)
    if restore_opt and os.path.exists(opt_path):
        opt = torch.load(opt_path, map_location="cpu", weights_only=True)
        if _adam_fits(opt["opt_g"], state.opt_g) and _adam_fits(opt["opt_d"], state.opt_d):
            state.opt_g.load_state_dict(opt["opt_g"])
            state.opt_d.load_state_dict(opt["opt_d"])
            state.steps_taken = int(opt["steps_taken"])
            state.lambda_distortion_weight = float(opt["lambda_distortion_weight"])
            state.best_val_loss = float(opt["best_val_loss"])
            pool = opt.get("pool")
            if state.pool is not None and pool is not None and \
                    pool["images"].shape == state.pool.images.shape:
                state.pool.images.copy_(pool["images"])
                state.pool.num_imgs = int(pool["num_imgs"])
        else:
            print("optimizer state not restored (shapes differ); keeping fresh init")
    elif restore_opt:
        print("optimizer state not restored (no opt.pt); keeping fresh init")
    return meta
