"""Weight bridge between the JAX package's Flax parameters and the port's
state dicts (the inverse of ``jpdse_tpu/convert/torch_import.py:36-49``).

The port's modules nest as the Flax ones do, so a key maps segment by
segment: Flax ``netG/down0/conv/conv/kernel`` is ``netG.down.0.conv.conv.weight``.
Conv kernels go from (kh, kw, in/g, out) to (out, in/g, kh, kw), grouped or
not. ConvTranspose kernels (Flax stores the pre-flip kernel, the adjoint of
torch's) go from (kh, kw, in/g, out) to (in, out/g, kh, kw): for g groups
that is no transpose, but ``torch[j*ipg + ci, ol] = flax[:, :, ci,
j*opg + ol]`` (ipg, opg the channels a group takes in and gives out), so
the bridge needs each network's groups (:func:`deconv_groups`). A
LocalEnhancer keeps Flax's nesting: ``netG/global/...`` is
``netG.global...``, ``netG/local1_up/res0/...`` is ``netG.local1_up.res.0...``.
A 2-D ``Dense`` kernel (``S2HVQV2``'s MLP) goes from (in, out) to
``nn.Linear``'s (out, in).
The same rules carry a segmentation-trained VGG (``train/seg_vgg.py``'s
``SegVgg``: Flax ``trunk/conv1_1/kernel`` is ``trunk.conv1_1.weight``, a
1x1 head's ``seg_head2/kernel`` (1, 1, in, out) is ``seg_head2.weight``
(out, in, 1, 1)) and the perceptual trunk alone.

A batch norm's running statistics are Flax's ``batch_stats`` collection
(``mstate_g`` / ``mstate_d`` of the JAX package's training state) and the
port's buffers ``....BatchNorm_0.mean`` / ``.var``, beside the parameters
``....BatchNorm_0.scale`` / ``.bias`` in the same state dict:
:func:`from_jax_params` takes the collection as ``mstate``,
:func:`to_jax_params` leaves the statistics out and :func:`to_jax_mstate`
gives them back, so a round trip is bit-equal, statistics included.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_INDEXED = re.compile(r"^(down|up|res)(\d+)$")
_INDEXED_PORT = re.compile(r"(^|\.)(down|up|res)\.(\d+)(?=\.)")
STATS = ("mean", "var")  # a batch norm's running statistics (Flax's batch_stats)


def is_stat(key: str) -> bool:
    """Whether a state-dict key is a batch norm's running statistic."""
    parts = key.split(".")
    return len(parts) >= 2 and parts[-2] == "BatchNorm_0" and parts[-1] in STATS


def deconv_groups(cfg) -> Dict[str, int]:
    """The groups of each network's transposed convs under ``cfg``: netE's
    are ``model.netE_groups``, every other network's 1."""
    return {"netE": cfg.model.netE_groups}


def _to_port(a: np.ndarray, path, groups: int) -> np.ndarray:
    """A Flax kernel in the port's layout."""
    if a.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return a.T
    if path[-1] != "deconv":
        return a.transpose(3, 2, 0, 1)
    k, k2, ipg, out = a.shape
    a = a.reshape(k, k2, ipg, groups, out // groups).transpose(3, 2, 4, 0, 1)
    return a.reshape(groups * ipg, out // groups, k, k2)


def _to_flax(a: np.ndarray, path, groups: int) -> np.ndarray:
    """Inverse of :func:`_to_port`."""
    if a.ndim == 2:
        return a.T
    if path[-1] != "deconv":
        return a.transpose(2, 3, 1, 0)
    cin, opg, k, k2 = a.shape
    a = a.reshape(groups, cin // groups, opg, k, k2).transpose(3, 4, 1, 0, 2)
    return a.reshape(k, k2, cin // groups, groups * opg)


def from_jax_params(tree: Mapping, groups: Optional[Mapping[str, int]] = None,
                    mstate: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """Flax params PyTree (arrays as numpy or anything np.asarray takes) ->
    SemanticCodec state dict of fp32 CPU tensors. ``groups``: the groups of
    the transposed convs under each top-level network (:func:`deconv_groups`;
    1 where absent). ``mstate``: the mutable collections beside the params
    (``{"batch_stats": ...}``, the JAX state's ``mstate_g`` / ``mstate_d``),
    whose running statistics become the batch norms' buffers."""
    groups = groups or {}
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
                continue
            a = np.asarray(child, dtype=np.float32)
            if name == "kernel":
                a, name = _to_port(a, path, groups.get(path[0], 1)), "weight"
            parts = [_INDEXED.sub(r"\1.\2", p) for p in path]
            out[".".join(parts + [name])] = torch.tensor(np.ascontiguousarray(a))

    walk(tree, [])
    stats = (mstate or {}).get("batch_stats")
    if stats:
        walk(stats, [])
    return out


def _nest(items) -> Dict:
    """(dotted port key, numpy array) pairs -> the nested Flax tree."""
    tree: Dict = {}
    for parts, a in items:
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree


def to_jax_params(state: Mapping[str, torch.Tensor],
                  groups: Optional[Mapping[str, int]] = None) -> Dict:
    """Inverse of :func:`from_jax_params`: state dict -> nested dict of numpy
    arrays in the Flax layout, the params collection (the running
    statistics are :func:`to_jax_mstate`'s)."""
    groups = groups or {}
    items = []
    for key, t in state.items():
        if is_stat(key):
            continue
        parts = _INDEXED_PORT.sub(r"\1\2\3", key).split(".")
        path, name = parts[:-1], parts[-1]
        a = t.detach().float().cpu().numpy()
        if name == "weight":
            a, name = _to_flax(a, path, groups.get(path[0], 1)), "kernel"
        items.append((path + [name], np.ascontiguousarray(a)))
    return _nest(items)


def to_jax_mstate(state: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX state's ``mstate`` of a state dict: ``{"batch_stats": tree}``
    of its batch norms' running statistics (fp32 numpy, Flax nesting), or
    ``{}`` without a batch norm, as the JAX Trainer fills it."""
    items = [(_INDEXED_PORT.sub(r"\1\2\3", k).split("."), t.detach().float().cpu().numpy())
             for k, t in state.items() if is_stat(k)]
    return {"batch_stats": _nest(items)} if items else {}
