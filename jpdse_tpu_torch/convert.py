"""Weight bridge between the JAX package's Flax parameters and the port's
state dicts (the inverse of ``jpdse_tpu/convert/torch_import.py:36-49``).

The port's modules nest as the Flax ones do, so a key maps segment by
segment: Flax ``netG/down0/conv/conv/kernel`` is ``netG.down.0.conv.conv.weight``.
Conv kernels go from (kh, kw, in, out) to (out, in, kh, kw); ConvTranspose
kernels (Flax stores the pre-flip kernel, the adjoint of torch's) from
(kh, kw, in, out) to (in, out, kh, kw).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_INDEXED = re.compile(r"^(down|up|res)(\d+)$")
_INDEXED_PORT = re.compile(r"(^|\.)(down|up|res)\.(\d+)(?=\.)")


def _layout(path) -> tuple:
    """Axis permutation from the Flax layout to the port's for a kernel."""
    return (2, 3, 0, 1) if path[-1] == "deconv" else (3, 2, 0, 1)


def from_jax_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params PyTree (arrays as numpy or anything np.asarray takes) ->
    SemanticCodec state dict of fp32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
                continue
            a = np.asarray(child, dtype=np.float32)
            if name == "kernel":
                a, name = a.transpose(_layout(path)), "weight"
            parts = [_INDEXED.sub(r"\1.\2", p) for p in path]
            out[".".join(parts + [name])] = torch.tensor(a)

    walk(tree, [])
    return out


def to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of :func:`from_jax_params`: state dict -> nested dict of numpy
    arrays in the Flax layout."""
    tree: Dict = {}
    for key, t in state.items():
        parts = _INDEXED_PORT.sub(r"\1\2\3", key).split(".")
        path, name = parts[:-1], parts[-1]
        a = t.detach().float().cpu().numpy()
        if name == "weight":
            a, name = a.transpose(np.argsort(_layout(path))), "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return tree
