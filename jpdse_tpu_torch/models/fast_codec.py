"""Space-to-depth inference path, the port of
``jpdse_tpu/models/fast_codec.py::FastCodec`` for the learned-code flagship:
``decode``, ``get_codes_shaped`` and ``decode_from_codes`` over the weights
of a ``SemanticCodec``, with each trunk as an s2d ``_FastTrunk``. The kernel
switches (``cfg.model.fast``, env overrides applied) are resolved once, at
construction, and passed to every trunk."""

from __future__ import annotations

from typing import Dict, List

import torch

from jpdse_tpu_torch.config import Config, check_ported
from jpdse_tpu_torch.models.codec import compute_dtype, prepare_inputs
from jpdse_tpu_torch.models.fast_trunk import _FastTrunk
from jpdse_tpu_torch.platform import resolve_device


def _sub(state: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(prefix + ".")}


class FastCodec:
    """Deterministic s2d inference over ``state`` (a ``SemanticCodec``
    state dict). Batches are dicts of tensors on ``device``: ``label``
    (B, H, W), ``instance`` (B, H, W), ``image`` (B, H, W, 3)."""

    def __init__(self, cfg: Config, state: Dict[str, torch.Tensor], device="cuda", dtype=None):
        cfg.validate()
        check_ported(cfg)
        m = cfg.model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype or compute_dtype(cfg)
        self.fp = fp = m.fast.resolved()
        fp.validate(check_combos=False)
        self.netG = _FastTrunk(_sub(state, "netG"), m.n_downsample_global, m.n_blocks_global,
                               "none", self.dtype, self.device, fp)
        self.netE = _FastTrunk(_sub(state, "netE"), m.n_downsample_E, 0, "mid",
                               self.dtype, self.device, fp)
        self.netE4label = _FastTrunk(_sub(state, "netE4label"), m.n_downsample_E4label, 0,
                                     "mid", self.dtype, self.device, fp)

    def _inputs(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # the one-hot and edge values are exact in bf16, so build them there
        return prepare_inputs(self.cfg, batch["label"], batch["instance"],
                              batch["image"].to(self.dtype))

    def _g(self, label: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        return self.netG(torch.cat([label, feat.to(label.dtype)], dim=-1))

    @torch.inference_mode()
    def decode(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        inputs = self._inputs(batch)
        return self._g(self.netE4label(inputs["input_label"]), self.netE(inputs["real_image"]))

    @torch.inference_mode()
    def get_codes_shaped(self, batch: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Codes in (B, h, w, C) layout with values (sign + 1) / 2, in the
        order netE4label, netE (as SemanticCodec.get_codes_shaped)."""
        inputs = self._inputs(batch)
        return [
            (self.netE4label.encode(inputs["input_label"]) + 1.0) / 2.0,
            (self.netE.encode(inputs["real_image"]) + 1.0) / 2.0,
        ]

    @torch.inference_mode()
    def decode_from_codes(self, codes: List[torch.Tensor]) -> torch.Tensor:
        """Image from the codes alone ((B, h, w, C) in {0, 1})."""
        label = self.netE4label.decode_from_code(codes[0].to(self.dtype) * 2.0 - 1.0)
        feat = self.netE.decode_from_code(codes[1].to(self.dtype) * 2.0 - 1.0)
        return self._g(label, feat)
