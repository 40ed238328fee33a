"""Serving the learned codec, the port of ``jpdse_tpu/trainer.py``'s
``compress`` / ``decompress`` (:359-480) up to the code tensors: compress a
batch to binary codes, and decompress an image from those codes alone. The
``.jpds`` container and its range coder are not ported yet."""

from __future__ import annotations

from typing import Dict, List

import torch

from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec


class CodecServer:
    """The codec over ``state`` (a ``SemanticCodec`` state dict) on
    ``device``, in the config's compute dtype: the s2d fast path when
    ``cfg.model.fast_inference`` is set, else the standard modules, as
    ``Trainer._fast`` decides (``jpdse_tpu/trainer.py:188-228``)."""

    def __init__(self, cfg: Config, state: Dict[str, torch.Tensor], device="cuda"):
        if cfg.model.fast_inference:
            self.fast = FastCodec(cfg, state, device=device)
            self.codec, self.device = None, self.fast.device
        else:
            self.codec = SemanticCodec(cfg, device=device, seed=None)
            self.codec.load_state_dict(state)
            self.codec.eval()
            self.fast, self.device = None, next(self.codec.parameters()).device

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k], device=self.device) for k in ("label", "instance", "image")}

    @torch.inference_mode()
    def compress(self, batch: Dict) -> List[torch.Tensor]:
        """``label`` (B, H, W), ``instance`` (B, H, W) and ``image``
        (B, H, W, 3) -> one uint8 {0, 1} tensor (B, h, w, C) per binarized
        module (netE4label, netE). A sign of exactly 0 codes as 0, as the
        JAX package's ``codec_io.pack`` stores it."""
        batch = self._batch(batch)
        if self.fast is not None:
            codes = self.fast.get_codes_shaped(batch)
        else:
            codes = self.codec.get_codes_shaped(self.codec.prepare(batch))
        return [c.to(torch.uint8) for c in codes]

    @torch.inference_mode()
    def decompress(self, codes: List[torch.Tensor]) -> torch.Tensor:
        """Codes from :meth:`compress` -> image (B, H, W, 3), float32."""
        codes = [c.to(self.device) for c in codes]
        if self.fast is not None:
            return self.fast.decode_from_codes(codes).float()
        return self.codec.decode_from_codes(codes).float()
