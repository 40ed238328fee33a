"""Serving the codec, the port of ``jpdse_tpu/trainer.py``'s ``compress`` /
``decompress`` (:359-483) for code-only configurations: compress a batch to
one ``.jpds`` stream per image (the codes on the card, then the host's
range coder), and decompress an image from a stream alone. A stream holds
one code per binarized module: netE4label's and netE's, either alone, or
the generator's bottleneck code. The tensor half of each
(``compress_codes``, ``decompress_codes``) is public too.

A configuration whose stream needs side info (raw semantics, an
unbinarized encoder's visuals) raises ``codec_io.SideInfoNotPorted``
naming ROADMAP Queue 1 item 5 before any device work; one that feeds the
generator raw uncompressed pixels raises ``ValueError``, as no stream
represents it."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np
import torch

from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec


class CodecServer:
    """The codec over ``state`` (a ``SemanticCodec`` state dict) on
    ``device``, in the config's compute dtype: the s2d fast path when
    ``cfg.model.fast_inference`` is set, else the standard modules, as
    ``Trainer._fast`` decides (``jpdse_tpu/trainer.py:188-228``).

    ``times`` holds the host-clock ms of the stages of the last
    :meth:`compress` (``compress_codes``, ``pack``) or :meth:`decompress`
    (``unpack``, ``decompress_codes``), each ending with its result on the
    host."""

    def __init__(self, cfg: Config, state: Dict[str, torch.Tensor], device="cuda"):
        if cfg.model.fast_inference:
            self.fast = FastCodec(cfg, state, device=device)
            self.codec, self.device = None, self.fast.device
        else:
            self.codec = SemanticCodec(cfg, device=device, seed=None)
            self.codec.load_state_dict(state)
            self.codec.eval()
            self.fast, self.device = None, next(self.codec.parameters()).device
        self.cfg = cfg
        self.times: Dict[str, float] = {}

    def _batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(batch[k], device=self.device)
                for k in ("label", "instance", "image") if k in batch}

    @torch.inference_mode()
    def compress_codes(self, batch: Dict) -> List[torch.Tensor]:
        """``label`` (B, H, W), ``instance`` (B, H, W) and ``image``
        (B, H, W, 3) -> one uint8 {0, 1} tensor (B, h, w, C) per binarized
        module (netE4label, netE, netG), on the server's device. A sign of
        exactly 0 codes as 0, as ``codec_io.pack`` stores it."""
        batch = self._batch(batch)
        if self.fast is not None:
            codes = self.fast.get_codes_shaped(batch)
        else:
            codes = self.codec.get_codes_shaped(self.codec.prepare(batch))
        return [c.to(torch.uint8) for c in codes]

    @torch.inference_mode()
    def decode(self, batch: Dict) -> torch.Tensor:
        """The deterministic reconstruction of a batch (encode, binarize,
        decode in one pass): image (B, H, W, 3), float32, on the server's
        device."""
        batch = self._batch(batch)
        if self.fast is not None:
            return self.fast.decode(batch).float()
        return self.codec.decode(self.codec.prepare(batch))[0].float()

    @torch.inference_mode()
    def decompress_codes(self, codes: Sequence) -> torch.Tensor:
        """Codes as :meth:`compress_codes` gives them (tensors or arrays,
        {0, 1}) -> image (B, H, W, 3), float32, on the server's device."""
        codes = [torch.as_tensor(c).to(self.device) for c in codes]
        if self.fast is not None:
            return self.fast.decode_from_codes(codes).float()
        return self.codec.decode_from_codes(codes).float()

    def compress(self, batch: Dict) -> List[bytes]:
        """One ``.jpds`` stream per image of the batch. The streams of a
        batch of several images are packed on a thread pool (the coder
        releases the GIL), as ``Trainer.compress`` packs them."""
        if any(codec_io.side_requirements(self.cfg)):
            raise codec_io.SideInfoNotPorted(
                "this configuration's streams carry side info (raw semantics or an "
                "unbinarized encoder's visuals), which is ROADMAP Queue 1 item 5")
        if not self.cfg.has_binary_codes:
            raise ValueError("nothing to pack: no binarized module and no side info in this "
                             "configuration")
        t0 = time.perf_counter()
        codes = [c.cpu().numpy() for c in self.compress_codes(batch)]
        t1 = time.perf_counter()
        hw = tuple(int(s) for s in np.shape(batch["image"])[1:3])
        b = codes[0].shape[0]

        def pack_one(j: int) -> bytes:
            return codec_io.pack([c[j] for c in codes], hw)

        if b == 1:
            streams = [pack_one(0)]
        else:
            with ThreadPoolExecutor(max_workers=min(8, b)) as ex:
                streams = list(ex.map(pack_one, range(b)))
        self.times = {"compress_codes": (t1 - t0) * 1e3,
                      "pack": (time.perf_counter() - t1) * 1e3}
        return streams

    def decompress(self, data: bytes) -> np.ndarray:
        """One ``.jpds`` stream -> its image (H, W, 3), float32, from the
        stream and the model's weights alone."""
        t0 = time.perf_counter()
        codes, _ = codec_io.unpack(data)
        if not codes:
            raise ValueError("empty bitstream: no codes and no side info")
        t1 = time.perf_counter()
        image = self.decompress_codes(codes)[0].cpu().numpy()
        self.times = {"unpack": (t1 - t0) * 1e3,
                      "decompress_codes": (time.perf_counter() - t1) * 1e3}
        return image
