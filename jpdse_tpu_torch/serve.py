"""Serving the codec, the port of ``jpdse_tpu/trainer.py``'s ``compress`` /
``decompress`` (:359-483): compress a batch to one ``.jpds`` stream per image,
and decompress an image from a stream alone. A stream holds one code per
binarized module (netE4label's and netE, either alone, or the generator's
bottleneck code) and, where the configuration feeds netG what no code
carries (``codec_io.side_requirements``), side info: the label and instance
maps (at ``codec.sem_downsample``) and the base codec's own streams, which
the batch brings from the data pipeline. A configuration of raw semantics
over a base codec's decoded image (the paper's recipe) has no code at all:
its compress is host work only, and its decompress decodes the base stream
and runs netG on the side inputs. The tensor half of each
(``compress_codes``, ``decompress_codes``) is public too.

A configuration that feeds the generator raw uncompressed pixels raises
``ValueError``, as no stream represents it."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.codecs.bridge import decode_bytes, normalize_decoded
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec

DEVICE_KEYS = ("label", "instance", "image", "compressed")


class CodecServer:
    """The codec over ``state`` (a ``SemanticCodec`` state dict) on
    ``device``, in the config's compute dtype: the s2d fast path when
    ``cfg.model.fast_inference`` is set, else the standard modules, as
    ``Trainer._fast`` decides (``jpdse_tpu/trainer.py:188-228``).

    ``times`` holds the host-clock ms of the stages of the last
    :meth:`compress` (``compress_codes``; ``idmap``, the id maps' coding,
    summed over the images; ``pack``, the whole packing stage, id maps
    included) or :meth:`decompress` (``unpack``, the id maps' decoding
    included; ``base_decode``, the base codec's decode and normalization;
    ``decompress_codes``, the device part), each ending with its result on
    the host. The base codec's encode runs in the data pipeline, which
    hands its streams to :meth:`compress` with the batch."""

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
                for k in DEVICE_KEYS if k in batch}

    @torch.inference_mode()
    def compress_codes(self, batch: Dict) -> List[torch.Tensor]:
        """``label`` (B, H, W), ``instance`` (B, H, W), ``image``
        (B, H, W, 3) and, under use_compressed, ``compressed`` (the base
        codec's decoded image, normalized) -> one uint8 {0, 1} tensor
        (B, h, w, C) per binarized module (netE4label, netE, netG), on the
        server's device. A sign of exactly 0 codes as 0, as
        ``codec_io.pack`` stores it."""
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
    def decompress_codes(self, codes: Sequence, side_batch: Optional[Dict] = None
                         ) -> torch.Tensor:
        """Codes as :meth:`compress_codes` gives them (tensors or arrays,
        {0, 1}) and, for what they do not carry, ``side_batch`` (a batch of
        the stream's side info, :meth:`side_batch`) -> image (B, H, W, 3),
        float32, on the server's device."""
        codes = [torch.as_tensor(c).to(self.device) for c in codes]
        side = None if side_batch is None else self._batch(side_batch)
        if self.fast is not None:
            return self.fast.decode_from_codes(codes, side).float()
        return self.codec.decode_from_codes(codes, self.codec.side_inputs(side)).float()

    def compress(self, batch: Dict) -> List[bytes]:
        """One ``.jpds`` stream per image of the batch: the codes, and the
        side info the configuration needs, with the base codec's streams
        (``base_codec_streams``, ``base_codec_ext``) as the data pipeline
        gives them. The streams of several images are packed on a thread
        pool (the coders release the GIL), as ``Trainer.compress`` packs
        them."""
        need_label, need_inst, need_base = codec_io.side_requirements(self.cfg)
        if not self.cfg.has_binary_codes and not (need_label or need_base):
            raise ValueError("nothing to pack: no binarized module and no side info in this "
                             "configuration")
        if need_base and "base_codec_streams" not in batch:
            raise ValueError("use_compressed batch lacks base_codec_streams — load data "
                             "through the framework loader (data/paired.py)")
        t0 = time.perf_counter()
        codes = []
        if self.cfg.has_binary_codes:
            codes = [c.cpu().numpy() for c in self.compress_codes(batch)]
        t1 = time.perf_counter()
        hw = tuple(int(s) for s in np.shape(batch["image"])[1:3])
        b = int(np.shape(batch["image"])[0])
        f = self.cfg.codec.sem_downsample
        idmap_ms = [0.0] * b

        def pack_one(j: int) -> bytes:
            side = codec_io.SideInfo()
            if need_label:
                side.label = codec_io.downsample_ids(
                    np.asarray(batch["label"][j]).astype(np.int32), f)
            if need_inst:
                side.instance = codec_io.downsample_ids(
                    np.asarray(batch["instance"][j]).astype(np.int32), f)
            if need_base:
                side.base_ext = batch["base_codec_ext"][j]
                side.base_payloads = list(batch["base_codec_streams"][j])
            blobs = None
            if need_label or need_inst:
                t = time.perf_counter()
                blobs = codec_io.sem_side_blobs(side.label, side.instance)
                idmap_ms[j] = (time.perf_counter() - t) * 1e3
            return codec_io.pack([c[j] for c in codes], hw, None if side.empty() else side,
                                 sem_blobs=blobs)

        if b == 1:
            streams = [pack_one(0)]
        else:
            with ThreadPoolExecutor(max_workers=min(8, b)) as ex:
                streams = list(ex.map(pack_one, range(b)))
        self.times = {"compress_codes": (t1 - t0) * 1e3, "idmap": sum(idmap_ms),
                      "pack": (time.perf_counter() - t1) * 1e3}
        return streams

    def side_batch(self, bs: codec_io.Bitstream) -> Optional[Dict]:
        """A batch of one image rebuilt from a parsed stream's side info, as
        the configuration needs it (None where it needs none): the label
        and instance maps, and the base codec's streams decoded, normalized
        and concatenated as ``compressed``. Raises where a section is
        missing."""
        need_label, need_inst, need_base = codec_io.side_requirements(self.cfg)
        if not (need_label or need_inst or need_base):
            return None
        h, w = bs.image_hw
        out: Dict = {"image": np.zeros((1, h, w, 3), np.float32)}
        if need_label:
            if bs.side.label is None:
                raise ValueError("bitstream lacks the label map this configuration needs")
            out["label"] = bs.side.label.astype(np.float32)[None]
        if need_inst:
            if bs.side.instance is None:
                raise ValueError("bitstream lacks the instance map this configuration needs")
            out["instance"] = bs.side.instance.astype(np.int32)[None]
        if need_base:
            if not bs.side.base_payloads:
                raise ValueError("bitstream lacks the base-codec payload this configuration "
                                 "needs")
            d = self.cfg.data
            out["compressed"] = np.concatenate(
                [normalize_decoded(decode_bytes(p, bs.side.base_ext), d.normalize_mean,
                                   d.normalize_std) for p in bs.side.base_payloads],
                axis=-1)[None]
        return out

    def decompress(self, data: bytes) -> np.ndarray:
        """One ``.jpds`` stream -> its image (H, W, 3), float32, from the
        stream and the model's weights alone. A stream of side info only
        runs the whole decode on it."""
        t0 = time.perf_counter()
        bs = codec_io.unpack_full(data)
        t1 = time.perf_counter()
        side = self.side_batch(bs)
        t2 = time.perf_counter()
        if bs.codes:
            image = self.decompress_codes(bs.codes, side)
        elif side is None:
            raise ValueError("empty bitstream: no codes and no side info")
        else:
            image = self.decode(side)
        image = image[0].cpu().numpy()
        self.times = {"unpack": (t1 - t0) * 1e3, "base_decode": (t2 - t1) * 1e3,
                      "decompress_codes": (time.perf_counter() - t2) * 1e3}
        return image
