"""The base-codec bridge, the port of ``jpdse_tpu/codecs/bridge.py``: an
image through an external codec and back, on the host, with the bytes of
its stream.

jpg, webp, j2k and avif go through PIL in memory (``BytesIO``) with the JAX
package's settings; heif through the in-process HEVC-intra codec
(``native.heif_*``, libheif with x265 and de265). bpg runs the ``bpgenc`` /
``bpgdec`` binaries where they are on PATH; without them it falls back to
heif at ``q_heif = 100 - 2 * q_bpg`` (BPG is HEVC intra), once noted. A
codec that cannot run here raises :class:`CodecUnavailable`.
"""

from __future__ import annotations

import functools
import io
import os
import shutil
import subprocess
import tempfile
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

from jpdse_tpu_torch import native


class CodecUnavailable(RuntimeError):
    pass


_BPG_ENC = shutil.which("bpgenc")
_BPG_DEC = shutil.which("bpgdec")
_PIL_FMT = {"jpg": "JPEG", "webp": "WEBP", "avif": "AVIF", "j2k": "JPEG2000"}


@functools.cache
def _heif_ok() -> bool:
    """Whether the HEVC codec runs here; it cannot change within a process."""
    return native.heif_available()


def available_codecs() -> List[str]:
    codecs = ["jpg", "webp", "j2k"]
    from PIL import features

    if features.check("avif"):
        codecs.append("avif")
    if _heif_ok():
        codecs.append("heif")
    if (_BPG_ENC and _BPG_DEC) or _heif_ok():
        codecs.append("bpg")
    return codecs


def _scratch_dir() -> str:
    for base in ("/dev/shm", tempfile.gettempdir()):
        if os.path.isdir(base) and os.access(base, os.W_OK):
            return base
    return "."


def _run_bpg(tool: str, args: Sequence[str], src: Tuple[str, bytes], dst: str) -> bytes:
    """Write ``src`` (suffix, bytes) to a unique scratch file, run ``tool``
    on it writing ``dst`` (a suffix), and return what it wrote."""
    stem = os.path.join(_scratch_dir(), f"jpdse_{uuid.uuid4().hex}")
    inp, out = stem + src[0], stem + "_out" + dst
    try:
        with open(inp, "wb") as f:
            f.write(src[1])
        subprocess.run([tool, *args, "-o", out, inp], check=True, capture_output=True)
        with open(out, "rb") as f:
            return f.read()
    finally:
        for p in (inp, out):
            if os.path.exists(p):
                os.unlink(p)


_bpg_fallback_noted = False


def encode_bytes(img: "Image.Image | np.ndarray", ext: str, quality: int) -> Tuple[bytes, str]:
    """One RGB image -> (the base codec's stream, the codec that decodes
    it): 'bpg' without its binaries resolves to 'heif'. Quality scales
    follow the reference's converter."""
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img = img.convert("RGB")
    if ext in _PIL_FMT:
        kwargs = ({"quality_mode": "rates", "quality_layers": [quality]} if ext == "j2k"
                  else {"quality": int(quality)})
        buf = io.BytesIO()
        img.save(buf, format=_PIL_FMT[ext], **kwargs)
        return buf.getvalue(), ext
    if ext == "heif":
        if not _heif_ok():
            raise CodecUnavailable("in-process HEVC codec unavailable (libheif/x265/de265 not "
                                   "loadable) — use ext in {jpg, webp, j2k}")
        return native.heif_encode(np.asarray(img, np.uint8), quality=int(quality)), "heif"
    if ext == "bpg":
        if _BPG_ENC and _BPG_DEC:
            png = io.BytesIO()
            img.save(png, format="PNG")
            return _run_bpg(_BPG_ENC, ["-q", str(int(quality))], (".png", png.getvalue()),
                            ".bpg"), "bpg"
        if not _heif_ok():
            raise CodecUnavailable("bpgenc/bpgdec not found on PATH — install libbpg or use "
                                   "ext in {jpg, webp, j2k, heif}")
        # bpgenc -q is a quantizer in [0, 51], lower is better; libheif's
        # quality is in [0, 100], higher is better
        global _bpg_fallback_noted
        if not _bpg_fallback_noted:
            _bpg_fallback_noted = True
            print("note: bpgenc/bpgdec binaries absent; using the in-process HEVC-intra codec "
                  "(ext heif) with q_heif = 100 - 2*q_bpg")
        return encode_bytes(img, "heif", max(0, min(100, 100 - 2 * int(quality))))
    raise ValueError("format must be one of jpg, webp, j2k, avif, heif, or bpg")


def decode_bytes(stream: bytes, ext: str) -> np.ndarray:
    """A base-codec stream, with the codec :func:`encode_bytes` returned
    for it -> uint8 RGB (H, W, 3)."""
    if ext in _PIL_FMT:
        img = Image.open(io.BytesIO(stream))
        img.load()
        return np.asarray(img.convert("RGB"), np.uint8)
    if ext == "heif":
        return native.heif_decode(stream)
    if ext == "bpg":
        if not _BPG_DEC:
            raise CodecUnavailable("bpgdec not found on PATH")
        png = _run_bpg(_BPG_DEC, [], (".bpg", stream), ".png")
        return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"), np.uint8)
    raise ValueError(f"unknown codec {ext}")


def encode_decode(img: "Image.Image | np.ndarray", ext: str, quality: int
                  ) -> Tuple[Image.Image, int]:
    """One image through the base codec: (decoded RGB image, stream bytes)."""
    stream, eff = encode_bytes(img, ext, quality)
    return Image.fromarray(decode_bytes(stream, eff)), len(stream)


@functools.cache
def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4))


def batch_encode_decode(imgs: Sequence["Image.Image | np.ndarray"], ext: str, quality: int
                        ) -> List[Tuple[Image.Image, int]]:
    """:func:`encode_decode` of each image on a thread pool (PIL, libheif
    and the codec binaries release the GIL)."""
    return list(_pool().map(lambda im: encode_decode(im, ext, quality), imgs))


def normalize_decoded(rgb_u8: np.ndarray, mean, std) -> np.ndarray:
    """uint8 HWC -> the model's normalized float32."""
    arr = rgb_u8.astype(np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def compress_for_model(img_uint8: np.ndarray, ext: str, qualities: Sequence[int], mean, std,
                       return_streams: bool = False):
    """One uint8 HWC image through the base codec at each quality, each
    decoded image normalized, concatenated on the channel axis: (float32
    (H, W, 3 * len(qualities)), total stream bytes); with
    ``return_streams`` also (the streams, the codec that decodes them), so
    a ``.jpds`` stream can carry them (``codec_io.SideInfo``)."""
    outs, streams, total, eff = [], [], 0, ext
    for q in qualities:
        stream, eff = encode_bytes(img_uint8, ext, q)
        streams.append(stream)
        total += len(stream)
        outs.append(normalize_decoded(decode_bytes(stream, eff), mean, std))
    cat = np.concatenate(outs, axis=-1)
    if return_streams:
        return cat, total, streams, eff
    return cat, total
