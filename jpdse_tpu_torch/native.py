"""The host's native code, the port of ``jpdse_tpu/native/__init__.py``:

* the adaptive binary range coder of the codes (``entropy_*``, :145-250),
  ``csrc/range_coder.cpp``;
* the context-modeled coder of the id maps (``idmap_encode`` /
  ``idmap_decode``, :253-314), ``csrc/idmap_coder.cpp``; both coders share
  ``csrc/rc_core.h``;
* the in-process HEVC-intra codec (``heif_available`` / ``heif_encode`` /
  ``heif_decode``, :316-374), ``csrc/heif_codec.cpp``, which dlopens
  libheif.

Each source is the port's own copy of the JAX package's, built with ``g++``
by ``ops/build.py`` at first use and bound here with ctypes; the coders'
streams are byte-identical to the JAX package's. A build that fails raises:
there is no other coder to fall back to. Where libheif or its HEVC plugins
do not load, ``heif_available()`` is False.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from jpdse_tpu_torch.ops import build

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)


_I64 = ctypes.c_int64
_INT = ctypes.POINTER(ctypes.c_int)


def _bind(library: str, signatures) -> ctypes.CDLL:
    lib = build.load_library(library)
    for name, res, args in signatures:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind("range_coder", (
        ("jpdse_rc_encode", _I64, [_U8, _I64, _I32, ctypes.c_int32, _U8, _I64]),
        ("jpdse_rc_decode", _I64, [_U8, _I64, _I32, ctypes.c_int32, _U8, _I64]),
        ("jpdse_rc_encode_spatial", _I64, [_U8, _I32, ctypes.c_int32, _U8, _I64]),
        ("jpdse_rc_decode_spatial", _I64, [_U8, _I64, _I32, ctypes.c_int32, _U8]),
    ))


@functools.cache
def _idmap_lib() -> ctypes.CDLL:
    return _bind("idmap_coder", (
        ("jpdse_idmap_encode", _I64, [_I32, _I64, _I64, _U8, _I64]),
        ("jpdse_idmap_decode", _I64, [_U8, _I64, _I32, _I64, _I64]),
        ("jpdse_idmap_encode_cond", _I64, [_I32, _I32, _I64, _I64, _U8, _I64]),
        ("jpdse_idmap_decode_cond", _I64, [_U8, _I64, _I32, _I32, _I64, _I64]),
    ))


@functools.cache
def _heif_lib() -> ctypes.CDLL:
    return _bind("heif_codec", (
        ("jpdse_heif_available", ctypes.c_int, []),
        ("jpdse_heif_encode", _I64,
         [_U8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, _U8, _I64]),
        ("jpdse_heif_decode", _I64, [_U8, _I64, _U8, _I64, _INT, _INT]),
    ))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8)


def _as_ctx(contexts: Optional[np.ndarray], n: int):
    """(contexts as int32 or None, the number of contexts)."""
    if contexts is None:
        return None, 1
    ctx = np.ascontiguousarray(contexts, dtype=np.int32)
    if ctx.size != n:
        raise ValueError(f"contexts size {ctx.size} != n bits {n}")
    return ctx, int(ctx.max()) + 1


def _ctx_ptr(ctx: Optional[np.ndarray]):
    return ctx.ctypes.data_as(_I32) if ctx is not None else None


def entropy_encode(bits: np.ndarray, contexts: Optional[np.ndarray] = None) -> bytes:
    """Encode a {0,1} bit array into a compressed bitstream; ``contexts``
    (one id per bit) gives each id its own adaptive model."""
    b = np.ascontiguousarray(bits.reshape(-1), dtype=np.uint8)
    n = b.size
    ctx, n_ctx = _as_ctx(contexts, n)
    # worst case ~n/8 plus the models' adaptation; an incompressible input
    # retries with room for every bit
    for cap in (n // 2 + 1024, n + 4096):
        out = np.empty(cap, dtype=np.uint8)
        size = _lib().jpdse_rc_encode(_u8(b), n, _ctx_ptr(ctx), n_ctx, _u8(out), cap)
        if size >= 0:
            return out[:size].tobytes()
    raise RuntimeError("range coder overflow")


def entropy_decode(data: bytes, n_bits: int, contexts: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode an :func:`entropy_encode` stream back into its ``n_bits`` bits."""
    src = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    ctx, n_ctx = _as_ctx(contexts, n_bits)
    bits = np.empty(n_bits, dtype=np.uint8)
    _lib().jpdse_rc_decode(_u8(src), src.size, _ctx_ptr(ctx), n_ctx, _u8(bits), n_bits)
    return bits


def _spatial_shapes(shapes) -> Tuple[np.ndarray, int]:
    arr = np.ascontiguousarray(np.asarray(shapes, dtype=np.int32).reshape(-1, 3))
    return arr, int(np.prod(arr.astype(np.int64), axis=1).sum())


def entropy_encode_spatial(bits: np.ndarray, shapes) -> bytes:
    """Encode concatenated per-code NHWC bit rasters, ``shapes`` a sequence
    of (h, w, c), with one adaptive model per (code, channel, left bit, up
    bit)."""
    b = np.ascontiguousarray(bits.reshape(-1), dtype=np.uint8)
    sh, n_bits = _spatial_shapes(shapes)
    if b.size != n_bits:
        raise ValueError(f"bits size {b.size} != shapes total {n_bits}")
    for cap in (n_bits // 2 + 1024, n_bits + 4096):
        out = np.empty(cap, dtype=np.uint8)
        size = _lib().jpdse_rc_encode_spatial(_u8(b), sh.ctypes.data_as(_I32), sh.shape[0],
                                              _u8(out), cap)
        if size >= 0:
            return out[:size].tobytes()
    raise RuntimeError("range coder overflow")


def entropy_decode_spatial(data: bytes, shapes) -> np.ndarray:
    """Decode an :func:`entropy_encode_spatial` stream back into its bits."""
    src = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    sh, n_bits = _spatial_shapes(shapes)
    bits = np.empty(n_bits, dtype=np.uint8)
    _lib().jpdse_rc_decode_spatial(_u8(src), src.size, sh.ctypes.data_as(_I32), sh.shape[0],
                                   _u8(bits))
    return bits


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_I32)


def _cond(cond: Optional[np.ndarray], shape) -> np.ndarray:
    c = np.ascontiguousarray(cond, dtype=np.int32)
    if c.shape != tuple(shape):
        raise ValueError(f"cond shape {c.shape} != id map shape {tuple(shape)}")
    return c


def idmap_encode(ids: np.ndarray, cond: Optional[np.ndarray] = None) -> bytes:
    """Losslessly encode an (H, W) int32 id map with the context-modeled
    range coder. With ``cond`` (a same-shape map the decoder already has,
    the label map when coding the instance map) each neighbour-match bit is
    also conditioned on whether ``cond`` agrees across that edge; such a
    stream decodes only with the same ``cond``. Raises RuntimeError where
    the output outgrows its worst-case buffer (a near-random map)."""
    a = np.ascontiguousarray(ids, dtype=np.int32)
    if a.ndim != 2:
        raise ValueError(f"expected (H, W) id map, got shape {a.shape}")
    h, w = a.shape
    cap = a.size * 5 + 4096  # every pixel a literal
    out = np.empty(cap, dtype=np.uint8)
    if cond is not None:
        size = _idmap_lib().jpdse_idmap_encode_cond(_i32(a), _i32(_cond(cond, a.shape)), h, w,
                                                    _u8(out), cap)
    else:
        size = _idmap_lib().jpdse_idmap_encode(_i32(a), h, w, _u8(out), cap)
    if size < 0:
        raise RuntimeError("idmap coder overflow")
    return out[:size].tobytes()


def idmap_decode(data: bytes, h: int, w: int, cond: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode an :func:`idmap_encode` stream back to its (h, w) int32 map,
    with the ``cond`` it was encoded with."""
    src = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    out = np.empty((h, w), dtype=np.int32)
    if cond is not None:
        _idmap_lib().jpdse_idmap_decode_cond(_u8(src), src.size, _i32(out),
                                             _i32(_cond(cond, (h, w))), h, w)
    else:
        _idmap_lib().jpdse_idmap_decode(_u8(src), src.size, _i32(out), h, w)
    return out


def heif_available() -> bool:
    """Whether libheif loads with an HEVC encoder (x265) and decoder
    (de265)."""
    return bool(_heif_lib().jpdse_heif_available())


def heif_encode(rgb: np.ndarray, quality: int = 50, preset: str = "fast") -> bytes:
    """An (H, W, 3) uint8 RGB array -> an HEVC-intra (HEIF) stream, in
    memory; ``quality`` in [0, 100], ``preset`` x265's speed preset."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w = rgb.shape[:2]
    cap = w * h * 3 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    size = _heif_lib().jpdse_heif_encode(_u8(rgb), w, h, int(quality),
                                         preset.encode() if preset else None, _u8(out), cap)
    if size < 0:
        raise RuntimeError(f"heif encode failed (code {size})")
    return out[:size].tobytes()


def heif_decode(data: bytes) -> np.ndarray:
    """An HEVC-intra (HEIF) stream -> its (H, W, 3) uint8 RGB array."""
    src = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))
    w, h = ctypes.c_int(), ctypes.c_int()
    # a guess first; a buffer too small (-2) reports the decoded size, and
    # the retry takes exactly that
    cap = max(len(data) * 256, 1 << 22)
    for _ in range(2):
        out = np.empty(cap, dtype=np.uint8)
        rc = _heif_lib().jpdse_heif_decode(_u8(src), src.size, _u8(out), cap, ctypes.byref(w),
                                           ctypes.byref(h))
        if rc != -2:
            break
        cap = w.value * h.value * 3
    if rc != 0:
        raise RuntimeError(f"heif decode failed (code {rc})")
    return out[: w.value * h.value * 3].reshape(h.value, w.value, 3).copy()
