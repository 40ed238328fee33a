"""The host's adaptive binary range coder, the port of the four entropy
coding functions of ``jpdse_tpu/native/__init__.py`` (:145-250).

The coder is ``csrc/range_coder.cpp`` (with ``csrc/rc_core.h``), the port's
own copy of ``jpdse_tpu/native/range_coder.cpp``, built with ``g++`` by
``ops/build.py`` at first use and bound here with ctypes. Its streams are
byte-identical to the JAX package's. A build that fails raises: there is no
other coder to fall back to.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from jpdse_tpu_torch.ops import build

_U8 = ctypes.POINTER(ctypes.c_uint8)
_I32 = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("range_coder")
    for name, res, args in (
        ("jpdse_rc_encode", ctypes.c_int64,
         [_U8, ctypes.c_int64, _I32, ctypes.c_int32, _U8, ctypes.c_int64]),
        ("jpdse_rc_decode", ctypes.c_int64,
         [_U8, ctypes.c_int64, _I32, ctypes.c_int32, _U8, ctypes.c_int64]),
        ("jpdse_rc_encode_spatial", ctypes.c_int64,
         [_U8, _I32, ctypes.c_int32, _U8, ctypes.c_int64]),
        ("jpdse_rc_decode_spatial", ctypes.c_int64,
         [_U8, ctypes.c_int64, _I32, ctypes.c_int32, _U8]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


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
