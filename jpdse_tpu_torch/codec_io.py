"""The ``.jpds`` bitstream, the port's own copy of ``jpdse_tpu/codec_io.py``
for streams that carry codes only:

    [magic 'JPDS'][u8 version][u16 H][u16 W]          image size (fine)
    [u8 n_codes] { [u16 h][u16 w][u16 c] } * n_codes  per-code shapes
    v3 only: [u8 coder_mode]                          1 = spatial contexts
    [u32 payload_bytes][payload]                      range-coded bits
    v2, v3: [u8 flags] and the side-info sections the flags announce

The payload is every code's bits (NHWC order per code), range-coded by
``native`` with per-channel contexts (version 1) or with (channel, left
bit, up bit) contexts (version 3, ``coder_mode`` 1). :func:`pack` codes
both ways and keeps the smaller stream, charging v3 its two extra bytes, so
its output is byte-identical to ``jpdse_tpu.codec_io.pack`` of the same
codes. :func:`unpack_full` reads versions 1 to 3. Side info (label and
instance maps, a base codec's payload) is not ported: a stream whose flags
announce any raises :class:`SideInfoNotPorted` rather than being decoded
without it; :func:`side_requirements` says which configurations need it.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Sequence, Tuple

import numpy as np

from jpdse_tpu_torch import native

MAGIC = b"JPDS"
VERSION = 1
VERSION2 = 2  # adds the side-info flags byte and sections
VERSION3 = 3  # adds the coder-mode byte; the flags byte is always there
_SIDE_SECTIONS = {1: "label map", 2: "instance map", 4: "base codec payload",
                  8: "label derived from the instance map"}


class SideInfoNotPorted(ValueError):
    """The stream carries side info, or the configuration needs it, which
    this package cannot code yet (ROADMAP Queue 1 item 5)."""


def side_requirements(cfg) -> Tuple[bool, bool, bool]:
    """Which side-info sections a configuration needs for a complete
    decodable stream: (need_label, need_instance, need_base). Raises
    ValueError for configurations whose visuals are raw *uncompressed*
    pixels (no stream represents them)."""
    m = cfg.model
    if not m.no_generator_binarization:
        # the generator's bottleneck code carries everything before it
        return False, False, False
    sem_in_codes = cfg.use_netE4label and not m.no_label_encoder_binarization
    vis_in_codes = (not m.no_feat) and cfg.use_netE and not m.no_encoder_binarization
    vis_raw = (not m.no_feat) and not vis_in_codes
    if m.sem_masking:
        need_label = vis_raw  # the label only shapes the semantic mask
    else:
        need_label = (not m.no_label) and not sem_in_codes
    need_inst = (not m.no_instance) and need_label
    if vis_raw and m.inst_wise_pool and cfg.use_netE:
        need_inst = True  # an unbinarized encoder pools over instance ids
    need_base = vis_raw and cfg.codec.use_compressed
    if vis_raw and not cfg.codec.use_compressed:
        raise ValueError(
            "this configuration feeds raw uncompressed pixels to the generator "
            "(no_feat_encoding without use_compressed) — there is no bitstream "
            "representation for it")
    return need_label, need_inst, need_base


def contexts_for_shapes(shapes: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """Per-bit context ids for the per-channel adaptive models: the channel
    index within its code, offset so that different codes never share a
    context. Encoder and decoder must derive them identically."""
    ctxs, offset = [], 0
    for h, w, c in shapes:
        ctxs.append(np.tile(np.arange(c, dtype=np.int32), h * w) + offset)
        offset += c
    return np.concatenate(ctxs) if ctxs else np.zeros(0, np.int32)


@dataclasses.dataclass
class Bitstream:
    codes: List[np.ndarray]  # (1, h, w, c) float32 {0,1}
    image_hw: Tuple[int, int]


def pack(codes: List[np.ndarray], image_hw: Tuple[int, int]) -> bytes:
    """codes: per-module (h, w, c) or (1, h, w, c) {0,1} arrays of ONE
    image -> a version-1 or version-3 stream, whichever is smaller."""
    if not codes:
        raise ValueError("pack() needs at least one code: side-info-only streams are not ported")
    shapes, flats = [], []
    for c in codes:
        c = np.asarray(c)
        if c.ndim == 4:
            if c.shape[0] != 1:
                raise ValueError("pack() takes one image at a time")
            c = c[0]
        shapes.append(tuple(int(s) for s in c.shape))
        flats.append(c.reshape(-1).astype(np.uint8))
    bits = np.concatenate(flats)
    payload = native.entropy_encode(bits, contexts=contexts_for_shapes(shapes))
    spatial = native.entropy_encode_spatial(bits, shapes)
    # v3 costs a coder-mode byte and a flags byte that v1 does not carry, so
    # a near tie never gives a v3 stream larger than the v1 one
    v3 = len(spatial) + 2 < len(payload)
    if v3:
        payload = spatial
    out = bytearray(MAGIC)
    out += struct.pack("<BHH", VERSION3 if v3 else VERSION, image_hw[0], image_hw[1])
    out += struct.pack("<B", len(shapes))
    for h, w, c in shapes:
        out += struct.pack("<HHH", h, w, c)
    if v3:
        out += struct.pack("<B", 1)
    out += struct.pack("<I", len(payload))
    out += payload
    if v3:
        out += struct.pack("<B", 0)  # no side info
    return bytes(out)


def unpack_full(data: bytes) -> Bitstream:
    """Parse a version-1, -2 or -3 stream into its codes and image size.
    Raises ValueError on a malformed stream and SideInfoNotPorted when the
    flags announce side info."""
    if data[:4] != MAGIC:
        raise ValueError("not a .jpds bitstream (bad magic)")

    off = 4

    def take(fmt: str):
        nonlocal off
        try:
            vals = struct.unpack_from(fmt, data, off)
        except struct.error:
            raise ValueError("truncated .jpds header") from None
        off += struct.calcsize(fmt)
        return vals

    ver, h_img, w_img = take("<BHH")
    if ver not in (VERSION, VERSION2, VERSION3):
        raise ValueError(f"unsupported .jpds version {ver}")
    (n_codes,) = take("<B")
    shapes = [take("<HHH") for _ in range(n_codes)]
    coder_mode = 0
    if ver == VERSION3:
        (coder_mode,) = take("<B")
        if coder_mode not in (0, 1):
            raise ValueError(f"unknown .jpds coder mode {coder_mode}")
    (payload_bytes,) = take("<I")
    payload = data[off: off + payload_bytes]
    if len(payload) != payload_bytes:
        raise ValueError(f"truncated .jpds: payload declares {payload_bytes} bytes, "
                         f"{len(payload)} present")
    off += payload_bytes
    if ver in (VERSION2, VERSION3):
        (flags,) = take("<B")
        if flags:
            sections = [name for bit, name in _SIDE_SECTIONS.items() if flags & bit]
            raise SideInfoNotPorted(
                f".jpds side info ({', '.join(sections) or f'flags {flags:#x}'}) is not "
                "ported to jpdse_tpu_torch: only code-only streams decode here")
    n_bits = sum(h * w * c for h, w, c in shapes)
    if n_bits and coder_mode == 1:
        bits = native.entropy_decode_spatial(payload, shapes)
    elif n_bits:
        bits = native.entropy_decode(payload, n_bits, contexts=contexts_for_shapes(shapes))
    else:
        bits = np.zeros(0, np.uint8)
    codes, pos = [], 0
    for h, w, c in shapes:
        n = h * w * c
        codes.append(bits[pos: pos + n].reshape(1, h, w, c).astype(np.float32))
        pos += n
    return Bitstream(codes=codes, image_hw=(h_img, w_img))


def unpack(data: bytes) -> Tuple[List[np.ndarray], Tuple[int, int]]:
    """(codes [(1, h, w, c) float32 {0,1}], (H, W)) of a code-only stream."""
    bs = unpack_full(data)
    return bs.codes, bs.image_hw
