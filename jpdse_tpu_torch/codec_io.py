"""The ``.jpds`` bitstream, the port's own copy of ``jpdse_tpu/codec_io.py``:

    [magic 'JPDS'][u8 version][u16 H][u16 W]          image size (fine)
    [u8 n_codes] { [u16 h][u16 w][u16 c] } * n_codes  per-code shapes
    v3 only: [u8 coder_mode]                          1 = spatial contexts
    [u32 payload_bytes][payload]                      range-coded bits
    v2, v3: [u8 flags]                                bit 0 label, bit 1
                                                      instance, bit 2 base
                                                      codec, bit 3 label
                                                      derived from instance
    label:    [u32 len][blob]                         id-map container:
    instance: [u32 len][blob]                         PNG, IDRC or IDRX
    base:     [u8 ext_len][ext][u8 n_payloads] { [u32 len][bytes] } *

The payload is every code's bits (NHWC order per code), range-coded by
``native`` with per-channel contexts (version 1) or with (channel, left
bit, up bit) contexts (version 3, ``coder_mode`` 1); a stream with no code
has a payload of 0 bytes. :func:`pack` codes both ways and keeps the
smaller stream, charging v3 its extra bytes. The side-info sections carry
what the codes do not: the label and instance maps, each in the smallest of
PNG, the context-modeled id-map coder (IDRC) and that coder conditioned on
the label map (IDRX), with the label map left out where the instance map
implies it; and the base codec's own streams. Maps may ride downsampled
(``codec.sem_downsample``) and come back to full size on unpack. Every
stream is byte-identical to ``jpdse_tpu.codec_io.pack`` of the same inputs,
and :func:`unpack_full` reads versions 1 to 3.
"""

from __future__ import annotations

import dataclasses
import io
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from jpdse_tpu_torch import native

MAGIC = b"JPDS"
VERSION = 1
VERSION2 = 2  # adds the side-info flags byte and sections
VERSION3 = 3  # adds the coder-mode byte; the flags byte is always there
IDRC_MAGIC = b"IDRC"  # the id-map coder
IDRX_MAGIC = b"IDRX"  # the id-map coder conditioned on the label map


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


def downsample_ids(arr: np.ndarray, factor: int) -> np.ndarray:
    """Every ``factor``-th sample of an (H, W) id map (``codec.sem_downsample``),
    the numpy twin of ``ops/semantics.degrade_ids``'s downsample."""
    if factor <= 1:
        return arr
    return np.ascontiguousarray(np.asarray(arr)[::factor, ::factor])


def upsample_ids(arr: np.ndarray, factor: int, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest upsample back to ``hw``, the inverse of :func:`downsample_ids`."""
    if factor <= 1:
        return arr
    up = np.repeat(np.repeat(np.asarray(arr), factor, axis=0), factor, axis=1)
    return np.ascontiguousarray(up[: hw[0], : hw[1]])


def _upsample_side_maps(side: "SideInfo", hw: Tuple[int, int]) -> None:
    """Each map smaller than the image back to full size by its implied
    integer factor (the containers carry their own size); raises where the
    size is no nearest downsample of the image's."""
    H, W = hw
    for name in ("label", "instance"):
        m = getattr(side, name)
        if m is None or m.shape == (H, W):
            continue
        h, w = m.shape
        f = max(1, round(H / h))
        if (-(-H // f), -(-W // f)) != (h, w):  # ::f keeps ceil(H / f) rows
            raise ValueError(
                f".jpds {name} map is {m.shape}, which is not an integer "
                f"nearest-downsample of the {H}x{W} image")
        setattr(side, name, upsample_ids(m, f, hw))


@dataclasses.dataclass
class SideInfo:
    """Everything in a ``.jpds`` stream beyond the learned codes."""

    label: Optional[np.ndarray] = None      # (H, W) label ids
    instance: Optional[np.ndarray] = None   # (H, W) instance ids
    base_ext: Optional[str] = None          # the codec that decodes the payloads
    base_payloads: Optional[List[bytes]] = None  # one per quality

    def empty(self) -> bool:
        return self.label is None and self.instance is None and not self.base_payloads


@dataclasses.dataclass
class Bitstream:
    codes: List[np.ndarray]  # (1, h, w, c) float32 {0,1}
    image_hw: Tuple[int, int]
    side: SideInfo = dataclasses.field(default_factory=SideInfo)


def encode_idmap_png(arr: np.ndarray) -> bytes:
    """Lossless PNG of an id map: 8-bit where the ids fit, else 16-bit
    ('I;16'); ids outside [0, 65535] raise."""
    from PIL import Image

    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        if arr.min() < 0 or arr.max() > 0xFFFF:
            raise ValueError(f"id map out of uint16 range [{arr.min()}, {arr.max()}]")
        arr = arr.astype(np.uint8 if arr.max() <= 0xFF else np.uint16)
    img = Image.fromarray(arr)  # mode L for uint8, I;16 for uint16
    buf = io.BytesIO()
    img.save(buf, format="PNG", optimize=True)
    return buf.getvalue()


def decode_idmap_png(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)))


def encode_idmap(arr: np.ndarray, cond: Optional[np.ndarray] = None) -> bytes:
    """An id map in the smallest of three self-describing containers: PNG,
    ``IDRC`` + u32 h + u32 w + the id-map coder's stream, and with ``cond``
    (a same-shape map the decoder already has) ``IDRX``, the same coder
    conditioned on ``cond``. An input on which one coder overflows its
    buffer leaves that container out, each on its own."""
    arr = np.asarray(arr)
    best = encode_idmap_png(arr)
    if arr.ndim != 2:
        return best
    coders = [(IDRC_MAGIC, None)]
    if cond is not None:
        coders.append((IDRX_MAGIC, np.asarray(cond).astype(np.int32)))
    for magic, c in coders:
        try:
            rc = native.idmap_encode(arr.astype(np.int32), cond=c)
        except RuntimeError:
            continue
        blob = magic + struct.pack("<II", *arr.shape) + rc
        if len(blob) < len(best):
            best = blob
    return best


def decode_idmap(data: bytes, cond: Optional[np.ndarray] = None) -> np.ndarray:
    """Either container of :func:`encode_idmap` -> int32; ``IDRX`` needs the
    ``cond`` it was coded with."""
    if data[:4] == IDRX_MAGIC:
        if cond is None:
            raise ValueError("conditionally-coded id map (IDRX) needs its cond map "
                             "(the label map decoded from the same stream)")
        h, w = struct.unpack_from("<II", data, 4)
        return native.idmap_decode(data[12:], h, w, cond=np.asarray(cond).astype(np.int32))
    if data[:4] == IDRC_MAGIC:
        h, w = struct.unpack_from("<II", data, 4)
        return native.idmap_decode(data[12:], h, w)
    return decode_idmap_png(data).astype(np.int32)


def derive_label_from_instance(inst: np.ndarray) -> np.ndarray:
    """Cityscapes' id convention: a thing's instance id is label * 1000 +
    index, a stuff pixel's is its label id."""
    inst = np.asarray(inst).astype(np.int32)
    return np.where(inst >= 1000, inst // 1000, inst).astype(np.int32)


def sem_side_blobs(label: Optional[np.ndarray], instance: Optional[np.ndarray]
                   ) -> Tuple[Optional[bytes], Optional[bytes], bool]:
    """The semantic sections as :func:`pack` writes them: (label blob,
    instance blob, whether the label is derived). Where the instance map
    implies the label map exactly, the label section is dropped; otherwise
    the instance map is coded conditioned on the label map. The eval
    harness counts these same bytes."""
    derived = (label is not None and instance is not None
               and np.array_equal(derive_label_from_instance(instance),
                                  np.asarray(label).astype(np.int32)))
    label_blob = None
    if label is not None and not derived:
        label_blob = encode_idmap(np.asarray(label))
    inst_blob = None
    if instance is not None:
        cond = None if (label is None or derived) else label
        inst_blob = encode_idmap(np.asarray(instance), cond=cond)
    return label_blob, inst_blob, derived


def pack(codes: List[np.ndarray], image_hw: Tuple[int, int],
         side: Optional[SideInfo] = None, sem_blobs=None) -> bytes:
    """codes: per-module (h, w, c) or (1, h, w, c) {0,1} arrays of ONE
    image, possibly none -> a version-1, -2 or -3 stream: v3 where the
    spatial contexts code smaller, v2 where ``side`` holds side info.
    ``sem_blobs``: :func:`sem_side_blobs` of ``side``'s maps where the
    caller has coded them already."""
    shapes, flats = [], []
    for c in codes:
        c = np.asarray(c)
        if c.ndim == 4:
            if c.shape[0] != 1:
                raise ValueError("pack() takes one image at a time")
            c = c[0]
        shapes.append(tuple(int(s) for s in c.shape))
        flats.append(c.reshape(-1).astype(np.uint8))
    has_side = side is not None and not side.empty()
    v3 = False
    payload = b""  # a side-info-only stream
    if flats:
        bits = np.concatenate(flats)
        payload = native.entropy_encode(bits, contexts=contexts_for_shapes(shapes))
        spatial = native.entropy_encode_spatial(bits, shapes)
        # v3 costs a coder-mode byte, and a flags byte where v1 carries
        # none, so a near tie never gives a larger v3 stream
        v3 = len(spatial) + (1 if has_side else 2) < len(payload)
        if v3:
            payload = spatial
    out = bytearray(MAGIC)
    out += struct.pack("<BHH", VERSION3 if v3 else (VERSION2 if has_side else VERSION),
                       image_hw[0], image_hw[1])
    out += struct.pack("<B", len(shapes))
    for h, w, c in shapes:
        out += struct.pack("<HHH", h, w, c)
    if v3:
        out += struct.pack("<B", 1)
    out += struct.pack("<I", len(payload))
    out += payload
    if has_side or v3:
        side = side or SideInfo()
        if sem_blobs is None:
            sem_blobs = sem_side_blobs(side.label, side.instance)
        label_blob, inst_blob, derived = sem_blobs
        out += struct.pack("<B", (1 if label_blob is not None else 0)
                           | (2 if inst_blob is not None else 0)
                           | (4 if side.base_payloads else 0) | (8 if derived else 0))
        for blob in (label_blob, inst_blob):
            if blob is not None:
                out += struct.pack("<I", len(blob)) + blob
        if side.base_payloads:
            ext = (side.base_ext or "").encode("ascii")
            if not ext:
                raise ValueError("base payloads require base_ext")
            out += struct.pack("<B", len(ext)) + ext
            out += struct.pack("<B", len(side.base_payloads))
            for p in side.base_payloads:
                out += struct.pack("<I", len(p)) + p
    return bytes(out)


def unpack_full(data: bytes) -> Bitstream:
    """Parse a version-1, -2 or -3 stream into its codes, image size and
    side info (maps at full size). Raises ValueError on a malformed stream."""
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

    side = SideInfo()
    if ver in (VERSION2, VERSION3):
        def section(n: int) -> bytes:
            nonlocal off
            chunk = data[off: off + n]
            if len(chunk) != n:
                raise ValueError("truncated .jpds side-info section")
            off += n
            return chunk

        def length(fmt: str) -> int:
            return struct.unpack(fmt, section(struct.calcsize(fmt)))[0]

        flags = length("<B")
        if flags & 1:
            side.label = decode_idmap(section(length("<I")))
        if flags & 2:
            side.instance = decode_idmap(section(length("<I")), cond=side.label)
        if flags & 8:
            if side.instance is None:
                raise ValueError(".jpds side-info flags inconsistent: derived-label flag "
                                 "(bit 3) set without an instance section (bit 2)")
            side.label = derive_label_from_instance(side.instance)
        if flags & 4:
            side.base_ext = section(length("<B")).decode("ascii")
            side.base_payloads = [section(length("<I")) for _ in range(length("<B"))]
        _upsample_side_maps(side, (h_img, w_img))
    return Bitstream(codes=codes, image_hw=(h_img, w_img), side=side)


def unpack(data: bytes) -> Tuple[List[np.ndarray], Tuple[int, int]]:
    """(codes [(1, h, w, c) float32 {0,1}], (H, W)); the side info is
    parsed and dropped (:func:`unpack_full` keeps it)."""
    bs = unpack_full(data)
    return bs.codes, bs.image_hw
