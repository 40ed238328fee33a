"""The ``.jpds`` side info of the PyTorch port against the JAX package's, on
the CPU: the id-map coder and its containers (``encode_idmap`` /
``decode_idmap``: IDRC, IDRX and PNG, each winner and each coder's
overflow), the label derived from the instance map, ``sem_side_blobs``,
``pack`` with ``SideInfo`` (label and / or instance maps, base payloads,
with and without codes, v2 and v3), each package's ``unpack_full`` of the
other's stream, maps shipped at ``codec.sem_downsample`` and the errors of
malformed side-info sections. Streams are byte-identical and round trips
exact; inputs are made from seeds with numpy."""

import struct

import numpy as np
import pytest

from jpdse_tpu import codec_io as jax_io
from jpdse_tpu import native as jax_native
from jpdse_tpu_torch import codec_io, native
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W = 64, 128


def _blocky(rng, lo, hi, hw=(H, W), cell=8):
    """A piecewise-constant id map, as semantic maps are."""
    coarse = rng.integers(lo, hi, (-(-hw[0] // cell), -(-hw[1] // cell)))
    return np.repeat(np.repeat(coarse, cell, 0), cell, 1)[: hw[0], : hw[1]].astype(np.int32)


def _label_and_instance(seed: int, derivable: bool):
    """Cityscapes-like maps: label ids, and instance ids label * 1000 + k on
    things; ``derivable`` False breaks the convention at one cell."""
    rng = np.random.default_rng(seed)
    label = _blocky(rng, 0, 34)
    sub = _blocky(rng, 0, 4, cell=16)
    inst = np.where(label >= 24, label * 1000 + sub, label).astype(np.int32)
    if not derivable:
        label[:8, :8] = 0
        inst[:8, :8] = 7
    return label, inst


def _ramp(dtype, mod, offset=0):
    y, x = np.mgrid[0:H, 0:W]
    return ((x * 7 + y * 13) % mod + offset).astype(dtype)


def _idmap_cases():
    label, inst = _label_and_instance(1, derivable=False)
    rng = np.random.default_rng(2)
    return {
        # name: (map, cond, the container that wins)
        "uint8 label": (label.astype(np.uint8), None, jax_io.IDRC_MAGIC),
        "int32 instance > 255": (_blocky(rng, 300, 60000), None, jax_io.IDRC_MAGIC),
        "instance given the label": (inst, label, jax_io.IDRX_MAGIC),
        "uint8 ramp": (_ramp(np.uint8, 251), None, b"\x89PNG"),
        "int32 ramp > 255": (_ramp(np.int32, 4000, 300), label, b"\x89PNG"),
    }


IDMAP_CASES = _idmap_cases()


@pytest.mark.parametrize("name", sorted(IDMAP_CASES))
def test_encode_idmap_is_byte_identical_and_round_trips(name):
    arr, cond, magic = IDMAP_CASES[name]
    got = codec_io.encode_idmap(arr, cond=cond)
    assert got == jax_io.encode_idmap(arr, cond=cond)
    assert got[:4] == magic
    for decode in (codec_io.decode_idmap, jax_io.decode_idmap):
        back = decode(got, cond=cond)
        assert back.dtype == np.int32
        np.testing.assert_array_equal(back, arr)


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "cond"])
def test_native_idmap_coder_matches_jax(cond):
    label, inst = _label_and_instance(3, derivable=False)
    c = label if cond else None
    got = native.idmap_encode(inst, cond=c)
    assert got == jax_native.idmap_encode(inst, cond=c)
    np.testing.assert_array_equal(native.idmap_decode(got, H, W, cond=c), inst)
    np.testing.assert_array_equal(jax_native.idmap_decode(got, H, W, cond=c), inst)
    with pytest.raises(ValueError, match="cond shape"):
        native.idmap_encode(inst, cond=label[:4])
    with pytest.raises(ValueError, match=r"expected \(H, W\) id map"):
        native.idmap_encode(inst[None])


@pytest.mark.parametrize("overflows", ["plain", "cond", "both"])
def test_each_coder_overflows_on_its_own(overflows, monkeypatch):
    """A coder that overflows its buffer (a near-random 32-bit map) leaves
    only its own container out, in both packages alike."""
    label, inst = _label_and_instance(4, derivable=False)
    for mod in (native, jax_native):
        real = mod.idmap_encode

        def fake(arr, cond=None, real=real):
            if overflows == "both" or (cond is None) == (overflows == "plain"):
                raise RuntimeError("idmap coder overflow")
            return real(arr, cond=cond)

        monkeypatch.setattr(mod, "idmap_encode", fake)
    got = codec_io.encode_idmap(inst, cond=label)
    assert got == jax_io.encode_idmap(inst, cond=label)
    want = {"plain": jax_io.IDRX_MAGIC, "cond": jax_io.IDRC_MAGIC, "both": b"\x89PNG"}
    assert got[:4] == want[overflows]
    np.testing.assert_array_equal(codec_io.decode_idmap(got, cond=label), inst)


def _sem_cases():
    label, inst = _label_and_instance(5, derivable=True)
    label2, inst2 = _label_and_instance(6, derivable=False)
    return {"derived": (label, inst), "not derived": (label2, inst2),
            "label only": (label, None), "instance only": (None, inst2),
            "none": (None, None)}


SEM_CASES = _sem_cases()


@pytest.mark.parametrize("name", sorted(SEM_CASES))
def test_sem_side_blobs_and_derived_label_match_jax(name):
    label, inst = SEM_CASES[name]
    got = codec_io.sem_side_blobs(label, inst)
    assert got == jax_io.sem_side_blobs(label, inst)
    assert got[2] == (name == "derived")
    if inst is not None:
        np.testing.assert_array_equal(codec_io.derive_label_from_instance(inst),
                                      jax_io.derive_label_from_instance(inst))
        if name == "derived":
            np.testing.assert_array_equal(codec_io.derive_label_from_instance(inst), label)


def _codes(kind: str):
    """No code; random codes (the per-channel coder wins: v1 / v2); or
    spatially correlated ones (the spatial coder wins: v3)."""
    rng = np.random.default_rng(7)
    shapes = [(16, 32, 16), (16, 32, 8)]
    if kind == "none":
        return []
    out = []
    for h, w, c in shapes:
        x = rng.normal(size=(h, w, c))
        if kind == "v3":
            for _ in range(2):
                x = 0.25 * (np.roll(x, 1, 0) + np.roll(x, -1, 0) + np.roll(x, 1, 1)
                            + np.roll(x, -1, 1))
        out.append((x > 0).astype(np.float32)[None])
    return out


def _side(name: str):
    label, inst = _label_and_instance(8, derivable=name != "label and instance")
    payloads = [b"\x00\x01 a base stream", bytes(range(200))]
    return {
        "label": dict(label=label),
        "instance": dict(instance=inst),
        "label and instance": dict(label=label, instance=inst),
        "derived label": dict(label=label, instance=inst),
        "base": dict(base_ext="heif", base_payloads=payloads),
        "all": dict(label=label, instance=inst, base_ext="jpg", base_payloads=payloads[:1]),
    }[name]


SIDES = ["label", "instance", "label and instance", "derived label", "base", "all"]


def _assert_same_stream(a, b):
    assert a.image_hw == b.image_hw and len(a.codes) == len(b.codes)
    for x, y in zip(a.codes, b.codes):
        np.testing.assert_array_equal(x, y)
    for key in ("label", "instance"):
        x, y = getattr(a.side, key), getattr(b.side, key)
        assert (x is None) == (y is None), key
        if x is not None:
            np.testing.assert_array_equal(x, y)
    assert a.side.base_ext == b.side.base_ext
    assert a.side.base_payloads == b.side.base_payloads


@pytest.mark.parametrize("codes", ["none", "v1", "v3"])
@pytest.mark.parametrize("side", SIDES)
def test_pack_with_side_info_is_byte_identical_and_cross_decodes(side, codes):
    c = _codes(codes)
    got = codec_io.pack(c, (H, W), codec_io.SideInfo(**_side(side)))
    want = jax_io.pack(c, (H, W), jax_io.SideInfo(**_side(side)))
    assert got == want
    assert got[4] == (3 if codes == "v3" else 2)
    if codes == "none":
        assert struct.unpack_from("<BI", got, 9) == (0, 0)  # no shape, a payload of 0 bytes
    mine, theirs = codec_io.unpack_full(want), jax_io.unpack_full(got)
    _assert_same_stream(mine, theirs)
    info = _side(side)
    for key in ("label", "instance"):
        if key in info:
            np.testing.assert_array_equal(getattr(mine.side, key), info[key])
    if side == "derived label":
        assert got[got.index(b"IDR") - 5] & 8  # the flags byte: label derived


def test_pack_without_codes_or_side_info_and_v3_of_empty_side():
    """No code and no side info packs a v1 stream of no payload, as JAX's;
    an empty SideInfo is no side info."""
    for side in (None, codec_io.SideInfo()):
        got = codec_io.pack([], (H, W), side)
        assert got == jax_io.pack([], (H, W), None if side is None else jax_io.SideInfo())
        assert got[4] == 1
    c = _codes("v3")
    assert codec_io.pack(c, (H, W), codec_io.SideInfo()) == jax_io.pack(c, (H, W))


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_sem_downsample_maps_come_back_as_jax_rebuilds_them(factor):
    """Maps shipped small (an image size no factor divides) come back to
    full size in both packages exactly as JAX's nearest upsample gives."""
    hw = (60, 100)
    label, inst = (m[: hw[0], : hw[1]] for m in _label_and_instance(9, derivable=False))
    small = [codec_io.downsample_ids(m, factor) for m in (label, inst)]
    for s, m in zip(small, (label, inst)):
        np.testing.assert_array_equal(s, jax_io.downsample_ids(m, factor))
        np.testing.assert_array_equal(codec_io.upsample_ids(s, factor, hw),
                                      jax_io.upsample_ids(s, factor, hw))
    stream = codec_io.pack([], hw, codec_io.SideInfo(label=small[0], instance=small[1]))
    assert stream == jax_io.pack([], hw, jax_io.SideInfo(label=small[0], instance=small[1]))
    mine, theirs = codec_io.unpack_full(stream), jax_io.unpack_full(stream)
    _assert_same_stream(mine, theirs)
    for got, s in zip((mine.side.label, mine.side.instance), small):
        assert got.shape == hw
        np.testing.assert_array_equal(got, jax_io.upsample_ids(s, factor, hw))


def _malformed(kind: str) -> bytes:
    label, inst = _label_and_instance(10, derivable=False)
    if kind == "derived flag without instance":
        good = jax_io.pack([], (H, W), jax_io.SideInfo(label=label))
        flags_at = 14  # magic 4, version + size 5, n_codes 1, payload length 4
        return good[:flags_at] + bytes([good[flags_at] | 8]) + good[flags_at + 1:]
    if kind == "truncated section":
        return jax_io.pack([], (H, W), jax_io.SideInfo(label=label, instance=inst))[:-5]
    small = label[::3, :40]  # no integer factor of 64x128 gives 22x40
    return jax_io.pack([], (H, W), jax_io.SideInfo(label=small))


@pytest.mark.parametrize("kind", ["derived flag without instance", "truncated section",
                                  "not an integer factor"])
def test_malformed_side_info_raises_as_jax(kind):
    stream = _malformed(kind)
    with pytest.raises(ValueError) as want:
        jax_io.unpack_full(stream)
    with pytest.raises(ValueError) as got:
        codec_io.unpack_full(stream)
    assert str(got.value) == str(want.value)


def test_idrx_without_its_cond_raises_as_jax():
    arr, cond, _ = IDMAP_CASES["instance given the label"]
    blob = jax_io.encode_idmap(arr, cond=cond)
    with pytest.raises(ValueError, match="needs its cond map"):
        codec_io.decode_idmap(blob)
    with pytest.raises(ValueError, match="uint16 range"):
        codec_io.encode_idmap_png(np.full((2, 2), -1, np.int32))
