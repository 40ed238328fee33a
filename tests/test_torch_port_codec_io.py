"""The port's .jpds container and range coder (jpdse_tpu_torch/codec_io.py,
jpdse_tpu_torch/native.py, csrc/range_coder.cpp built with g++) against
the JAX package's jpdse_tpu/codec_io.py and jpdse_tpu/native. The coder's
arithmetic is copied unchanged, so every stream must be byte-identical and
every decode equal."""

import struct

import numpy as np
import pytest

from jpdse_tpu import codec_io as jax_io
from jpdse_tpu import native as jax_native
from jpdse_tpu_torch import codec_io, native
from jpdse_tpu_torch.ops import build
from test_torch_port_threads import port_test_threads  # noqa: F401


def _codes(case: str):
    """(codes, image_hw, the version pack must choose) for one case."""
    rng = np.random.default_rng(["tiny", "flagship", "spatial", "bias", "zeros"].index(case))
    if case == "tiny":  # the tiny config's two codes: (64, 128) at 1/4, 16 channels
        return [rng.integers(0, 2, (16, 32, 16)).astype(np.uint8) for _ in range(2)], (64, 128), 1
    if case == "flagship":  # 1024x512 at 1/16, 128 channels each
        return ([rng.integers(0, 2, (32, 64, 128)).astype(np.uint8) for _ in range(2)],
                (512, 1024), 3)
    if case == "spatial":  # 4x4 blocks of equal bits: the spatial contexts win
        low = rng.integers(0, 2, (2, 8, 16, 16)).astype(np.uint8)
        return [np.repeat(np.repeat(c, 4, 0), 4, 1) for c in low], (128, 256), 3
    if case == "bias":  # each channel nearly constant, no spatial structure: v1 wins
        p = rng.choice([0.03, 0.97], size=(2, 16))
        return ([(rng.random((16, 32, 16)) < p[i]).astype(np.uint8) for i in range(2)],
                (64, 128), 1)
    return [np.zeros((16, 32, 16), np.uint8)] * 2, (64, 128), 1


CASES = ["tiny", "flagship", "spatial", "bias", "zeros"]


@pytest.mark.parametrize("case", CASES)
def test_pack_is_byte_identical_to_jax(case):
    codes, hw, version = _codes(case)
    got = codec_io.pack(codes, hw)
    assert got == jax_io.pack(codes, hw)
    assert got[:4] == b"JPDS" and got[4] == version
    # (1, h, w, c) codes pack the same as (h, w, c)
    assert codec_io.pack([c[None] for c in codes], hw) == got


@pytest.mark.parametrize("case", CASES)
def test_each_package_decodes_the_others_stream(case):
    codes, hw, _ = _codes(case)
    for stream, unpack in ((jax_io.pack(codes, hw), codec_io.unpack),
                           (codec_io.pack(codes, hw), jax_io.unpack)):
        got, got_hw = unpack(stream)
        assert got_hw == hw
        assert [g.shape for g in got] == [(1, *c.shape) for c in codes]
        for g, c in zip(got, codes):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g[0], c)


@pytest.mark.parametrize("with_contexts", [False, True])
def test_entropy_coder_matches_jax(with_contexts):
    rng = np.random.default_rng(3)
    bits = (rng.random(20000) < 0.2).astype(np.uint8)
    ctx = rng.integers(0, 37, bits.size).astype(np.int32) if with_contexts else None
    stream = native.entropy_encode(bits, contexts=ctx)
    assert stream == jax_native.entropy_encode(bits, contexts=ctx)
    np.testing.assert_array_equal(native.entropy_decode(stream, bits.size, contexts=ctx), bits)
    np.testing.assert_array_equal(jax_native.entropy_decode(stream, bits.size, contexts=ctx), bits)


def test_spatial_entropy_coder_matches_jax():
    rng = np.random.default_rng(4)
    shapes = [(6, 10, 5), (3, 4, 7)]
    bits = (rng.random(sum(h * w * c for h, w, c in shapes)) < 0.7).astype(np.uint8)
    stream = native.entropy_encode_spatial(bits, shapes)
    assert stream == jax_native.entropy_encode_spatial(bits, shapes)
    np.testing.assert_array_equal(native.entropy_decode_spatial(stream, shapes), bits)
    np.testing.assert_array_equal(jax_native.entropy_decode_spatial(stream, shapes), bits)
    with pytest.raises(ValueError, match="shapes total"):
        native.entropy_encode_spatial(bits[:-1], shapes)


def test_contexts_for_shapes_match_jax():
    shapes = [(2, 3, 4), (1, 2, 5)]
    np.testing.assert_array_equal(codec_io.contexts_for_shapes(shapes),
                                  jax_io.contexts_for_shapes(shapes))
    assert codec_io.contexts_for_shapes([]).size == 0


def _stream():
    codes, hw, _ = _codes("tiny")
    return jax_io.pack(codes, hw)


@pytest.mark.parametrize("corrupt,match", [
    (lambda s: b"JPDX" + s[4:], "bad magic"),
    (lambda s: s[:4] + bytes([9]) + s[5:], "unsupported .jpds version 9"),
    (lambda s: s[:-5], "truncated .jpds: payload"),
    (lambda s: s[:12], "truncated .jpds header"),
])
def test_malformed_streams_raise(corrupt, match):
    with pytest.raises(ValueError, match=match):
        codec_io.unpack(corrupt(_stream()))


def test_unknown_coder_mode_raises():
    codes, hw, _ = _codes("spatial")
    stream = bytearray(jax_io.pack(codes, hw))
    assert stream[4] == 3
    stream[10 + 6 * len(codes)] = 7  # the coder-mode byte after the shape table
    with pytest.raises(ValueError, match="coder mode 7"):
        codec_io.unpack(bytes(stream))


@pytest.mark.parametrize("side", ["label", "instance", "base"])
def test_side_info_streams_raise(side):
    """A stream with side info (JAX's SideInfo) decodes in the port to the
    same codes and side info as in JAX; the same stream cut inside its side
    section raises as JAX's does."""
    codes, hw, _ = _codes("tiny")
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 30, hw).astype(np.int32)
    info = {"label": jax_io.SideInfo(label=ids),
            "instance": jax_io.SideInfo(instance=ids * 1000 + 7),
            "base": jax_io.SideInfo(base_ext="jpg", base_payloads=[b"\xff\xd8 not a jpeg"])}[side]
    stream = jax_io.pack(codes, hw, info)
    want, got = jax_io.unpack_full(stream), codec_io.unpack_full(stream)
    assert got.image_hw == want.image_hw
    for g, w in zip(got.codes, want.codes, strict=True):
        np.testing.assert_array_equal(g, w)
    for key in ("label", "instance"):
        if getattr(want.side, key) is None:
            assert getattr(got.side, key) is None
        else:
            np.testing.assert_array_equal(getattr(got.side, key), getattr(want.side, key))
    assert (got.side.base_ext, got.side.base_payloads) == (want.side.base_ext,
                                                           want.side.base_payloads)
    with pytest.raises(ValueError, match="truncated .jpds side-info section"):
        codec_io.unpack(stream[:-3])


def test_v2_stream_without_side_info_decodes():
    """A version-2 stream whose flags byte is 0 carries codes only."""
    codes, hw, _ = _codes("tiny")
    v1 = jax_io.pack(codes, hw)
    assert v1[4] == 1
    v2 = v1[:4] + bytes([2]) + v1[5:] + struct.pack("<B", 0)
    got, got_hw = codec_io.unpack(v2)
    assert got_hw == hw
    for g, c in zip(got, codes):
        np.testing.assert_array_equal(g[0], c)


def test_pack_takes_one_image_and_at_least_one_code():
    """One image at a time; no code at all packs JAX's stream of a payload
    of 0 bytes (a side-info-only stream carries its side info beside it)."""
    codes, hw, _ = _codes("tiny")
    with pytest.raises(ValueError, match="one image"):
        codec_io.pack([np.stack([codes[0]] * 2)], hw)
    assert codec_io.pack([], hw) == jax_io.pack([], hw)
    assert codec_io.unpack(codec_io.pack([], hw)) == ([], hw)


def test_coder_is_built_by_gxx_into_the_build_dir():
    """The coder's library comes from csrc/range_coder.cpp under the port's
    build directory, named by the hash of its source and headers."""
    native.entropy_encode(np.zeros(8, np.uint8))
    path = build.library_path("range_coder")
    assert path.parent == build.BUILD_DIR and path.exists()
    assert build.source_path("range_coder").suffix == ".cpp"
    assert "range_coder" in build.sources() and "realign" in build.sources()


def test_failed_coder_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A failing g++ (here a stand-in) makes the build raise with its output
    and leaves no library behind: the coder has no fallback."""
    import sys

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "gxx_path", lambda: sys.executable)
    monkeypatch.setattr(build, "GXX_FLAGS", ("-c", "import sys; sys.exit('g++ said no')"))
    with pytest.raises(RuntimeError, match="(?s)range_coder.*g\\+\\+ said no"):
        build.build_all(["range_coder"])
    assert not list(tmp_path.glob("*.so*"))
