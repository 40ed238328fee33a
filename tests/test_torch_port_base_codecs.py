"""The base-codec bridge of the PyTorch port (``jpdse_tpu_torch.codecs``)
against the JAX package's (``jpdse_tpu.codecs.bridge``) on the CPU: each
codec's stream byte-identical (jpg, webp, j2k, avif and heif, the last
through the port's own in-process HEVC codec), the decoded images equal,
``compress_for_model`` at one and at two qualities, ``normalize_decoded``,
the bpg fallback to heif with its quality map, and ``CodecUnavailable``
where JAX raises it. Images are made from a seed with numpy."""

import numpy as np
import pytest
from PIL import features

from jpdse_tpu.codecs import bridge as jax_bridge
from jpdse_tpu_torch import native
from jpdse_tpu_torch.codecs import bridge
from test_torch_port_threads import port_test_threads  # noqa: F401

MEAN, STD = (0.5, 0.5, 0.5), (1.0, 0.5, 0.25)


def _image(h=48, w=80, seed=0):
    """A smooth image with noise, as photographs are: codecs have work to do."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 / w, y * 255 / h, (x + y) * 127 / (h + w)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _need(ext):
    if ext == "avif" and not features.check("avif"):
        pytest.skip("this Pillow has no AVIF")
    if ext == "heif" and not native.heif_available():
        pytest.skip("libheif with its HEVC plugins does not load here (heif_available() "
                    "is False)")


EXTS = [("jpg", 60), ("webp", 50), ("j2k", 40), ("avif", 50), ("heif", 30)]


@pytest.mark.parametrize("ext,q", EXTS, ids=[e for e, _ in EXTS])
def test_encode_and_decode_bytes_match_jax(ext, q):
    _need(ext)
    img = _image()
    got = bridge.encode_bytes(img, ext, q)
    assert got == jax_bridge.encode_bytes(img, ext, q)
    assert got[1] == ext and len(got[0]) > 0
    dec = bridge.decode_bytes(got[0], ext)
    assert dec.dtype == np.uint8 and dec.shape == img.shape
    np.testing.assert_array_equal(dec, jax_bridge.decode_bytes(got[0], ext))
    pil_img, n = bridge.encode_decode(img, ext, q)
    want_img, want_n = jax_bridge.encode_decode(img, ext, q)
    assert n == want_n == len(got[0])
    np.testing.assert_array_equal(np.asarray(pil_img), np.asarray(want_img))


@pytest.mark.parametrize("qualities", [[30], [20, 70]], ids=["one", "two"])
@pytest.mark.parametrize("ext", ["jpg", "heif"])
def test_compress_for_model_matches_jax(ext, qualities):
    _need(ext)
    img = _image(seed=1)
    got = bridge.compress_for_model(img, ext, qualities, MEAN, STD, return_streams=True)
    want = jax_bridge.compress_for_model(img, ext, qualities, MEAN, STD, return_streams=True)
    assert got[0].dtype == np.float32 and got[0].shape == img.shape[:2] + (3 * len(qualities),)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[1] == sum(len(s) for s in got[2])
    short = bridge.compress_for_model(img, ext, qualities, MEAN, STD)
    assert len(short) == 2
    np.testing.assert_array_equal(short[0], got[0])
    rgb = bridge.decode_bytes(got[2][0], got[3])
    np.testing.assert_array_equal(bridge.normalize_decoded(rgb, MEAN, STD),
                                  jax_bridge.normalize_decoded(rgb, MEAN, STD))
    np.testing.assert_array_equal(got[0][..., :3], bridge.normalize_decoded(rgb, MEAN, STD))


def test_batch_encode_decode_matches_jax():
    imgs = [_image(seed=s) for s in range(3)]
    got = bridge.batch_encode_decode(imgs, "jpg", 40)
    want = jax_bridge.batch_encode_decode(imgs, "jpg", 40)
    assert [n for _, n in got] == [n for _, n in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _no_bpg_binaries(monkeypatch):
    for mod in (bridge, jax_bridge):
        monkeypatch.setattr(mod, "_BPG_ENC", None)
        monkeypatch.setattr(mod, "_BPG_DEC", None)


@pytest.mark.parametrize("q_bpg", [20, 33])
def test_bpg_without_binaries_falls_back_to_heif_as_jax(q_bpg, monkeypatch, capsys):
    _need("heif")
    _no_bpg_binaries(monkeypatch)
    monkeypatch.setattr(bridge, "_bpg_fallback_noted", False)
    monkeypatch.setattr(jax_bridge, "_bpg_fallback_warned", True)  # count the port's note
    img = _image(seed=2)
    got = bridge.encode_bytes(img, "bpg", q_bpg)
    assert got == jax_bridge.encode_bytes(img, "bpg", q_bpg)
    assert got == bridge.encode_bytes(img, "heif", 100 - 2 * q_bpg)
    assert got[1] == "heif"
    bridge.encode_bytes(img, "bpg", q_bpg)
    assert capsys.readouterr().out.count("q_heif = 100 - 2*q_bpg") == 1  # noted once


def test_codec_unavailable_where_jax_raises_it(monkeypatch):
    """Without the HEVC codec heif and bpg raise CodecUnavailable in both
    packages, and the codecs on offer agree with and without it."""
    _no_bpg_binaries(monkeypatch)
    assert bridge.available_codecs() == jax_bridge.available_codecs()
    for mod in (bridge, jax_bridge):
        monkeypatch.setattr(mod, "_heif_ok", lambda: False)
    assert bridge.available_codecs() == jax_bridge.available_codecs()
    assert "heif" not in bridge.available_codecs() and "bpg" not in bridge.available_codecs()
    img = _image()
    for ext in ("heif", "bpg"):
        with pytest.raises(jax_bridge.CodecUnavailable):
            jax_bridge.encode_bytes(img, ext, 30)
        with pytest.raises(bridge.CodecUnavailable):
            bridge.encode_bytes(img, ext, 30)
    with pytest.raises(bridge.CodecUnavailable, match="bpgdec"):
        bridge.decode_bytes(b"\x00", "bpg")
    with pytest.raises(ValueError, match="format must be one of"):
        bridge.encode_bytes(img, "png", 30)
    with pytest.raises(ValueError, match="unknown codec"):
        bridge.decode_bytes(b"\x00", "png")
