"""The port's re-packer (``jpdse_tpu_torch/repack.py``) against the JAX
package's ``tools/repack_jpds.py`` on every ``.jpds`` stream the JAX
package wrote from trained models (``artifacts/*/bits_*``, 96 files): the
port's ``unpack_full`` gives JAX's codes, id maps and base-codec payloads,
the port's re-pack is byte-identical to JAX's, and both ``repack_dir``
give the same row. The streams are not in every copy of the repository
(the card's copy leaves ``artifacts/`` out): there these tests skip."""

import glob
import importlib.util
import io
import json
import shutil
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from jpdse_tpu import codec_io as jax_io
from jpdse_tpu_torch import codec_io, repack
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
DIRS = sorted(glob.glob(str(REPO / "artifacts" / "*" / "bits_*")))
STREAMS = sorted(glob.glob(str(REPO / "artifacts" / "*" / "bits_*" / "*.jpds")))
needs_streams = pytest.mark.skipif(not STREAMS, reason="artifacts/ holds no .jpds streams here")


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("repack_jpds", REPO / "tools" / "repack_jpds.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repack_jpds"] = mod
    spec.loader.exec_module(mod)
    return mod


def _repacked(io_mod, data: bytes):
    bs = io_mod.unpack_full(data)
    return bs, io_mod.pack([c[0] for c in bs.codes], bs.image_hw,
                           None if bs.side.empty() else bs.side)


@needs_streams
def test_every_committed_stream_unpacks_and_repacks_as_jax():
    assert len(STREAMS) == 96
    kinds = set()
    for f in STREAMS:
        data = Path(f).read_bytes()
        want, want_new = _repacked(jax_io, data)
        got, got_new = _repacked(codec_io, data)
        assert got.image_hw == want.image_hw, f
        assert len(got.codes) == len(want.codes), f
        for a, b in zip(got.codes, want.codes):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        for k in ("label", "instance"):
            a, b = getattr(got.side, k), getattr(want.side, k)
            assert (a is None) == (b is None), (f, k)
            if a is not None:
                assert np.array_equal(a, b), (f, k)
        assert got.side.base_ext == want.side.base_ext, f
        assert got.side.base_payloads == want.side.base_payloads, f
        assert got_new == want_new, f
        kinds.add((len(got.codes), got.side.label is not None, bool(got.side.base_payloads)))
    # code-only streams and side-info streams (id maps, base payloads) among them
    assert len(kinds) >= 2, kinds


@needs_streams
def test_repack_dir_row_equals_jax(jax_tool):
    for d in DIRS:
        want = jax_tool.repack_dir(d, write=False)
        got = repack.repack_dir(d, write=False)
        assert got == want, d


@needs_streams
def test_write_replaces_only_shorter_streams_and_the_summary(jax_tool, tmp_path):
    d = sorted(DIRS, key=lambda p: len(glob.glob(p + "/*.jpds")))[0]
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(d, ours)
    shutil.copytree(d, theirs)
    summary = {"avg_bpp": 1.0, "total_bytes": 1, "n": 3}
    for p in (ours, theirs):
        (p / "compress_summary.json").write_text(json.dumps(summary))
    with redirect_stdout(io.StringIO()):
        rows = repack.main([str(ours), "--write"], device="cpu")
    want = jax_tool.repack_dir(str(theirs), write=True)
    assert rows[0]["new_bytes"] == want["new_bytes"]
    for a, b in zip(sorted(ours.glob("*.jpds")), sorted(theirs.glob("*.jpds"))):
        assert a.read_bytes() == b.read_bytes()
    assert (json.loads((ours / "compress_summary.json").read_text())
            == json.loads((theirs / "compress_summary.json").read_text()))


def test_repack_dir_round_trips_a_side_info_stream(tmp_path):
    """Without the committed streams too: a stream with both id maps and a
    base payload, written by JAX's pack, re-packs in the port as in JAX."""
    rng = np.random.default_rng(5)
    side = jax_io.SideInfo(label=rng.integers(0, 4, (32, 64)).astype(np.int32),
                           instance=rng.integers(0, 3, (32, 64)).astype(np.int32),
                           base_ext="jpg", base_payloads=[b"\xff\xd8 payload"])
    code = (rng.random((2, 4, 8)) < 0.3).astype(np.float32)
    (tmp_path / "a.jpds").write_bytes(jax_io.pack([code], (32, 64), side))
    (tmp_path / "b.jpds").write_bytes(jax_io.pack([code], (32, 64)))
    row = repack.repack_dir(str(tmp_path), write=False)
    assert row["files"] == 2 and row["old_bytes"] == row["new_bytes"]
    for f in ("a.jpds", "b.jpds"):
        data = (tmp_path / f).read_bytes()
        assert _repacked(codec_io, data)[1] == _repacked(jax_io, data)[1] == data
