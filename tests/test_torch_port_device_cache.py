"""The port's device-resident dataset cache (``data/device_cache.py``), the
loader's meta replay and the device prefetch (``data/prefetch.py``) on the
CPU, against the host path and the JAX package's
``jpdse_tpu/data/device_cache.py``, over synthetic Cityscapes trees written
under tmp_path (48x100 PNGs read 'fixed' to 36x72, batch 2, seed 5).

Cached batches must equal the host batches bit for bit over two epochs
(both flips met), also under ``use_compressed`` (the jpg round trip cached
in both flip variants); the declines must be JAX's decisions with JAX's
printed reasons; the compact storage must engage for each modality; the
validation cache must replay the host batches on every pass; the meta
replay must draw JAX's (index, flip) sequence; and the prefetch must hand
over the same batches in order."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from jpdse_tpu import cli as jax_cli
from jpdse_tpu import data as jax_data
from jpdse_tpu.config import derive_eval_config as jax_derive
from jpdse_tpu.data import device_cache as jax_dc
from jpdse_tpu_torch import cli, data
from jpdse_tpu_torch.config import derive_eval_config
from jpdse_tpu_torch.data import device_cache as dc
from jpdse_tpu_torch.data.prefetch import prefetch_to_device
from test_torch_port_data import _ade20k, _cityscapes
from test_torch_port_threads import port_test_threads  # noqa: F401

KEYS = ("image", "label", "instance")


def configs(root, *extra, is_train=True, dataset="cityscapes", mode="fixed"):
    argv = ["--dataset", dataset, "--root_dir", str(root), "--preprocess_mode", mode,
            "--load_size", "72", "--crop_size", "72", "--batch_size", "2", "--seed", "5",
            "--num_workers", "2", "--cache_images", "1"] + list(extra)
    if dataset == "ade20k":
        argv += ["--mode", "train"]
    return cli.parse_config(list(argv), is_train), jax_cli.parse_config(list(argv), is_train)


def quiet(fn):
    with redirect_stdout(io.StringIO()) as out:
        result = fn()
    return result, out.getvalue()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cityscapes")
    _cityscapes(root, np.random.default_rng(7), n=5, split="train")
    _cityscapes(root, np.random.default_rng(8), n=3, split="val")
    return root


def assert_cached_equals_host(cfg, keys, epochs=2):
    """Two epochs of the cached path against the host path: every field
    bit-equal, paths equal, both flips met. Returns the cache."""
    host, meta = quiet(lambda: data.create_dataloader(cfg))[0], \
        quiet(lambda: data.create_dataloader(cfg))[0]
    cache, text = quiet(lambda: dc.maybe_device_cache(meta, cfg, "cpu"))
    assert cache is not None and "resident on device" in text
    meta.meta_only = True
    flips = set()
    for epoch in range(epochs):
        host.set_epoch(epoch)
        meta.set_epoch(epoch)
        pairs = list(zip(host, meta))
        assert len(pairs) == len(host) == 2
        for hb, mb in pairs:
            assert sorted(mb) == ["flip", "index", "path"] and mb["path"] == hb["path"]
            flips.update(bool(f) for f in mb["flip"])
            placed = cache.place(mb)
            for k in keys:
                assert placed[k].dtype == torch.from_numpy(hb[k]).dtype, k
                assert torch.equal(placed[k], torch.from_numpy(hb[k])), (k, epoch)
    assert flips == {True, False}
    return cache


def test_cached_batches_equal_host_batches(tree):
    cfg, _ = configs(tree)
    cache = assert_cached_equals_host(cfg, KEYS)
    # the compaction: the image as bytes and a table, the id maps narrowed
    assert set(cache.luts) == {"image"} and cache.ds["image"].dtype == torch.uint8
    assert cache.ds["label"].dtype == torch.uint8 and cache.out_dtypes["label"] == torch.float32
    assert cache.ds["instance"].dtype == torch.int16  # uint16's bits
    assert cache.out_dtypes["instance"] == torch.int32
    assert cache.nbytes == 5 * 36 * 72 * (3 + 1 + 2)


def test_cached_batches_equal_host_batches_under_use_compressed(tree):
    cfg, _ = configs(tree, "--use_compressed", "--ext", "jpg", "--quality", "60")
    cache = assert_cached_equals_host(cfg, KEYS + ("compressed",))
    assert cache.ds["compressed"].shape[0] == 2 * 5  # both flip variants
    assert "compressed" in cache.luts


def test_meta_replay_draws_jax_index_and_flip_sequence(tree):
    cfg, jcfg = configs(tree)
    loader, jloader = (quiet(lambda: f(c))[0] for f, c in ((data.create_dataloader, cfg),
                                                           (jax_data.create_dataloader, jcfg)))
    loader.meta_only = jloader.meta_only = True
    for epoch in range(3):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        for b, jb in zip(loader, jloader):
            np.testing.assert_array_equal(b["index"], jb["index"])
            np.testing.assert_array_equal(b["flip"], jb["flip"])
            assert b["path"] == jb["path"]


def _decisions(root, case, tmp_path):
    """(port's cache or None, printed text), (JAX's, text) for one case."""
    extra, kwargs, kind = case
    dataset = "ade20k" if kind == "ade20k" else "cityscapes"
    if dataset == "ade20k":
        root = tmp_path / "ade20k"
        _ade20k(root, np.random.default_rng(3))
    mode = "scale_width_and_crop" if kind == "crop" else "fixed"
    cfg, jcfg = configs(root, *extra, dataset=dataset, mode=mode)
    loader = quiet(lambda: data.create_dataloader(cfg))[0]
    jloader = quiet(lambda: jax_data.create_dataloader(jcfg))[0]
    return (quiet(lambda: dc.maybe_device_cache(loader, cfg, "cpu", **kwargs)),
            quiet(lambda: jax_dc.maybe_device_cache(jloader, jcfg, **kwargs)))


DECLINES = {
    "no cache_images": (["--cache_images", "0"], {}, None),
    "device_cache off": (["--device_cache", "0"], {}, None),
    "over the budget": ([], {"max_gb": 1e-6}, None),
    "random crop": ([], {}, "crop"),
    "no meta replay": ([], {}, "ade20k"),
    "cached": ([], {}, None),
}


@pytest.mark.parametrize("case", list(DECLINES))
def test_declines_where_jax_declines_with_its_reason(tree, case, tmp_path):
    (got, text), (want, jtext) = _decisions(tree, DECLINES[case], tmp_path)
    assert (got is None) == (want is None)
    port_lines = [ln for ln in text.splitlines() if "device_cache" in ln]
    jax_lines = [ln for ln in jtext.splitlines() if "device_cache" in ln]
    assert port_lines == jax_lines, (port_lines, jax_lines)
    assert (case == "cached") == (got is not None)
    if case in ("over the budget", "random crop", "no meta replay"):
        assert port_lines and "using host batches" in port_lines[0]


def test_unstackable_samples_decline(tree, monkeypatch):
    cfg, _ = configs(tree)
    loader = quiet(lambda: data.create_dataloader(cfg))[0]

    def boom(self, dataset, cfg, device):
        raise ValueError("all input arrays must have the same shape")

    monkeypatch.setattr(dc.DeviceDatasetCache, "__init__", boom)
    got, text = quiet(lambda: dc.maybe_device_cache(loader, cfg, "cpu"))
    assert got is None and "samples are not stackable" in text


def test_val_cache_replays_the_host_batches(tree):
    cfg, jcfg = configs(tree)
    val_cfg = derive_eval_config(cfg, "val")
    val_loader = quiet(lambda: data.create_dataloader(val_cfg))[0]
    cache, text = quiet(lambda: dc.maybe_val_cache(val_loader, cfg, "cpu", cap=30))
    assert cache is not None and len(cache) == len(val_loader) == 3  # batch 1 in eval
    jval = quiet(lambda: jax_data.create_dataloader(jax_derive(jcfg, "val")))[0]
    _, jtext = quiet(lambda: jax_dc.maybe_val_cache(jval, jcfg, cap=30))
    assert text == jtext
    for _ in range(2):  # replays are stable
        for hb, cb in zip(val_loader, cache):
            assert hb["path"] == cb["path"]
            for k in KEYS:
                assert torch.equal(cb[k], torch.from_numpy(hb[k])), k
    for kwargs in ({"max_gb": 1e-6}, {"cap": 0}):
        got = quiet(lambda: dc.maybe_val_cache(val_loader, cfg, "cpu", **kwargs))
        want = quiet(lambda: jax_dc.maybe_val_cache(jval, jcfg, **kwargs))
        assert (got[0] is None) == (want[0] is None) and got[1] == want[1]


def test_prefetch_hands_over_the_same_batches_in_order(tree):
    cfg, _ = configs(tree)
    loader = quiet(lambda: data.create_dataloader(cfg))[0]
    want = list(loader)
    loader.set_epoch(0)
    got = list(prefetch_to_device(loader, size=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["path"] == w["path"]
        for k in KEYS:
            assert isinstance(g[k], torch.Tensor) and torch.equal(g[k], torch.from_numpy(w[k]))
    # a place_fn is called once per batch, ahead of the consumer by at most size
    calls, seen = [], []

    def place(b):
        calls.append(len(seen))
        return b

    for b in prefetch_to_device([{"i": i} for i in range(5)], size=2, device="cpu",
                                place_fn=place):
        seen.append(b["i"])
    assert seen == list(range(5)) and calls == [0, 0, 0, 1, 2]
