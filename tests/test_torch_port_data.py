"""The port's data pipeline (jpdse_tpu_torch.data, .utils) against the JAX
package's, on the CPU: every preprocess mode's transform byte-equal on
random images, each dataset class over a synthetic tree written under
tmp_path giving batches equal to JAX's ``create_dataloader`` (shuffled
training order from the same seed, crops and flips, ``max_dataset_size``,
``cache_images``), and the helpers (colors, gallery, statistics) equal.

Both packages decode and resample with PIL (the card's machine has it), so
there is no image-I/O module of the port's own to hold against PIL."""

import io
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from jpdse_tpu import cli as jax_cli
from jpdse_tpu import config as jax_config
from jpdse_tpu import data as jax_data
from jpdse_tpu.data import stats as jax_stats
from jpdse_tpu.data import transforms as jax_tf
from jpdse_tpu.utils import colormap as jax_colormap
from jpdse_tpu.utils import misc as jax_misc
from jpdse_tpu.utils import visualizer as jax_vis
from jpdse_tpu_torch import cli, config, data
from jpdse_tpu_torch.data import stats, transforms
from jpdse_tpu_torch.data.folder import is_image_file, make_dataset
from jpdse_tpu_torch.utils import colormap, misc, visualizer

REPO = Path(__file__).resolve().parents[1]
REAL_IMAGES = sorted((REPO / "artifacts/flagship_r3/eval_phase3/test_visualizations/images/image")
                     .glob("*.png"))[:2]


def _pp(mode, load=96, crop=64, aspect=2.0):
    return (config.PreprocessConfig(mode, load, crop, aspect),
            jax_config.PreprocessConfig(mode, load, crop, aspect))


@pytest.mark.parametrize("size", [(173, 97), (64, 130)])
@pytest.mark.parametrize("mode", config.PreprocessConfig.VALID_MODES)
def test_apply_transform_byte_equal(mode, size):
    rng = np.random.default_rng([sum(map(ord, mode)), *size])
    w, h = size
    pp, jpp = _pp(mode)
    images = {
        Image.BICUBIC: Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)),
        Image.NEAREST: Image.fromarray(rng.integers(0, 35, (h, w), dtype=np.uint8)),
    }
    for seed in range(3):
        params = transforms.sample_params(pp, (w, h), np.random.default_rng(seed), False)
        want_params = jax_tf.sample_params(jpp, (w, h), np.random.default_rng(seed), False)
        assert params == want_params
        for method, img in images.items():
            for is_train in (True, False):
                got = transforms.apply_transform(img, pp, params, method, is_train)
                want = jax_tf.apply_transform(img, jpp, want_params, method, is_train)
                assert got.size == want.size and got.mode == want.mode
                assert np.array_equal(np.asarray(got), np.asarray(want))


def test_pixel_conversions_equal():
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8))
    mean, std = (0.5, 0.4, 0.3), (1.0, 0.5, 0.25)
    got = transforms.image_to_normalized(img, mean, std)
    assert np.array_equal(got, jax_tf.image_to_normalized(img, mean, std))
    assert np.array_equal(np.asarray(transforms.denormalize_to_pil(got, mean, std)),
                          np.asarray(jax_tf.denormalize_to_pil(got, mean, std)))
    assert np.array_equal(misc.tensor2im(got, mean, std), jax_misc.tensor2im(got, mean, std))
    label = Image.fromarray(np.array([[0, 255, 7], [255, 3, 1]], np.uint8))
    assert np.array_equal(transforms.label_to_array(label, 35), jax_tf.label_to_array(label, 35))
    assert transforms.label_to_array(label, 35)[0, 1] == 35
    inst = Image.fromarray(np.array([[26001, 7], [0, 33000]], np.int32))
    assert np.array_equal(transforms.instance_to_array(inst), jax_tf.instance_to_array(inst))


def test_natural_sort_and_folder():
    names = ["a10.png", "a2.png", "a1.png", "b.txt", "A3.jpg"]
    assert misc.natural_sort(list(names)) == jax_misc.natural_sort(list(names))
    assert [is_image_file(n) for n in names] == [True, True, True, False, True]
    with pytest.raises(ValueError, match="not a valid directory"):
        make_dataset("/nonexistent/dir")


def _png(path: Path, arr: np.ndarray):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _cityscapes(root: Path, rng, n=5, split="train"):
    for i in range(n):
        city = "aachen" if i % 2 else "bremen"
        name = f"{city}_{i:06d}_000019"
        _png(root / "leftImg8bit" / split / city / f"{name}_leftImg8bit.png",
             rng.integers(0, 256, (48, 100, 3), dtype=np.uint8))
        _png(root / "gtFine" / split / city / f"{name}_gtFine_labelIds.png",
             rng.choice(np.array([0, 7, 26, 255], np.uint8), (48, 100)))
        _png(root / "gtFine" / split / city / f"{name}_gtFine_instanceIds.png",
             rng.integers(0, 4, (48, 100), dtype=np.uint8))


def _ade20k(root: Path, rng, n=4, split=None):
    for i in range(n):
        name = f"ADE_train_{i:08d}"
        d = root / "training" / "a" / "abbey"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)).save(
            d / f"{name}.jpg", quality=90)
        seg = np.zeros((50, 70, 3), np.uint8)
        seg[..., 0] = rng.integers(0, 151, (50, 70))
        seg[..., 2] = rng.integers(0, 5, (50, 70))
        _png(d / f"{name}_seg.png", seg)


def _clic(root: Path, rng, n=4, split="train"):
    for i in range(n):
        name = f"img{i}"
        _png(root / split / "img" / f"{name}.png",
             rng.integers(0, 256, (40, 60, 3), dtype=np.uint8))
        _png(root / split / "sem" / f"{name}_sem_map.png",
             rng.integers(0, 54, (40, 60), dtype=np.uint8))
        _png(root / split / "sem" / f"{name}_ins_map.png",
             rng.integers(0, 9, (40, 60), dtype=np.uint8))


def _custom(root: Path, rng, n=4, split="train"):
    for i in range(n):
        _png(root / split / f"p{i}.png", rng.integers(0, 256, (36, 80, 3), dtype=np.uint8))


TREES = {"cityscapes": _cityscapes, "ade20k": _ade20k, "clic": _clic, "custom": _custom}
# (is_train, preprocess mode, cache_images, max_dataset_size)
RUNS = {
    "train crop": (True, "scale_width_and_crop", False, 2**62),
    "train resize and crop, capped": (True, "resize_and_crop", False, 3),
    "train fixed, cached": (True, "fixed", True, 2**62),
    "eval fixed": (False, "fixed", False, 2**62),
    "eval none, cached": (False, "none", True, 2),
}


def _configs(dataset: str, root: Path, run):
    is_train, mode, cache, n = run
    argv = ["--dataset", dataset, "--root_dir", str(root), "--preprocess_mode", mode,
            "--load_size", "72", "--crop_size", "48", "--batch_size", "2", "--seed", "5",
            "--num_workers", "2", "--max_dataset_size", str(n), "--cache_images", str(cache)]
    if dataset == "ade20k":
        argv += ["--mode", "train"]
    return cli.parse_config(list(argv), is_train), jax_cli.parse_config(list(argv), is_train)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["path"] == w["path"]
        for k in g:
            if k != "path":
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("dataset", sorted(TREES))
def test_loader_batches_equal_jax(dataset, run, tmp_path):
    is_train = RUNS[run][0]
    if dataset == "ade20k":
        _ade20k(tmp_path, np.random.default_rng(7))  # read as --mode train
    else:
        TREES[dataset](tmp_path, np.random.default_rng(7), split="train" if is_train else "test")
    cfg, jcfg = _configs(dataset, tmp_path, RUNS[run])
    with redirect_stdout(io.StringIO()):
        loader, jloader = data.create_dataloader(cfg), jax_data.create_dataloader(jcfg)
    assert len(loader) == len(jloader) and len(loader.dataset) == len(jloader.dataset)
    for _epoch in range(2):  # a second epoch reshuffles from (seed, epoch)
        _assert_batches_equal(list(loader), list(jloader))
    if cfg.is_train:
        assert loader.epoch == 2


def test_loader_stops_its_producer_and_forwards_errors(tmp_path):
    _cityscapes(tmp_path, np.random.default_rng(2), n=6)
    cfg, _ = _configs("cityscapes", tmp_path, RUNS["train crop"])
    cfg.data.batch_size = 1
    with redirect_stdout(io.StringIO()):
        loader = data.create_dataloader(cfg)
    it = iter(loader)
    next(it)
    it.close()  # the producer thread is drained and ends
    loader.dataset.image_paths[0] = str(tmp_path / "missing.png")
    loader.dataset.paths_match = lambda a, b: True
    with pytest.raises(FileNotFoundError):
        list(loader)


def test_pairing_check_and_not_ported(tmp_path):
    _cityscapes(tmp_path, np.random.default_rng(3), n=2)
    (tmp_path / "gtFine/train/aachen/aachen_000001_000019_gtFine_labelIds.png").rename(
        tmp_path / "gtFine/train/aachen/aachen_000009_000019_gtFine_labelIds.png")
    cfg, _ = _configs("cityscapes", tmp_path, RUNS["train crop"])
    with pytest.raises(ValueError, match="do not look paired"):
        data.create_dataloader(cfg)
    cfg.codec.use_compressed = True
    with pytest.raises(config.NotPorted, match="item 5"):
        data.create_dataloader(cfg)
    with pytest.raises(KeyError, match="coco"):
        data.find_dataset_using_name("coco")


def test_colormaps_equal():
    for n in (35, 37, 182, 12):
        assert np.array_equal(colormap.label_colormap(n), jax_colormap.label_colormap(n))
    ids = np.random.default_rng(0).integers(0, 40, (5, 6))
    assert np.array_equal(colormap.colorize_labels(ids, 37), jax_colormap.colorize_labels(ids, 37))


def test_gallery_writes_the_same_files(tmp_path):
    cfg = config.Config()
    rng = np.random.default_rng(5)
    visuals = {"label": rng.integers(0, 35, (8, 12)).astype(np.float32),
               "image": rng.normal(size=(8, 12, 3)).astype(np.float32),
               "reconstructed_image": rng.normal(size=(8, 12, 3)).astype(np.float32)}
    for pkg, root in ((visualizer, tmp_path / "port"), (jax_vis, tmp_path / "jax")):
        gallery = pkg.HTMLGallery(str(root), "visualizations")
        pkg.Visualizer(cfg).save_images(gallery, visuals, "/x/aachen_0_leftImg8bit.png")
        gallery.save()
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.png"))
    assert len(files) == 3
    for f in files:
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / f)),
                              np.asarray(Image.open(tmp_path / "jax" / f)))
    assert "reconstructed_image" in (tmp_path / "port/index.html").read_text()


def test_dataset_statistics_equal(tmp_path):
    paths = [str(p) for p in REAL_IMAGES]
    assert len(paths) == 2
    for a, b in zip(stats.get_mean_and_std_from_paths(paths),
                    jax_stats.get_mean_and_std_from_paths(paths)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="no images"):
        stats.get_mean_and_std_from_paths([])
