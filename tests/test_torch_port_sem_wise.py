"""Per-class distortion in the port against the JAX package:
``ops/semantics.py::sem_wise_distortion`` against JAX's on its worked
example and on seeded one-hot labels with absent classes (1e-6 relative,
absent classes exactly 0), and the entry point ``eval/sem_wise.py``
against ``tools/sem_wise_eval.py`` on the same synthetic Cityscapes split
and equal weights (JAX's checkpoint, its parameters carried across by
``from_jax_params``), at the tiny widths in fp32 on the CPU, for the
flagship and for a model without semantics (whose loader is made to read
the label maps): class ids and pixel shares equal, each class's L1 within
0.05 of a uint8 level, and the port's JSON within 1e-9 of a float64 numpy
re-scoring of its own reconstructions."""

import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from jpdse_tpu import cli as jax_cli
from jpdse_tpu.config import derive_eval_config as jax_derive
from jpdse_tpu.ops.semantics import sem_wise_distortion as jax_sem_wise
from jpdse_tpu.train.checkpoint import save_checkpoint
from jpdse_tpu.trainer import Trainer as JaxTrainer
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.eval import sem_wise
from jpdse_tpu_torch.ops.semantics import sem_wise_distortion
from jpdse_tpu_torch.train.checkpoint import save_params
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 128
N_IMAGES = 3
PRESENT = (0, 4, 7, 11, 17, 21, 23, 24, 26, 33)  # the classes the split's label maps use
L1_TOL = 0.05  # uint8 levels: the two packages' float images round to uint8 apart
RESCORE_TOL = 1e-9

TINY = ["--dataset", "cityscapes", "--ngf", "8", "--nef", "8", "--ne4lf", "8",
        "--n_downsample_global", "2", "--n_blocks_global", "2", "--n_downsample_E", "2",
        "--n_downsample_E4label", "2", "--encoder_binarizer_out_channels", "16",
        "--label_encoder_binarizer_out_channels", "16", "--label_encoder_out_channels", "8",
        "--no_generator_binarization", "--max_instance_id", "128",
        "--test_preprocess_mode", "fixed", "--test_crop_size", str(W), "--test_load_size",
        str(W), "--normalize_std", "1", "--seed", "3", "--num_workers", "0"]
# the base-codec model without semantics (artifacts/flagship_r4_nosem_q20's): netG
# over the base codec's decoded image alone
NOSEM = ["--no_label", "--no_instance", "--no_label_encoding", "--no_feat_encoding",
         "--use_compressed", "--ext", "jpg", "--quality", "50"]
RECIPES = {"flagship": [], "nosem": NOSEM}


def test_sem_wise_distortion_worked_example():
    """JAX's worked example (tests/test_semantics.py), both label maps."""
    real = np.array([[[[1.0, 3.0], [2.0, 4.0]]]], np.float32)
    fake = np.array([[[[0.0, 9.0], [2.0, 11.0]]]], np.float32)
    for label, want in (([[[[1.0, 0.0], [1.0, 0.0]]]], [7.0, 0.0]),
                        ([[[[1.0, 0.0], [0.0, 1.0]]]], [7.0, 7.0])):
        label = np.array(label, np.float32)
        got = sem_wise_distortion(*(torch.from_numpy(a) for a in (label, real, fake)))
        assert got.tolist() == want
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sem_wise(label, real, fake)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sem_wise_distortion_matches_jax_with_absent_classes(seed):
    rng = np.random.default_rng(seed)
    n_classes = 12
    present = rng.choice(n_classes, 7, replace=False)
    ids = present[rng.integers(0, len(present), (2, 16, 24))]
    label = np.eye(n_classes, dtype=np.float32)[ids]
    real = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    fake = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    got = sem_wise_distortion(*(torch.from_numpy(a) for a in (label, real, fake))).numpy()
    want = np.asarray(jax_sem_wise(jnp.asarray(label), jnp.asarray(real), jnp.asarray(fake)))
    absent = np.setdiff1d(np.arange(n_classes), present)
    assert (got[absent] == 0).all() and (want[absent] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the float64 definition
    diff = np.abs(real.astype(np.float64) - fake).sum(-1)
    exact = np.array([diff[ids == c].mean() if (ids == c).any() else 0.0
                      for c in range(n_classes)])
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=0)


def _write_split(root: Path, rng):
    """N_IMAGES test triplets at twice the eval size, in 8x8 blocks of the
    PRESENT classes, so 'fixed' preprocessing resamples and most ids are
    absent."""
    for i in range(N_IMAGES):
        name = f"lindau_{i:06d}_000019"
        d, g = root / "leftImg8bit/test/lindau", root / "gtFine/test/lindau"
        d.mkdir(parents=True, exist_ok=True)
        g.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (2 * H, 2 * W, 3), dtype=np.uint8)).save(
            d / f"{name}_leftImg8bit.png")
        blocks = np.asarray(PRESENT, np.uint8)[rng.integers(0, len(PRESENT), (H // 4, W // 4))]
        label = np.kron(blocks, np.ones((8, 8), np.uint8))
        Image.fromarray(label).save(g / f"{name}_gtFine_labelIds.png")
        Image.fromarray((label // 3).astype(np.uint8)).save(g / f"{name}_gtFine_instanceIds.png")


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("sem_wise") / "cityscapes"
    _write_split(root, np.random.default_rng(17))
    return root


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("sem_wise_eval",
                                                  REPO / "tools" / "sem_wise_eval.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["sem_wise_eval"] = mod
    spec.loader.exec_module(mod)
    return mod


def _runs(tmp: Path, root: Path, recipe: str):
    """opt.json, JAX's checkpoint of a test-mode Trainer's parameters and
    the same parameters as the port's params_g.pt."""
    cfg = jax_cli.parse_config(TINY + RECIPES[recipe] + ["--root_dir", str(root)],
                               is_train=True)
    jax_run, port_run = tmp / f"jax_{recipe}", tmp / f"port_{recipe}"
    for run in (jax_run, port_run):
        run.mkdir()
        cfg.save(str(run / "opt.json"))
    with redirect_stdout(io.StringIO()):
        jt = JaxTrainer(jax_derive(cfg, "test"), mode="test")
        save_checkpoint(str(jax_run), jt.state, epoch=0)
    save_params(str(port_run), from_jax_params(jt.state.params_g))
    return jax_run, port_run


def _argv(run: Path, root: Path, out: Path):
    return ["--opt_file", str(run / "opt.json"), "--checkpoints_dir", str(run), "--root_dir",
            str(root), "--mode", "test", "--out", str(out)]


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_sem_wise_eval_matches_jax_tool(recipe, split, jax_tool, tmp_path, monkeypatch):
    jax_run, port_run = _runs(tmp_path, split, recipe)
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["sem_wise_eval.py"] + _argv(jax_run, split, jax_out))
    with redirect_stdout(io.StringIO()):
        jax_tool.main()
    recons = []
    with redirect_stdout(io.StringIO()) as log:
        got = sem_wise.main(_argv(port_run, split, port_out), device="cpu", recons=recons)
    assert f"wrote {port_out}" in log.getvalue()
    assert json.loads(port_out.read_text()) == got
    want = json.loads(jax_out.read_text())

    assert got["n_images"] == want["n_images"] == N_IMAGES
    assert [r["class_id"] for r in got["per_class"]] == [r["class_id"] for r in want["per_class"]]
    assert {r["class_id"] for r in got["per_class"]} == set(PRESENT)
    assert [r["name"] for r in got["per_class"]] == [r["name"] for r in want["per_class"]]
    assert ([r["pixel_share"] for r in got["per_class"]]
            == [r["pixel_share"] for r in want["per_class"]])
    for a, b in zip(got["per_class"], want["per_class"]):
        assert abs(a["l1_uint8"] - b["l1_uint8"]) <= L1_TOL, (a, b)
    assert abs(got["overall_l1_uint8"] - want["overall_l1_uint8"]) <= L1_TOL
    # JAX's reconstruction differs from the port's by float rounding only
    assert got["overall_l1_uint8"] > 1.0

    cfg = Config.load(str(port_run / "opt.json")).data
    again = chip_smoke.rescore_sem_wise(recons, cfg.normalize_mean, cfg.normalize_std,
                                        cfg.semantic_nc)
    assert again["n_images"] == got["n_images"]
    assert abs(again["overall_l1_uint8"] - got["overall_l1_uint8"]) <= RESCORE_TOL
    for a, b in zip(again["per_class"], got["per_class"]):
        assert a["class_id"] == b["class_id"] and a["pixel_share"] == b["pixel_share"]
        assert abs(a["l1_uint8"] - b["l1_uint8"]) <= RESCORE_TOL


def test_sem_wise_eval_takes_a_quality_and_raises_without_cuda(split, tmp_path):
    """--quality overrides the base codec's quality of the opt file; the
    default device is the card."""
    _, port_run = _runs(tmp_path, split, "nosem")
    argv = _argv(port_run, split, tmp_path / "q10.json") + ["--quality", "10"]
    with redirect_stdout(io.StringIO()):
        q10 = sem_wise.main(argv, device="cpu")
        q50 = sem_wise.main(argv[:-2], device="cpu")
    assert q10["overall_l1_uint8"] != q50["overall_l1_uint8"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sem_wise.main(argv)
