"""The port's eval and deploy entry points (jpdse_tpu_torch.test, .compress,
.decompress, over .trainer and .eval.harness) against the JAX package's, at
the tiny flagship config in fp32 on the CPU, on a synthetic Cityscapes tree
written under tmp and the opt.json the JAX package writes.

The port's weights are a JAX test-mode Trainer's parameters carried across
by ``from_jax_params`` into ``params_g.pt``. ``evaluate`` gives the JAX
package's actual and coded rates exactly and its Shannon estimate within
1e-6 relative (the two libraries' logs differ in the last bit), the same
``_code`` and ``.rc`` bytes, and L1 / MSE / PSNR / MS-SSIM within 1e-3
relative (the reconstructions agree within 2e-4 before the uint8 floor);
on the fast and the standard path. ``compress`` writes streams byte-identical to JAX's
``Trainer.compress``, and ``decompress`` rebuilds PNGs within one uint8
level of JAX's ``Trainer.decompress``. A JAX checkpoint exported by
``tools/torch_port_export_params.py`` loads with every leaf matched."""

import importlib.util
import io
import json
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from jpdse_tpu import cli as jax_cli
from jpdse_tpu.config import derive_eval_config as jax_derive
from jpdse_tpu.data import create_dataloader as jax_loader
from jpdse_tpu.eval.harness import evaluate as jax_evaluate
from jpdse_tpu.train.checkpoint import save_checkpoint
from jpdse_tpu.trainer import Trainer as JaxTrainer
from jpdse_tpu.utils.misc import tensor2im as jax_tensor2im
from jpdse_tpu_torch import compress, decompress
from jpdse_tpu_torch import test as port_test
from jpdse_tpu_torch.config import NotPorted, flagship_config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.eval.harness import evaluate
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.train.checkpoint import PARAMS_FILE, save_params
from jpdse_tpu_torch.trainer import Trainer

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 128
N_IMAGES = 3
RATES = ("actual_bpp", "coded_bpp", "total_bpp", "n_images")
# the Shannon estimate goes through a log, whose last bit can differ between
# XLA's and PyTorch's: 1e-6 relative
SHANNON_REL = 1e-6
DISTORTION = ("L1", "MSE", "PSNR", "MS-SSIM")


def _write_tree(root: Path, rng):
    for i in range(N_IMAGES):
        name = f"lindau_{i:06d}_000019"
        d, g = root / "leftImg8bit/test/lindau", root / "gtFine/test/lindau"
        d.mkdir(parents=True, exist_ok=True)
        g.mkdir(parents=True, exist_ok=True)
        # twice the eval size, so 'fixed' preprocessing resamples
        Image.fromarray(rng.integers(0, 256, (2 * H, 2 * W, 3), dtype=np.uint8)).save(
            d / f"{name}_leftImg8bit.png")
        Image.fromarray(rng.integers(0, 35, (2 * H, 2 * W), dtype=np.uint8)).save(
            g / f"{name}_gtFine_labelIds.png")
        Image.fromarray(rng.integers(0, 6, (2 * H, 2 * W), dtype=np.uint8)).save(
            g / f"{name}_gtFine_instanceIds.png")


def _jax_run_config(root: Path, run: Path):
    """The tiny flagship as a JAX training run would save it: opt.json."""
    argv = ["--dataset", "cityscapes", "--root_dir", str(root), "--ngf", "8", "--nef", "8",
            "--ne4lf", "8", "--n_downsample_global", "2", "--n_blocks_global", "2",
            "--n_downsample_E", "2", "--n_downsample_E4label", "2",
            "--encoder_binarizer_out_channels", "16",
            "--label_encoder_binarizer_out_channels", "16", "--label_encoder_out_channels", "8",
            "--no_generator_binarization", "--max_instance_id", "128",
            "--test_preprocess_mode", "fixed", "--test_crop_size", str(W),
            "--test_load_size", str(W), "--normalize_std", "1", "--seed", "3",
            "--num_workers", "2", "--save_dir", str(run)]
    cfg = jax_cli.parse_config(argv, is_train=True)
    run.mkdir(parents=True, exist_ok=True)
    cfg.save(str(run / "opt.json"))
    return cfg


def _argv(ctx, out: Path, path: str):
    return ["--load_opt", "--opt_file", str(ctx["run"] / "opt.json"), "--checkpoints_dir",
            str(ctx["run"]), "--save_dir", str(out), "--fast_inference",
            "1" if path == "fast" else "0"]


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """The tree, the run's opt.json, one JAX test-mode Trainer (its fast
    path switched per case) and its parameters as params_g.pt."""
    tmp = tmp_path_factory.mktemp("eval")
    root, run = tmp / "cityscapes", tmp / "run"
    _write_tree(root, np.random.default_rng(21))
    train_cfg = _jax_run_config(root, run)
    cfg = jax_derive(train_cfg, "test")
    with redirect_stdout(io.StringIO()):
        jtrainer = JaxTrainer(cfg, mode="test")
    save_params(str(run), from_jax_params(jtrainer.state.params_g))
    return {"tmp": tmp, "root": root, "run": run, "cfg": cfg, "jtrainer": jtrainer, "jax": {}}


def _jax(ctx, path: str):
    """JAX's evaluate, streams and decodes on ``path``, once per path."""
    if path in ctx["jax"]:
        return ctx["jax"][path]
    cfg, jt = ctx["cfg"], ctx["jtrainer"]
    cfg.model.fast_inference = path == "fast"
    jt._fast_built, jt._fast_codec = False, None
    out = ctx["tmp"] / f"jax_{path}"
    cfg.save_dir = str(out)
    with redirect_stdout(io.StringIO()):
        metrics = jax_evaluate(cfg, jt, jax_loader(cfg))
        streams, images = {}, {}
        for batch in jax_loader(cfg):
            for p, s in zip(batch["path"], jt.compress(batch)):
                name = os.path.splitext(os.path.basename(p))[0]
                streams[name] = s
                images[name] = jax_tensor2im(jt.decompress(s), cfg.data.normalize_mean,
                                             cfg.data.normalize_std)
    ctx["jax"][path] = {"metrics": metrics, "out": out, "streams": streams, "images": images}
    return ctx["jax"][path]


@pytest.mark.parametrize("path", ["fast", "standard"])
def test_test_main_matches_jax_evaluate(ctx, path):
    want = _jax(ctx, path)
    out = ctx["tmp"] / f"port_{path}"
    with redirect_stdout(io.StringIO()) as log:
        got = port_test.main(_argv(ctx, out, path), device="cpu")
    text = log.getvalue()
    assert f"restored params from {ctx['run']}: 46/46 leaves matched" in text
    assert ("fast inference path enabled" in text) == (path == "fast")
    assert json.loads((out / "metrics.json").read_text()) == got
    for k in RATES:
        assert got[k] == want["metrics"][k], k
    assert got["shannon_bpp"] == pytest.approx(want["metrics"]["shannon_bpp"], rel=SHANNON_REL)
    for k in DISTORTION:
        assert got[k] == pytest.approx(want["metrics"][k], rel=1e-3), k
    assert got["n_images"] == N_IMAGES and np.isfinite([got[k] for k in DISTORTION]).all()
    names = sorted(os.listdir(want["out"] / "codes"))
    assert len(names) == 2 * N_IMAGES and sorted(os.listdir(out / "codes")) == names
    for n in names:
        assert (out / "codes" / n).read_bytes() == (want["out"] / "codes" / n).read_bytes(), n
    gallery = out / "test_visualizations"
    assert (gallery / "index.html").exists()
    assert {d.name for d in (gallery / "images").iterdir()} == {
        "label", "image", "reconstructed_image"}
    assert len(list((gallery / "images/reconstructed_image").glob("*.png"))) == N_IMAGES


@pytest.mark.parametrize("path", ["fast", "standard"])
def test_compress_and_decompress_match_jax(ctx, path):
    want = _jax(ctx, path)
    bits, recon = ctx["tmp"] / f"bits_{path}", ctx["tmp"] / f"recon_{path}"
    with redirect_stdout(io.StringIO()):
        summary = compress.main(_argv(ctx, bits, path), device="cpu")
    files = sorted(bits.glob("*.jpds"))
    assert [f.stem for f in files] == sorted(want["streams"])
    for f in files:
        assert f.read_bytes() == want["streams"][f.stem], f.name
    total = sum(len(f.read_bytes()) for f in files)
    assert summary == json.loads((bits / "compress_summary.json").read_text())
    assert summary["avg_bpp"] == total * 8 / (N_IMAGES * H * W)
    with redirect_stdout(io.StringIO()):
        written = decompress.main(["--input", str(bits)] + _argv(ctx, recon, path), device="cpu")
    assert len(written) == N_IMAGES
    for p in written:
        got = np.asarray(Image.open(p)).astype(np.int64)
        assert got.shape == (H, W, 3)
        assert np.abs(got - want["images"][Path(p).stem]).max() <= 1, p
    # one file decodes alone too
    with redirect_stdout(io.StringIO()):
        one = decompress.main(["--input", str(files[0])] + _argv(ctx, recon / "one", path),
                              device="cpu")
    assert np.array_equal(np.asarray(Image.open(one[0])), np.asarray(Image.open(written[0])))


def test_trainer_matches_jax_trainer(ctx):
    """get_code / get_code_and_contexts / get_eval_rate / get_img against
    the JAX Trainer's on one loader batch, on the standard path."""
    _jax(ctx, "standard")  # leaves the JAX trainer on its standard path
    jt = ctx["jtrainer"]
    cfg = ctx["cfg"]
    from jpdse_tpu_torch.config import Config

    pcfg = Config.load(str(ctx["run"] / "opt.json"))
    pcfg.mode, pcfg.is_train, pcfg.checkpoints_dir = "test", False, str(ctx["run"])
    pcfg.data.preprocess = pcfg.data.test_preprocess
    with redirect_stdout(io.StringIO()):
        trainer = Trainer(pcfg, device="cpu")
        trainer.load()
        batch = next(iter(create_dataloader(pcfg)))
        jbatch = next(iter(jax_loader(cfg)))
    assert batch["path"] == jbatch["path"] and np.array_equal(batch["image"], jbatch["image"])
    codes, ctxs, shapes = trainer.get_code_and_contexts(batch)
    jcodes, jctxs, jshapes = jt.get_code_and_contexts(jbatch)
    assert np.array_equal(codes, np.asarray(jcodes).astype(np.uint8))
    assert np.array_equal(ctxs, jctxs) and shapes == [tuple(s) for s in jshapes]
    assert np.array_equal(trainer.get_code(batch), codes)
    (shannon, actual), (jshannon, jactual) = trainer.get_eval_rate(batch), jt.get_eval_rate(jbatch)
    assert actual == jactual and shannon == pytest.approx(jshannon, rel=SHANNON_REL)
    np.testing.assert_allclose(trainer.get_img(batch).numpy(), jt.get_img(jbatch),
                               rtol=0, atol=2e-4)


def test_exported_jax_checkpoint_loads_with_every_leaf(ctx, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_port_export_params", REPO / "tools/torch_port_export_params.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ckpt = tmp_path / "ckpt"
    with redirect_stdout(io.StringIO()):
        save_checkpoint(str(ckpt), ctx["jtrainer"].state, epoch=4)
        (ckpt / "opt.json").write_text((ctx["run"] / "opt.json").read_text())
        tool.main(["--checkpoints_dir", str(ckpt)])
    assert (ckpt / PARAMS_FILE).exists()
    argv = ["--load_opt", "--opt_file", str(ckpt / "opt.json"), "--checkpoints_dir", str(ckpt)]
    from jpdse_tpu_torch.cli import parse_config

    cfg = parse_config(argv, is_train=False)
    with redirect_stdout(io.StringIO()) as log:
        trainer = Trainer(cfg, device="cpu")
        trainer.load()
    assert f"restored params from {ckpt}: 46/46 leaves matched" in log.getvalue()
    want = from_jax_params(ctx["jtrainer"].state.params_g)
    assert all(torch.equal(trainer.state[k], want[k]) for k in want)


def test_partial_restore_and_fast_path_fallback(ctx, tmp_path, monkeypatch):
    """A params_g.pt with a renamed and a reshaped tensor restores the rest
    and still builds the fast path; a fast-path field the fast codec
    rejects falls back to the standard path with a printed reason, as the
    JAX Trainer does."""
    state = torch.load(ctx["run"] / PARAMS_FILE, weights_only=True)
    state["netG.tail.conv.bias"] = torch.zeros(5)
    state["netE.renamed"] = state.pop("netE.head.conv.conv.weight")
    save_params(str(tmp_path), state)
    cfg = flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    cfg.checkpoints_dir = str(tmp_path)
    with redirect_stdout(io.StringIO()) as log:
        trainer = Trainer(cfg, device="cpu")
        trainer.load()
        assert trainer._fast is not None
    assert f"restored params from {tmp_path}: 44/46 leaves matched" in log.getvalue()
    monkeypatch.setenv("JPDSE_HEAD_PALLAS", "2")
    with redirect_stdout(io.StringIO()) as log:
        trainer = Trainer(cfg, device="cpu")
        trainer.load()
        img = trainer.get_img({k: np.zeros((1, H, W) + ((3,) if k == "image" else ()),
                                           np.float32 if k != "instance" else np.int32)
                               for k in ("label", "instance", "image")})
    assert "fast_inference unavailable for this config (ValueError" in log.getvalue()
    assert trainer._fast is None and img.shape == (1, H, W, 3)


def test_trainer_refuses_what_it_cannot_run(tmp_path):
    cfg = flagship_config(tiny=True)
    cfg.optim.fast_train = True  # training runs since the training slice; this option does not
    with pytest.raises(NotImplementedError, match="item 9"):
        Trainer(cfg, mode="train", device="cpu")
    cfg.optim.fast_train = False
    cfg.checkpoints_dir = str(tmp_path)
    trainer = Trainer(cfg, device="cpu")
    with pytest.raises(FileNotFoundError, match=PARAMS_FILE):
        trainer.load()
    # raw semantics: the Trainer runs it; the rate of its side info is item 5
    cfg.model.no_label_encoding = True
    raw = Trainer(cfg, device="cpu")
    with pytest.raises(NotPorted, match="item 5"):
        evaluate(cfg, raw, [{"image": np.zeros((1, 4, 4, 3), np.float32)}])
    bad = flagship_config(tiny=True)
    bad.data.noise_distribution = "poisson"
    bad.data.add_noise = True
    bad.save_dir = str(tmp_path / "out")
    with pytest.raises(NotImplementedError, match="poisson"):
        evaluate(bad, None, [{"image": np.zeros((1, 4, 4, 3), np.float32)}])


def test_kernel_calls_per_evaluated_image(tmp_path, monkeypatch):
    """The kernel calls per image of test.main, compress.main and
    decompress.main that chip_smoke.py asserts on the card (its EVAL_PATHS),
    at the flagship's channel widths (netG's and netE4label's s2d heads
    >= 64 channels, netE's 12), counted on the CPU where each wrapper takes
    its plain version."""
    import chip_smoke
    from jpdse_tpu_torch.models import fast_trunk, layers

    n = 2
    root = tmp_path / "cityscapes"
    rng = np.random.default_rng(9)
    for i in range(n):
        name = f"lindau_{i:06d}_000019"
        d, g = root / "leftImg8bit/val/lindau", root / "gtFine/val/lindau"
        d.mkdir(parents=True, exist_ok=True)
        g.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            d / f"{name}_leftImg8bit.png")
        Image.fromarray(rng.integers(0, 35, (H, W), dtype=np.uint8)).save(
            g / f"{name}_gtFine_labelIds.png")
        Image.fromarray(rng.integers(0, 6, (H, W), dtype=np.uint8)).save(
            g / f"{name}_gtFine_instanceIds.png")
    cfg = flagship_config()
    m = cfg.model
    m.ngf = m.nef = m.ne4lf = 8
    m.encoder_binarizer_out_channels = m.label_encoder_binarizer_out_channels = 8
    m.compute_dtype = "float32"
    cfg.data.root_dir = str(root)
    cfg.data.val_preprocess.preprocess_mode = "fixed"
    cfg.data.val_preprocess.crop_size = W
    run = tmp_path / "run"
    run.mkdir()
    cfg.save(str(run / "opt.json"))
    save_params(str(run), SemanticCodec(cfg, device="cpu", seed=0).state_dict())
    calls = {}
    for module, names in ((fast_trunk, ("s2d_realign_pad3", "s2d_pad3", "head_conv_s2d")),
                          (layers, ("fused_instance_norm",))):
        for name in names:
            calls[name] = 0

            def counted(*a, _fn=getattr(module, name), _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(module, name, counted)
    base = ["--load_opt", "--opt_file", str(run / "opt.json"), "--checkpoints_dir", str(run),
            "--mode", "val"]
    for label, (flags, *wants) in chip_smoke.EVAL_PATHS.items():
        out = tmp_path / label.replace(" ", "_")
        runs = (
            lambda: port_test.main(base + flags + ["--save_dir", str(out / "t")], device="cpu"),
            lambda: compress.main(base + flags + ["--save_dir", str(out / "b")], device="cpu"),
            lambda: decompress.main(["--input", str(out / "b")] + base + flags
                                    + ["--save_dir", str(out / "r")], device="cpu"),
        )
        for entry, want in zip(runs, wants):
            calls.update(dict.fromkeys(calls, 0))
            with redirect_stdout(io.StringIO()):
                entry()
            assert {k: v / n for k, v in calls.items() if v} == want, label
