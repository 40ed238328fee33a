"""The base-codec recipe (``artifacts/flagship_r3_compressed``: raw one-hot
semantics and the base codec's decoded image into netG, no code) through
the port's eval and deploy entry points against the JAX package's, at the
tiny widths in fp32 on the CPU, on a synthetic Cityscapes tree written
under tmp, for a jpg and an heif base codec, on the fast and the standard
path.

``test.main`` reports the id maps' rate (``sem_side_bpp``), the base
codec's (``base_codec_bpp``) and their sum (``total_bpp``) within 1e-6
relative of JAX's ``evaluate``, and its distortion within 1e-3 relative.
``compress.main`` writes side-info-only ``.jpds`` files byte-identical to
JAX's ``Trainer.compress``, each as long as those two rates say plus its
container's bytes, and the port's Trainer compresses a batch of two to
JAX's streams; the port's ``Trainer.decompress`` of JAX's stream is
within 2e-4 of JAX's, and ``decompress.main`` writes PNGs within one
uint8 level of JAX's."""

import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
from PIL import Image

from jpdse_tpu import cli as jax_cli
from jpdse_tpu.config import derive_eval_config as jax_derive
from jpdse_tpu.data import create_dataloader as jax_loader
from jpdse_tpu.eval.harness import evaluate as jax_evaluate
from jpdse_tpu.trainer import Trainer as JaxTrainer
from jpdse_tpu.utils.misc import tensor2im as jax_tensor2im
from jpdse_tpu_torch import compress, decompress, native
from jpdse_tpu_torch import test as port_test
from jpdse_tpu_torch.cli import parse_config
from jpdse_tpu_torch.config import derive_eval_config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.train.checkpoint import save_params
from jpdse_tpu_torch.trainer import Trainer
from test_torch_port_eval import DISTORTION, H, N_IMAGES, W, _write_tree
from test_torch_port_threads import port_test_threads  # noqa: F401

BASE = {"jpg": "50", "heif": "30"}
SIDE_RATES = ("sem_side_bpp", "base_codec_bpp", "total_bpp")
# a side-info-only stream's container: magic 4, version and size 5, no code
# 1, payload length 4, flags 1; an id-map section's length 4; the base
# section's codec name length 1, number of streams 1, a stream's length 4
HEADER = 4 + 5 + 1 + 4 + 1


@pytest.fixture(scope="module", params=sorted(BASE))
def ctx(request, tmp_path_factory):
    """The tree, the recipe's opt.json, one JAX test-mode Trainer and its
    parameters as params_g.pt."""
    ext = request.param
    if ext == "heif" and not native.heif_available():
        pytest.skip("libheif with its HEVC plugins does not load here (heif_available() "
                    "is False)")
    tmp = tmp_path_factory.mktemp(f"eval_{ext}")
    root, run = tmp / "cityscapes", tmp / "run"
    _write_tree(root, np.random.default_rng(31))
    argv = ["--dataset", "cityscapes", "--root_dir", str(root), "--ngf", "8",
            "--n_downsample_global", "2", "--n_blocks_global", "2", "--no_feat_encoding",
            "--no_label_encoding", "--no_generator_binarization", "--use_compressed",
            "--ext", ext, "--quality", BASE[ext], "--max_instance_id", "128",
            "--test_preprocess_mode", "fixed", "--test_crop_size", str(W),
            "--test_load_size", str(W), "--normalize_std", "1", "--seed", "3",
            "--num_workers", "2", "--save_dir", str(run)]
    train_cfg = jax_cli.parse_config(argv, is_train=True)
    run.mkdir(parents=True)
    train_cfg.save(str(run / "opt.json"))
    cfg = jax_derive(train_cfg, "test")
    with redirect_stdout(io.StringIO()):
        jtrainer = JaxTrainer(cfg, mode="test")
    save_params(str(run), from_jax_params(jtrainer.state.params_g))
    return {"tmp": tmp, "run": run, "cfg": cfg, "jtrainer": jtrainer, "jax": {}}


def _argv(ctx, out, path: str):
    return ["--load_opt", "--opt_file", str(ctx["run"] / "opt.json"), "--checkpoints_dir",
            str(ctx["run"]), "--save_dir", str(out), "--fast_inference",
            "1" if path == "fast" else "0"]


def _jax(ctx, path: str):
    if path in ctx["jax"]:
        return ctx["jax"][path]
    cfg, jt = ctx["cfg"], ctx["jtrainer"]
    cfg.model.fast_inference = path == "fast"
    jt._fast_built, jt._fast_codec = False, None
    cfg.save_dir = str(ctx["tmp"] / f"jax_{path}")
    with redirect_stdout(io.StringIO()):
        metrics = jax_evaluate(cfg, jt, jax_loader(cfg))
        streams, images = {}, {}
        for batch in jax_loader(cfg):
            for p, s in zip(batch["path"], jt.compress(batch)):
                name = os.path.splitext(os.path.basename(p))[0]
                streams[name] = s
                images[name] = jt.decompress(s)
    ctx["jax"][path] = {"metrics": metrics, "streams": streams, "images": images}
    return ctx["jax"][path]


@pytest.mark.parametrize("path", ["fast", "standard"])
def test_test_main_reports_jax_side_rates(ctx, path):
    want = _jax(ctx, path)
    out = ctx["tmp"] / f"port_{path}"
    with redirect_stdout(io.StringIO()) as log:
        got = port_test.main(_argv(ctx, out, path), device="cpu")
    assert ("fast inference path enabled" in log.getvalue()) == (path == "fast")
    assert "no binarized module in this configuration" in log.getvalue()
    assert json.loads((out / "metrics.json").read_text()) == got
    for k in SIDE_RATES:
        assert got[k] == pytest.approx(want["metrics"][k], rel=1e-6), k
    assert got["total_bpp"] == pytest.approx(got["sem_side_bpp"] + got["base_codec_bpp"],
                                             rel=1e-12)
    assert got["actual_bpp"] == got["shannon_bpp"] == 0.0 and "coded_bpp" not in got
    for k in DISTORTION:
        assert got[k] == pytest.approx(want["metrics"][k], rel=1e-3), k
    assert got["n_images"] == N_IMAGES


@pytest.mark.parametrize("path", ["fast", "standard"])
def test_side_info_streams_match_jax(ctx, path):
    """compress.main's files are JAX's streams and as long as the rates
    say; decompress of JAX's streams matches JAX's decompress."""
    want = _jax(ctx, path)
    bits, recon = ctx["tmp"] / f"bits_{path}", ctx["tmp"] / f"recon_{path}"
    with redirect_stdout(io.StringIO()):
        summary = compress.main(_argv(ctx, bits, path), device="cpu")
        metrics = port_test.main(_argv(ctx, ctx["tmp"] / f"rates_{path}", path), device="cpu")
    files = sorted(bits.glob("*.jpds"))
    assert [f.stem for f in files] == sorted(want["streams"])
    for f in files:
        assert f.read_bytes() == want["streams"][f.stem], f.name
    total = sum(len(f.read_bytes()) for f in files)
    assert summary["avg_bpp"] == total * 8 / (N_IMAGES * H * W)
    # the id-map section (the label derived from the instance map here, or
    # both maps) and one base stream per image, beside the container
    sections = sum(4 * (1 + (want["streams"][f.stem][14] & 1)) + 1 + len(ctx["cfg"].codec.ext)
                   + 1 + 4 for f in files)
    side_bytes = (metrics["sem_side_bpp"] + metrics["base_codec_bpp"]) * N_IMAGES * H * W / 8
    assert total == pytest.approx(side_bytes + N_IMAGES * HEADER + sections, abs=1e-6)
    cfg = derive_eval_config(parse_config(_argv(ctx, recon, path), is_train=False), mode="test")
    with redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, device="cpu")
        trainer.load()
        for name, stream in want["streams"].items():
            np.testing.assert_allclose(trainer.decompress(stream), want["images"][name],
                                       atol=2e-4)
        # a batch of two through the server and through JAX's Trainer.compress
        cfg.data.batch_size = ctx["cfg"].data.batch_size = 2
        try:
            two, jtwo = next(iter(create_dataloader(cfg))), next(iter(jax_loader(ctx["cfg"])))
        finally:
            ctx["cfg"].data.batch_size = 1
        written = decompress.main(["--input", str(bits)] + _argv(ctx, recon, path),
                                  device="cpu")
    assert two["path"] == jtwo["path"] and two["base_codec_streams"] == jtwo["base_codec_streams"]
    assert trainer.compress(two) == ctx["jtrainer"].compress(jtwo)
    assert len(written) == N_IMAGES
    mean, std = ctx["cfg"].data.normalize_mean, ctx["cfg"].data.normalize_std
    for p in written:
        got = np.asarray(Image.open(p)).astype(np.int64)
        ref = jax_tensor2im(want["images"][os.path.splitext(os.path.basename(p))[0]], mean, std)
        assert np.abs(got - ref).max() <= 1, p
