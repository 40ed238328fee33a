"""The port's R-D tools (``eval/rd.py``) against the JAX package's
``tools/measure_rd.py`` and ``tools/base_codec_rd.py`` on the CPU, on a
synthetic Cityscapes split of 2 images read 'fixed' at crop 64, jpg at
qualities 50 and 90.

``parity``, on the standard path and on the fast path (``--fast``), at
small widths: the bpp equal (the same base-codec bytes); the golden
stack's columns within 1e-5 relative: both tools decode the same seeded
``torch_ref`` generator on the CPU, bit for bit, and the two packages'
metric functions score its uint8 images apart by their float32 sums'
order (PSNR 1.05e-6 relative, MSE half an ulp here);
the port's columns within 0.01 dB PSNR and 1e-4 MS-SSIM of JAX's; the
verdicts equal, and both OK. ``base``: the bytes equal, and PSNR, MS-SSIM
and L1 within 1e-6 relative."""

import importlib.util
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from jpdse_tpu_torch.convert import torch_ref
from jpdse_tpu_torch.eval import rd
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N_IMAGES = 2
CROP = 64
QUALITIES = "50,90"
WIDTHS = ["--ngf", "8", "--n-down", "2", "--n-blocks", "2"]
PSNR_TOL = 0.01  # dB, the port's stack against JAX's
MSSSIM_TOL = 1e-4
# the golden stack's columns: the same uint8 images scored by two metric libraries
# (tests/test_torch_port_metrics.py's tolerance; float32 means summed in other orders)
GOLDEN_REL = 1e-5
# relative: one float32 ulp of a 27 dB PSNR is 1.9e-6 dB, and XLA's and PyTorch's float32
# means differ in the last bit
BASE_REL = 1e-6


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A smooth random photo a triplet (so jpg's rate moves with quality),
    block labels and instance ids, at twice the eval size."""
    root = tmp_path_factory.mktemp("rd") / "cityscapes"
    rng = np.random.default_rng(12)
    for i in range(N_IMAGES):
        name = f"munster_{i:06d}_000019"
        d, g = root / "leftImg8bit/val/munster", root / "gtFine/val/munster"
        d.mkdir(parents=True, exist_ok=True)
        g.mkdir(parents=True, exist_ok=True)
        small = Image.fromarray(rng.integers(0, 256, (8, 16, 3), dtype=np.uint8))
        photo = np.asarray(small.resize((2 * CROP, CROP), Image.BICUBIC)).astype(np.int16)
        photo = np.clip(photo + rng.integers(-6, 7, photo.shape), 0, 255).astype(np.uint8)
        Image.fromarray(photo).save(d / f"{name}_leftImg8bit.png")
        blocks = rng.integers(0, 34, (CROP // 8, CROP // 4))
        Image.fromarray(np.kron(blocks, np.ones((4, 4), np.int64)).astype(np.uint8)).save(
            g / f"{name}_gtFine_labelIds.png")
        inst = np.kron(blocks * 10 + rng.integers(0, 3, blocks.shape), np.ones((4, 4), np.int64))
        Image.fromarray(inst.astype(np.uint16)).save(g / f"{name}_gtFine_instanceIds.png")
    return root


def _parity_argv(root: Path, out: Path, fast: bool):
    return (["--ext", "jpg", "--qualities", QUALITIES, "--n-images", str(N_IMAGES), "--crop",
             str(CROP), "--seed", "0", "--out", str(out), "--root", str(root)] + WIDTHS
            + (["--fast"] if fast else []))


def _run_jax(name, argv, monkeypatch):
    """A JAX tool's main with sys.argv patched; its exit code (measure_rd
    exits 0 where every point passes). measure_rd turns autograd off for
    the process: it is turned back on."""
    tool = _tool(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    code = 0
    try:
        with redirect_stdout(io.StringIO()):
            tool.main()
    except SystemExit as e:
        code = e.code
    finally:
        torch.set_grad_enabled(True)
    return code


def _verdict(p, port=True):
    d_psnr = abs(p["psnr_port" if port else "psnr_jax"] - p["psnr_torch"])
    d_ms = abs(p["msssim_port" if port else "msssim_jax"] - p["msssim_torch"])
    return "OK" if d_psnr <= 0.05 and d_ms <= 0.001 else "FAIL"


@pytest.mark.parametrize("fast", [False, True], ids=["standard", "fast"])
def test_parity_matches_jax_tool(root, tmp_path, monkeypatch, fast):
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    assert _run_jax("measure_rd", _parity_argv(root, jax_out, fast), monkeypatch) == 0
    want = json.loads(jax_out.read_text())["points"]
    with redirect_stdout(io.StringIO()) as log:
        got = rd.main(["parity"] + _parity_argv(root, port_out, fast), device="cpu")
    assert "=== parity summary ===" in log.getvalue()
    assert json.loads(port_out.read_text())["points"] == got["points"]
    assert got["ok"] and len(got["points"]) == len(want) == 2
    bpps = []
    for p, w in zip(got["points"], want):
        assert (p["ext"], p["quality"], p["n_images"]) == (w["ext"], w["quality"], w["n_images"])
        assert p["n_images"] == N_IMAGES
        assert p["bpp"] == w["bpp"]
        bpps.append(p["bpp"])
        for k in ("psnr", "msssim", "l1", "mse"):
            assert abs(p[f"{k}_torch"] - w[f"{k}_torch"]) <= GOLDEN_REL * abs(w[f"{k}_torch"]), k
        assert abs(p["psnr_port"] - w["psnr_jax"]) <= PSNR_TOL
        assert abs(p["msssim_port"] - w["msssim_jax"]) <= MSSSIM_TOL
        assert p["verdict"] == _verdict(w, port=False) == "OK"
        assert p["verdict"] == _verdict(p)
        assert p["ms_port"] > 0 and p["ms_torch"] > 0
    assert bpps[1] > bpps[0]  # q90 costs more than q50


def test_parity_golden_decode_is_torch_ref(root, tmp_path):
    """The golden stack decodes what ``torch_ref.torch_decode`` decodes,
    bit for bit, and the port's preprocessing check raises on a mismatch."""
    args = rd.parse_args(["parity"] + _parity_argv(root, tmp_path / "x.json", False))
    cfg = rd.parity_config(args)
    gen = torch_ref.build_phase2_generator(cfg.data.semantic_nc, 3, 8, 2, 2, seed=0)
    g_in = np.random.default_rng(3).random((32, 64, cfg.data.semantic_nc + 4), np.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(g_in).permute(2, 0, 1)[None].contiguous()).permute(0, 2, 3, 1)
    assert np.array_equal(got[0].numpy(), torch_ref.torch_decode(gen, g_in)[0])


def test_base_matches_jax_tool(root, tmp_path, monkeypatch):
    argv = ["--root", str(root), "--mode", "val", "--ext", "jpg", "--qualities", "30,90",
            "--width", str(CROP), "--height", str(CROP // 2)]
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    assert _run_jax("base_codec_rd", argv + ["--out", str(jax_out)], monkeypatch) in (0, None)
    want = json.loads(jax_out.read_text())
    with redirect_stdout(io.StringIO()):
        got = rd.main(["base"] + argv + ["--out", str(port_out)], device="cpu")
    assert json.loads(port_out.read_text()) == got
    assert got["images"] == want["images"] == N_IMAGES
    for p, w in zip(got["rows"], want["rows"]):
        assert (p["ext"], p["quality"], p["bpp"]) == (w["ext"], w["quality"], w["bpp"])
        for k in ("psnr", "msssim", "l1"):
            assert abs(p[k] - w[k]) <= BASE_REL * abs(w[k]), k
    with pytest.raises(SystemExit, match="no images"):
        rd.main(["base", "--root", str(tmp_path), "--out", str(port_out)], device="cpu")


def test_rd_asks_for_the_card_by_default(root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rd.main(["base", "--root", str(root), "--out", str(tmp_path / "x.json")])
    # --device names the device as main's argument does
    with redirect_stdout(io.StringIO()):
        got = rd.main(["base", "--root", str(root), "--ext", "jpg", "--qualities", "50",
                       "--width", "64", "--height", "32", "--out", str(tmp_path / "y.json"),
                       "--device", "cpu"])
    assert got["images"] == N_IMAGES
