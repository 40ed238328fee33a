"""The PyTorch port stands alone: no JAX and nothing of jpdse_tpu behind
any of its modules or chip_smoke.py, entry points that run on the card
unless told otherwise, and kernels built by nvcc without PyTorch's headers."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jpdse_tpu_torch import compress, decompress, test
from jpdse_tpu_torch.config import flagship_config
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.ops import build
from jpdse_tpu_torch.serve import CodecServer
from jpdse_tpu_torch.train import run
from jpdse_tpu_torch.trainer import Trainer
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jpdse_tpu"] = None
import jpdse_tpu_torch
names = [m.name for m in pkgutil.walk_packages(jpdse_tpu_torch.__path__, "jpdse_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"jpdse_tpu_torch.codec_io", "jpdse_tpu_torch.native"} <= set(names), names
assert {"jpdse_tpu_torch." + m for m in (
    "cli", "trainer", "test", "compress", "decompress", "ops.metrics", "eval.harness",
    "train.checkpoint", "utils.misc", "utils.colormap", "utils.visualizer", "data.transforms",
    "data.folder", "data.paired", "data.cityscapes", "data.ade20k", "data.clic",
    "data.custom", "data.loader", "data.stats", "train.losses", "train.state", "train.step",
    "train.schedule", "train.run", "train.__main__", "models.discriminator", "models.vgg",
    "utils.image_pool", "utils.logging", "ops.semantics", "models.codec", "models.generator",
    "models.fast_codec", "models.fast_trunk", "serve", "codecs", "codecs.bridge",
    "train.warmstart", "models.fast_train", "data.device_cache", "data.prefetch",
    "utils.profiling", "parallel", "parallel.distributed", "parallel.mesh", "convert",
    "convert.torch_import", "convert.torch_ref", "platform")
    } <= set(names), names
from jpdse_tpu_torch import native
from jpdse_tpu_torch.codecs import bridge
from jpdse_tpu_torch.models import fast_trunk, generator
assert {"LocalEnhancer", "LocalDownsample", "LocalUpsample", "Encoder"} <= set(dir(generator))
assert "_FastLocalG" in dir(fast_trunk)
from jpdse_tpu_torch.data import device_cache, prefetch
from jpdse_tpu_torch.models import fast_train
from jpdse_tpu_torch.utils import profiling
assert {"make_fast_train_decode", "fast_train_ineligible_reason"} <= set(dir(fast_train))
assert {"DeviceDatasetCache", "CachedValBatches", "maybe_device_cache",
        "maybe_val_cache"} <= set(dir(device_cache))
assert "prefetch_to_device" in dir(prefetch)
assert {"trace", "StepTimer", "compiled_cost"} <= set(dir(profiling))
assert {"idmap_encode", "idmap_decode", "heif_available", "heif_encode",
        "heif_decode"} <= set(dir(native))
assert {"encode_bytes", "decode_bytes", "compress_for_model", "normalize_decoded",
        "available_codecs", "CodecUnavailable"} <= set(dir(bridge))
from jpdse_tpu_torch.convert import torch_import, torch_ref
from jpdse_tpu_torch.parallel import distributed, mesh
assert {"from_jax_params", "to_jax_params", "deconv_groups"} <= set(dir(
    importlib.import_module("jpdse_tpu_torch.convert")))
assert {"convert_global_generator", "convert_encoder", "convert_multiscale_discriminator",
        "import_reference_checkpoint"} <= set(dir(torch_import))
assert {"RefGlobalGenerator", "RefEncoder", "RefLearnedCodec", "reference_weights_init",
        "phase2_generator_input"} <= set(dir(torch_ref))
assert {"initialize", "rank", "world", "is_main", "barrier", "all_reduce_mean_"} <= set(
    dir(distributed))
assert {"DataMesh", "mesh_from_config", "warn_replicated_once", "draw_rows"} <= set(dir(mesh))
import chip_smoke
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m in ("jax", "jpdse_tpu") or m.startswith(("jax.", "jpdse_tpu.", "flax")))]
assert not loaded, loaded
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60  # every module so far, the fast-train slice's included


def test_entry_points_raise_without_cuda_unless_given_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = flagship_config(tiny=True)
    state = SemanticCodec(cfg, device="cpu", seed=0).state_dict()
    argv = ["--root_dir", "/nonexistent"]
    for make in (lambda: SemanticCodec(cfg), lambda: FastCodec(cfg, state),
                 lambda: CodecServer(cfg, state), lambda: Trainer(cfg),
                 lambda: Trainer(cfg, mode="train"), lambda: run.main(argv),
                 lambda: test.main(argv), lambda: compress.main(argv),
                 lambda: decompress.main(["--input", "/nonexistent"] + argv)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_kernel_sources_use_no_torch_extension_build():
    for path in list((REPO / "jpdse_tpu_torch").rglob("*.py")) + list(
            (REPO / "jpdse_tpu_torch" / "csrc").glob("*.cu")):
        text = path.read_text()
        assert "cpp_extension" not in text and "torch/extension.h" not in text, path


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A compiler that fails (here a stand-in for nvcc) makes the build raise
    with its output and leave no library behind."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: sys.executable)
    monkeypatch.setattr(build, "NVCC_FLAGS", ("-c", "import sys; sys.exit('nvcc said no')"))
    with pytest.raises(RuntimeError, match="(?s)realign.*nvcc said no"):
        build.build_all(["realign"])
    assert not list(tmp_path.glob("*.so*"))


def test_host_libraries_build_with_gxx_into_the_ignored_build_dir():
    """The id-map coder and the HEVC bridge compile from csrc/ with g++ (the
    bridge linking -ldl after its source) into jpdse_tpu_torch/build/,
    which git ignores, named by their sources' hash."""
    ignored = (REPO / ".gitignore").read_text().split()
    assert "jpdse_tpu_torch/build/" in ignored
    for name, tail in (("idmap_coder", []), ("heif_codec", ["-ldl"]), ("range_coder", [])):
        src = build.source_path(name)
        assert src.parent == REPO / "jpdse_tpu_torch" / "csrc" and src.suffix == ".cpp"
        lib = build.library_path(name)
        assert lib.parent == build.BUILD_DIR and lib.name.startswith(f"lib{name}-")
        cmd = build._command(src, lib)
        assert cmd[1:1 + len(build.GXX_FLAGS)] == list(build.GXX_FLAGS)
        assert cmd[-1 - len(tail):] == [str(src)] + tail
