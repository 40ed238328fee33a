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
# the batch norm's modules and the quantizers (ROADMAP Queue 1 items 10 and 7)
from jpdse_tpu_torch.models import layers
from jpdse_tpu_torch.ops import quantizers
assert {"Norm", "BatchNorm", "batch_stats", "norm_mode", "norm_context", "replayable", "RUNNING",
        "BATCH", "UPDATE"} <= set(dir(layers))
assert "sum_over_world" in dir(distributed)
assert {"to_jax_mstate", "is_stat"} <= set(dir(importlib.import_module("jpdse_tpu_torch.convert")))
assert {"rounded_identity", "DifferentiableSign", "S2HVQ", "S2HVQV2", "Binarizer"} <= set(
    dir(quantizers))
assert {"jpdse_tpu_torch.models.layers", "jpdse_tpu_torch.ops.quantizers"} <= set(names)
# the spatial axis beyond the standard path (ROADMAP Queue 1 item 13)
from jpdse_tpu_torch.parallel import spatial
assert {"take_rows", "at_least", "like", "pad_w", "gather_rows", "sum_over"} <= set(dir(spatial))
# every H that the axis divides runs sharded: the item-13 raise is gone
config_names = set(dir(importlib.import_module("jpdse_tpu_torch.config")))
assert {"check_fast_shard", "check_fast_parallel"} <= config_names
assert not {"spatial_row_multiple", "check_spatial_rows", "SPATIAL_NOT_PORTED"} & config_names
assert "conv_rows" in dir(layers)
# the measurement entry points (the R-D tools, per-class distortion, the seg-trained VGG,
# the .jpds re-packer)
assert {"jpdse_tpu_torch." + m for m in ("eval.rd", "eval.sem_wise", "train.seg_vgg",
                                         "repack")} <= set(names), names
from jpdse_tpu_torch.eval import rd, sem_wise
from jpdse_tpu_torch.train import seg_vgg
from jpdse_tpu_torch import repack
from jpdse_tpu_torch.ops import semantics
assert "sem_wise_distortion" in dir(semantics)
assert {"main", "parity", "base", "parity_config", "image_metrics"} <= set(dir(rd))
assert {"main", "class_sums", "summarize", "CITYSCAPES_NAMES"} <= set(dir(sem_wise))
assert {"main", "SegVgg", "load_split", "export_trunk", "draw_crops", "gather_crops",
        "seg_loss", "pixel_accuracy"} <= set(dir(seg_vgg))
assert {"main", "repack_dir"} <= set(dir(repack))
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
    assert int(out.stdout.split()[-1]) >= 71  # every module so far, the entry points' slice's included


def test_entry_points_raise_without_cuda_unless_given_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = flagship_config(tiny=True)
    state = SemanticCodec(cfg, device="cpu", seed=0).state_dict()
    argv = ["--root_dir", "/nonexistent"]
    from jpdse_tpu_torch import repack
    from jpdse_tpu_torch.eval import rd, sem_wise
    from jpdse_tpu_torch.train import seg_vgg

    for make in (lambda: sem_wise.main(["--opt_file", "x", "--checkpoints_dir", "y"]),
                 lambda: seg_vgg.main(argv[:0]), lambda: rd.main(["base"]),
                 lambda: rd.main(["parity"]), lambda: repack.main(["/nonexistent"]),
                 lambda: SemanticCodec(cfg), lambda: FastCodec(cfg, state),
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
