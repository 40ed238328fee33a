"""The port's configuration and command line (jpdse_tpu_torch.config /
.cli) against the JAX package's: every tracked ``opt.json`` loads to the
same ``to_dict()``, a table of argvs parses to equal configs, the eval
derivation, env overrides and printed options agree, and configurations
that later slices of the port own raise naming their ROADMAP item.

The fast path's fields: ``norm_shift`` is implemented (the s2d
InstanceNorm's shifted moments, held against JAX's), and each field that
only re-expresses a TPU layout is flipped in the JAX package with the JAX
output held within 2e-4 of the port's at the tiny config in fp32."""

import dataclasses
import glob
import io
import os
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _batch, _flagship_cfg
from jpdse_tpu import cli as jax_cli
from jpdse_tpu import config as jax_config
from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
from jpdse_tpu.models.fast_codec import FastCodec as JaxFastCodec
from jpdse_tpu.ops.s2d import instance_norm_s2d as jax_instance_norm_s2d
from jpdse_tpu_torch import cli, config
from jpdse_tpu_torch.convert import from_jax_params
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.ops.s2d import instance_norm_s2d
from test_torch_port_codec import _jax_params
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
OPT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(str(REPO / "artifacts/*/*/opt.json")) + glob.glob(
        str(REPO / "artifacts/*/opt.json")))
FLAGSHIP_OPT = "artifacts/flagship_r3/phase3/opt.json"
H, W = 64, 128
ATOL = 2e-4


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    for k in [k for k in os.environ if k.startswith("JPDSE_")]:
        monkeypatch.delenv(k)


def test_the_opt_files_are_there():
    assert len(OPT_FILES) >= 9 and FLAGSHIP_OPT in OPT_FILES


@pytest.mark.parametrize("path", OPT_FILES)
def test_opt_json_loads_equal_in_both_packages(path):
    want = jax_config.Config.load(str(REPO / path))
    got = config.Config.load(str(REPO / path))
    assert got.to_dict() == want.to_dict()
    assert got.to_json() == want.to_json()
    # and the port writes what it read
    assert config.Config.from_dict(got.to_dict()).to_dict() == want.to_dict()


ARGVS = {
    "defaults": [],
    "ade20k defaults": ["--dataset", "ade20k"],
    "custom defaults": ["--dataset", "custom"],
    "clic with an explicit mode": ["--dataset", "clic", "--preprocess_mode", "fixed",
                                   "--num_labels", "12"],
    "load_opt": ["--load_opt", "--opt_file", FLAGSHIP_OPT],
    "load_opt with overrides": ["--load_opt", "--opt_file", FLAGSHIP_OPT, "--mode", "val",
                                "--max_dataset_size", "2", "--fast_inference", "1",
                                "--checkpoints_dir", "runs/x", "--save_dir", "out/x"],
    "tuple flags": ["--normalize_mean", "0.1,0.2,0.3", "--normalize_std", "1",
                    "--quality", "10,20"],
    "dead flags": ["--gpu_ids", "0,1", "--data_type", "16", "--local_rank", "3"],
    "fast fields": ["--head_pallas", "1", "--front_realign", "pallas", "--tail_wgroup", "1",
                    "--norm_shift", "--s2d_e2e", "false", "--fused_realign", "xla",
                    "--tail_split", "0", "--head_fold", "yes"],
    "preprocess prefixes": ["--test_preprocess_mode", "fixed", "--val_crop_size", "256",
                            "--test_load_size", "2048", "--aspect_ratio", "1.5"],
    "bools and optional numbers": ["--no_flip", "--cache_images", "true", "--seed", "7",
                                   "--max_recon_dump", "3", "--vgg_weights_path", "w.npz",
                                   "--do_not_get_codes", "--compute_dtype", "bfloat16"],
}


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_config_equal_in_both_packages(name, is_train):
    argv = [a if a != FLAGSHIP_OPT else str(REPO / a) for a in ARGVS[name]]
    with redirect_stdout(io.StringIO()) as want_out:
        want = jax_cli.parse_config(list(argv), is_train=is_train)
    with redirect_stdout(io.StringIO()) as got_out:
        got = cli.parse_config(list(argv), is_train=is_train)
    assert got.to_dict() == want.to_dict()
    assert bool(got_out.getvalue()) == bool(want_out.getvalue())  # the --gpu_ids note


def test_flags_equal_in_both_packages():
    want = {k: v[:3] for k, v in jax_cli.build_flag_index().items()}
    got = {k: v[:3] for k, v in cli.build_flag_index().items()}
    assert got == want
    want_flags = {a.dest for a in jax_cli.make_parser()[0]._actions}
    assert {a.dest for a in cli.make_parser()[0]._actions} == want_flags


def test_load_opt_needs_opt_file():
    with pytest.raises(SystemExit, match="--opt_file"):
        cli.parse_config(["--load_opt"])


@pytest.mark.parametrize("mode", ["val", "test"])
@pytest.mark.parametrize("path", [FLAGSHIP_OPT, "artifacts/three_phase/phase3/opt.json"])
def test_derive_eval_config_equal_in_both_packages(path, mode):
    want = jax_config.derive_eval_config(jax_config.Config.load(str(REPO / path)), mode)
    got = config.derive_eval_config(config.Config.load(str(REPO / path)), mode)
    assert got.to_dict() == want.to_dict()
    assert got.data.batch_size == 1 and not got.is_train and got.mode == mode
    with pytest.raises(ValueError, match="mode"):
        config.derive_eval_config(got, "train")


def test_print_config_equal_in_both_packages():
    argv = ["--load_opt", "--opt_file", str(REPO / FLAGSHIP_OPT), "--ngf", "8"]
    with redirect_stdout(io.StringIO()) as want:
        jax_cli.print_config(jax_cli.parse_config(argv, is_train=False))
    with redirect_stdout(io.StringIO()) as got:
        cli.print_config(cli.parse_config(argv, is_train=False))
    assert got.getvalue() == want.getvalue()


def test_dataset_defaults_and_paths_equal():
    assert config.DATASET_DEFAULTS == jax_config.DATASET_DEFAULTS
    assert set(config._NESTED) == set(jax_config._NESTED)
    cfg, jcfg = config.Config(), jax_config.Config()
    for dotted in ("data.num_labels", "model.fast.tail_wgroup", "data.test_preprocess.crop_size"):
        config.set_by_path(cfg, dotted, 5)
        jax_config.set_by_path(jcfg, dotted, 5)
        assert config.get_by_path(cfg, dotted) == 5
    assert cfg.to_dict() == jcfg.to_dict()
    with pytest.raises(AttributeError):
        config.set_by_path(cfg, "data.no_such_field", 1)


def test_fast_path_fields_and_env_overrides_equal(monkeypatch):
    names = [f.name for f in dataclasses.fields(jax_config.FastPathConfig)]
    assert [f.name for f in dataclasses.fields(config.FastPathConfig)] == names
    envs = {"JPDSE_S2D_E2E": "1", "JPDSE_HEAD_PALLAS": "force", "JPDSE_HEAD_FOLD": "1",
            "JPDSE_TAIL_SPLIT": "0", "JPDSE_TAIL_WGROUP": "3", "JPDSE_FUSED_REALIGN": "0",
            "JPDSE_FRONT_REALIGN": "auto", "JPDSE_NORM_SHIFT": "1"}
    for k, v in envs.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(config.FastPathConfig().resolved())
    assert got == dataclasses.asdict(jax_config.FastPathConfig().resolved())
    assert got["norm_shift"] and got["tail_wgroup"] == 3 and not got["tail_split"]
    with pytest.raises(ValueError, match="s2d_e2e"):
        config.FastPathConfig(s2d_e2e=True, head_pallas="force").validate()
    config.FastPathConfig(s2d_e2e=True, head_pallas="force").validate(check_combos=False)
    with pytest.raises(ValueError, match="tail_wgroup"):
        config.FastPathConfig(tail_wgroup=0).validate()
    with pytest.raises(ValueError, match="fused_realign"):
        config.FastPathConfig(fused_realign="yes").validate()


def test_flagship_config_keeps_its_values():
    cfg = config.flagship_config()
    m = cfg.model
    assert (cfg.data.num_labels, m.ngf, m.n_downsample_global, m.n_blocks_global) == (35, 64, 4, 9)
    assert (m.encoder_binarizer_out_channels, m.label_encoder_binarizer_out_channels) == (128, 128)
    assert m.compute_dtype == "bfloat16" and m.fast_inference and m.no_generator_binarization
    assert not m.fused_instance_norm and m.fast.head_pallas == "0"
    k = config.flagship_config(kernels=True).model
    assert k.fused_instance_norm and (k.fast.head_pallas, k.fast.front_realign) == ("1", "pallas")


def _grouped(c):
    c.model.netE_groups, c.model.nef, c.model.encoder_binarizer_out_channels = 3, 6, 12


# the configurations that raised naming item 10 before the LocalEnhancer
# family was ported load and build now; only the batch norm still raises
NOT_PORTED = {
    "local netG": (lambda c: setattr(c.model, "netG", "local"), None),
    "batch norm": (lambda c: setattr(c.model, "norm", "batch"), "item 10"),
    "grouped netE": (_grouped, None),
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_configs_of_later_slices_raise_naming_their_item(name):
    cfg = config.flagship_config(tiny=True)
    change, item = NOT_PORTED[name]
    change(cfg)
    if item is None:
        config.check_ported(cfg)
        codec = SemanticCodec(cfg, device="cpu")
        assert type(codec.netG).__name__ == ("LocalEnhancer" if name == "local netG"
                                             else "GlobalGenerator")
        return
    with pytest.raises(config.NotPorted, match=f"ROADMAP Queue 1 {item}"):
        config.check_ported(cfg)
    with pytest.raises(config.NotPorted, match=item):
        SemanticCodec(cfg, device="cpu")


# the configurations that raised naming item 5 before the base codecs and
# side info were ported
ITEM_5 = {
    "use_compressed": lambda c: setattr(c.codec, "use_compressed", True),
    "sem_downsample": lambda c: setattr(c.codec, "sem_downsample", 2),
}


@pytest.mark.parametrize("name", sorted(ITEM_5))
def test_configs_of_item_5_check_and_load(name):
    """Each passes check_ported and check_train_ported, its codec builds,
    takes JAX's weights for the same configuration, and decodes a batch
    (with the base codec's decoded image where it reads one) within 2e-4
    of JAX's decode."""
    jcfg = _flagship_cfg(tiny=True)
    jcfg.model.compute_dtype = "float32"
    ITEM_5[name](jcfg)
    cfg = config.flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    ITEM_5[name](cfg)
    config.check_ported(cfg)
    config.check_train_ported(cfg)
    batch = {k: np.array(v) for k, v in _batch(jcfg, 1, H, W, np.random.default_rng(4)).items()}
    batch["compressed"] = np.random.default_rng(5).normal(size=(1, H, W, 3)).astype(np.float32)
    jcodec = JaxCodec(jcfg)
    inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"],
                                batch["compressed"])
    params = _jax_params(jcodec, inputs, seed=6)
    want = np.asarray(jcodec.apply({"params": params}, inputs, method=JaxCodec.decode)[0])
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    codec.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = codec.decode(codec.prepare({k: torch.from_numpy(v) for k, v in batch.items()}))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def _g_binarized(c):
    m = c.model
    m.no_generator_binarization = False
    m.no_encoder_binarization = m.no_label_encoder_binarization = True


# the configurations that raised naming item 6 before the assemblies and
# generator binarization were ported
ITEM_6 = {
    "raw semantics": lambda c: setattr(c.model, "no_label_encoding", True),
    "raw visuals": lambda c: setattr(c.model, "no_feat_encoding", True),
    "unbinarized netE": lambda c: setattr(c.model, "no_encoder_binarization", True),
    "zero_sem": lambda c: setattr(c.model, "zero_sem", True),
    "use_netE_output": lambda c: setattr(c.model, "use_netE_output", True),
    "generator binarization": _g_binarized,
}


@pytest.mark.parametrize("name", sorted(ITEM_6))
def test_item_6_configs_build_train_and_decode(name):
    """Each passes check_train_ported, and its Trainer takes a finite
    training step and reconstructs a batch of the input's shape."""
    from jpdse_tpu_torch.trainer import Trainer

    cfg = config.flagship_config(tiny=True)
    ITEM_6[name](cfg)
    cfg.model.compute_dtype, cfg.model.fast_inference, cfg.model.ndf = "float32", False, 8
    cfg.loss.no_vgg_loss = True
    cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", W
    cfg.validate()
    config.check_train_ported(cfg)
    rng = np.random.default_rng(7)
    batch = {"label": rng.integers(0, 35, (2, H, W)).astype(np.float32),
             "instance": rng.integers(0, 1000, (2, H, W)).astype(np.int32),
             "image": rng.normal(size=(2, H, W, 3)).astype(np.float32)}
    trainer = Trainer(cfg, mode="train", device="cpu")
    assert all(np.isfinite(v) for v in trainer.step(batch).values())
    image = trainer.get_img(batch)
    assert image.shape == (2, H, W, 3) and torch.isfinite(image).all()


# the tracked recipes that the port does not train yet: none since the
# LocalEnhancer family (the high-resolution series) was ported
REFUSED = set()


def test_every_flagship_opt_json_the_port_runs_is_checked():
    """All 29 tracked recipes pass check_train_ported, the base-codec ones
    and the high-resolution LocalEnhancer series among them."""
    assert REFUSED <= set(OPT_FILES) and len(OPT_FILES) == 29
    assert {f"artifacts/flagship_r3_hires/{p}/opt.json" for p in ("phaseA", "phaseB")} \
        <= set(OPT_FILES)
    for path in OPT_FILES:
        cfg = config.Config.load(str(REPO / path))
        if path in REFUSED:
            with pytest.raises(config.NotPorted, match="item 10"):
                config.check_train_ported(cfg)
        else:
            config.check_train_ported(cfg)


# -- the fast path's fields -------------------------------------------------

@pytest.mark.parametrize("use_shift,offset", [(True, 300.0), (None, 300.0), (False, 1.0)])
def test_instance_norm_s2d_shift_matches_jax(use_shift, offset, monkeypatch):
    """Shifted moments against JAX's on an input whose mean is far from 0
    (where the shift matters), and within float64 moments' 1e-4; ``None``
    reads JPDSE_NORM_SHIFT. The unshifted one-pass moments against JAX's on
    a well-conditioned input."""
    monkeypatch.setenv("JPDSE_NORM_SHIFT", "1")
    rng = np.random.default_rng(3)
    x = (offset + rng.normal(size=(2, 6, 10, 4 * 5)) * 2.0).astype(np.float32)
    want = np.asarray(jax_instance_norm_s2d(jnp.asarray(x), use_shift=use_shift))
    got = instance_norm_s2d(torch.from_numpy(x), use_shift=use_shift).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    ref = x.reshape(2, 6, 10, 4, 5).astype(np.float64)
    exact = (ref - ref.mean(axis=(1, 2, 3), keepdims=True)) / np.sqrt(
        ref.var(axis=(1, 2, 3), keepdims=True) + 1e-5)
    assert np.abs(got - exact.reshape(x.shape)).max() < 1e-4


@pytest.fixture(scope="module")
def fast_ref():
    """JAX weights and batch at the tiny config, fp32, and the port's fast
    decode with the default fields."""
    jcfg = _flagship_cfg(tiny=True)
    jcfg.model.compute_dtype = "float32"
    batch = {k: np.array(v) for k, v in _batch(jcfg, 1, H, W, np.random.default_rng(4)).items()}
    inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"])
    params = _jax_params(JaxCodec(jcfg), inputs, seed=6)
    state = from_jax_params(params)
    cfg = config.flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    port = FastCodec(cfg, state, device="cpu").decode(tb).numpy()
    return {"params": params, "batch": batch, "state": state, "port": port, "tb": tb}


LAYOUT_FIELDS = {
    "s2d_e2e": ("fast", "s2d_e2e", True),
    "head_fold": ("fast", "head_fold", True),
    "tail_split off": ("fast", "tail_split", False),
    "tail_wgroup 1": ("fast", "tail_wgroup", 1),
    "fused_realign 0": ("fast", "fused_realign", "0"),
    "fused_realign xla": ("fast", "fused_realign", "xla"),
    "phase_deconv": ("model", "phase_deconv", True),
}


@pytest.mark.parametrize("name", sorted(LAYOUT_FIELDS))
def test_layout_fields_flipped_in_jax_stay_with_the_port(fast_ref, name):
    """Each field the port carries as data, flipped in the JAX package: its
    output stays within 2e-4 of the port's (which ignores the field), and
    the port accepts the field set."""
    where, field_name, value = LAYOUT_FIELDS[name]
    jcfg = _flagship_cfg(tiny=True)
    jcfg.model.compute_dtype = "float32"
    target = jcfg.model.fast if where == "fast" else jcfg.model
    setattr(target, field_name, value)
    if where == "fast":
        want = np.asarray(JaxFastCodec(jcfg, fast_ref["params"], dtype=jnp.float32).decode(
            fast_ref["batch"]))
        want_default = fast_ref["port"]
    else:
        jcodec = JaxCodec(jcfg)
        b = fast_ref["batch"]
        want = np.asarray(jcodec.apply(
            {"params": fast_ref["params"]},
            jax_prepare_inputs(jcfg, b["label"], b["instance"], b["image"]),
            method=JaxCodec.decode)[0])
        cfg = config.flagship_config(tiny=True)
        cfg.model.compute_dtype = "float32"
        codec = SemanticCodec(cfg, device="cpu", seed=None)
        codec.load_state_dict(fast_ref["state"])
        with torch.inference_mode():
            want_default = codec.decode(codec.prepare(fast_ref["tb"]))[0].numpy()
    np.testing.assert_allclose(want, want_default, rtol=0, atol=ATOL)
    cfg = config.flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    setattr(cfg.model.fast if where == "fast" else cfg.model, field_name, value)
    got = FastCodec(cfg, fast_ref["state"], device="cpu").decode(fast_ref["tb"]).numpy()
    np.testing.assert_array_equal(got, fast_ref["port"])


def test_norm_shift_fast_path_matches_jax(fast_ref):
    jcfg = _flagship_cfg(tiny=True)
    jcfg.model.compute_dtype = "float32"
    jcfg.model.fast.norm_shift = True
    want = np.asarray(JaxFastCodec(jcfg, fast_ref["params"], dtype=jnp.float32).decode(
        fast_ref["batch"]))
    cfg = config.flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    cfg.model.fast.norm_shift = True
    got = FastCodec(cfg, fast_ref["state"], device="cpu").decode(fast_ref["tb"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not np.array_equal(got, fast_ref["port"])  # the shifted moments did run
