"""The PyTorch port's training entry point and Trainer on the CPU: train,
validate, save, load and resume through ``train.run.main`` on a synthetic
Cityscapes tree under tmp (the bundled split is dangling symlinks), as
tests/test_cli_and_trainer.py::test_end_to_end_train_val_save_load drives
the JAX package; the training options the port does not run; and kernel
K3's launches per training step, pinned with counting stubs in place of
its plain versions (what chip_smoke.py asserts on the card)."""

import copy
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from jpdse_tpu_torch import test as test_entry
from jpdse_tpu_torch.cli import parse_config
from jpdse_tpu_torch.config import derive_eval_config, flagship_config
from jpdse_tpu_torch.data import create_dataloader
from jpdse_tpu_torch.ops import instance_norm
from jpdse_tpu_torch.train import run
from jpdse_tpu_torch.trainer import Trainer
from test_torch_port_threads import port_test_threads  # noqa: F401

H, W = 64, 128
TINY = ["--ngf", "8", "--nef", "8", "--ne4lf", "8", "--ndf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1", "--n_downsample_E", "2", "--n_downsample_E4label", "2",
        "--encoder_binarizer_out_channels", "8", "--label_encoder_binarizer_out_channels", "8",
        "--label_encoder_out_channels", "8", "--no_generator_binarization"]


def write_tree(root: Path, n: int = 4):
    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        for i in range(n):
            name = f"lindau_{i:06d}_000019"
            d, g = root / "leftImg8bit" / split / "lindau", root / "gtFine" / split / "lindau"
            d.mkdir(parents=True, exist_ok=True)
            g.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (2 * H, 2 * W, 3), dtype=np.uint8)).save(
                d / f"{name}_leftImg8bit.png")
            Image.fromarray(rng.integers(0, 35, (2 * H, 2 * W), dtype=np.uint8)).save(
                g / f"{name}_gtFine_labelIds.png")
            Image.fromarray(rng.integers(0, 6, (2 * H, 2 * W), dtype=np.uint8)).save(
                g / f"{name}_gtFine_instanceIds.png")


def train_argv(root: Path, run_dir: Path, *extra):
    pp = []
    for prefix in ("", "val_", "test_"):
        pp += [f"--{prefix}preprocess_mode", "fixed", f"--{prefix}load_size", str(W),
               f"--{prefix}crop_size", str(W)]
    return ["--dataset", "cityscapes", "--root_dir", str(root), "--batch_size", "2",
            "--num_workers", "2", "--seed", "0", "--normalize_std", "1", "--remat", "1",
            "--max_recon_dump", "2", "--save_dir", str(run_dir)] + TINY + pp + list(extra)


def _quiet(fn):
    with redirect_stdout(io.StringIO()) as out:
        result = fn()
    return result, out.getvalue()


def test_train_main_validates_saves_and_resumes(tmp_path):
    root, run_dir = tmp_path / "cityscapes", tmp_path / "run"
    write_tree(root)
    argv = train_argv(root, run_dir, "--num_epochs", "1", "--val_interval", "1")
    trainer, text = _quiet(lambda: run.main(argv, device="cpu"))
    assert trainer.steps_taken == 2  # 4 images, batch 2, drop_last
    # no cache_images: the device cache stays off without a word, as in JAX
    assert "resident on device" not in text and "saving model..." in text
    for f in ("opt.json", "params_g.pt", "params_d.pt", "opt.pt", "trainer_meta.json",
              "loss_log.txt", "metrics.jsonl", "train_visualizations/index.html"):
        assert (run_dir / f).exists(), f
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 2]
    assert all(np.isfinite(r[k]) for r in records[:2] for k in ("G_GAN", "loss_D", "G_VGG"))
    meta = json.loads((run_dir / "trainer_meta.json").read_text())
    assert meta["epoch"] == 0 and meta["best_val_loss"] == trainer.best_val_loss < 255

    cfg = parse_config(argv, is_train=True)
    val_batch = next(iter(create_dataloader(derive_eval_config(cfg, "val"))))
    loss = trainer.get_eval_loss(val_batch)
    assert 0 < loss < 255
    assert trainer.get_img(val_batch).shape == (1, H, W, 3)  # val batches are of 1
    for serve in (trainer.get_code, trainer.get_eval_rate, trainer.compress):
        with pytest.raises(RuntimeError, match="mode='train'"):
            serve(val_batch)

    # a fresh Trainer restores the whole state and reproduces the eval loss
    cfg.checkpoints_dir = cfg.save_dir
    again = Trainer(cfg, mode="train", device="cpu")
    _quiet(again.load)
    assert again.steps_taken == 2 and again.start_epoch == 1
    assert abs(again.get_eval_loss(val_batch) - loss) < 1e-4
    for a, b in zip(trainer.gan.opt_g.state.values(), again.gan.opt_g.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])

    # resume through main: the load is validated, one more epoch trains,
    # and with no validation due it writes save_dir/latest
    resume = argv + ["--load_model", "--checkpoints_dir", str(run_dir), "--val_interval", "5",
                     "--latest_interval", "1"]
    trainer2, text = _quiet(lambda: run.main(resume, device="cpu"))
    assert trainer2.start_epoch == 1 and trainer2.steps_taken == 4
    assert "latest-state checkpoint saved" in text
    assert json.loads((run_dir / "latest/trainer_meta.json").read_text())["epoch"] == 1
    # and the next resume starts from latest, which is newer than the best-val save
    trainer3, text = _quiet(lambda: run.main(resume, device="cpu"))
    assert "resuming from latest-state checkpoint" in text
    assert trainer3.start_epoch == 2 and trainer3.steps_taken == 6

    # the evaluation entry point reads the training run's params_g.pt
    metrics, _ = _quiet(lambda: test_entry.main(
        ["--load_opt", "--opt_file", str(run_dir / "opt.json"), "--checkpoints_dir",
         str(run_dir), "--save_dir", str(tmp_path / "eval"), "--mode", "val",
         "--max_dataset_size", "2"], device="cpu"))
    assert metrics["n_images"] == 2 and np.isfinite(metrics["PSNR"])


def test_max_host_rss_gb_exits_75_with_latest_and_resumes_exactly(tmp_path, monkeypatch):
    """The flagship's phase 1 (``--no_feat``) with a host-memory limit that
    any process passes: after its first epoch main logs the limit, writes
    save_dir/latest and exits with 75. A second main with the same flags and
    ``--load_model --checkpoints_dir`` resumes from latest: at the start of
    its epoch the parameters, Adam's moments and the step count equal the
    saved ones; it trains that epoch and exits with 75 again."""
    root, run_dir = tmp_path / "cityscapes", tmp_path / "run"
    write_tree(root)
    argv = train_argv(root, run_dir, "--no_feat", "--num_epochs", "3", "--val_interval", "5",
                      "--max_host_rss_gb", "0.001")
    with pytest.raises(SystemExit) as exit1:
        _quiet(lambda: run.main(argv, device="cpu"))
    assert exit1.value.code == run.EXIT_RESTART == 75
    log = (run_dir / "loss_log.txt").read_text()
    assert "> --max_host_rss_gb 0.001; saving latest state and exiting 75" in log
    latest = run_dir / "latest"
    assert json.loads((latest / "trainer_meta.json").read_text())["epoch"] == 0
    params = torch.load(latest / "params_g.pt", weights_only=True)
    opt = torch.load(latest / "opt.pt", weights_only=True)
    assert opt["steps_taken"] == 2 and not any(k.startswith("netE.") for k in params)

    seen = {}
    run_epoch = run.run_epoch

    def snapshot(trainer, loader, cfg, epoch, *a):
        if not seen:
            seen.update(epoch=epoch, steps=trainer.steps_taken,
                        params={k: v.clone() for k, v in trainer.gan.codec.state_dict().items()},
                        opt=copy.deepcopy(trainer.gan.opt_g.state_dict()))
        return run_epoch(trainer, loader, cfg, epoch, *a)

    monkeypatch.setattr(run, "run_epoch", snapshot)
    resume = argv + ["--load_model", "--checkpoints_dir", str(run_dir)]
    with pytest.raises(SystemExit) as exit2:
        _quiet(lambda: run.main(resume, device="cpu"))
    assert exit2.value.code == 75
    assert seen["epoch"] == 1 and seen["steps"] == 2
    assert seen["params"].keys() == params.keys()
    assert all(torch.equal(seen["params"][k], params[k]) for k in params)
    for i, st in opt["opt_g"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(seen["opt"]["state"][i][k], st[k]), (i, k)
    assert json.loads((latest / "trainer_meta.json").read_text())["epoch"] == 1
    assert torch.load(latest / "opt.pt", weights_only=True)["steps_taken"] == 4


def test_unported_training_options_raise_naming_their_item(tmp_path):
    """The options items 7, 9 and 11 ported train, one step each on the
    CPU, and so does the batch norm (item 10's remainder)."""
    cases = {"optim.fast_train": True, "model.use_dropout": True,
             "profile_dir": str(tmp_path / "trace"), "optim.vgg_bf16": True}
    rng = np.random.default_rng(1)
    batch = {"label": rng.integers(0, 35, (1, H, W)).astype(np.float32),
             "instance": rng.integers(0, 1000, (1, H, W)).astype(np.int32),
             "image": rng.normal(size=(1, H, W, 3)).astype(np.float32)}
    for field, value in cases.items():
        cfg = flagship_config(tiny=True)
        cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", W
        cfg.model.compute_dtype = "float32"
        cfg.loss.no_vgg_loss = field != "optim.vgg_bf16"
        obj, _, name = field.rpartition(".")
        setattr(cfg if not obj else getattr(cfg, obj), name, value)
        trainer = Trainer(cfg, mode="train", device="cpu")
        metrics = trainer.step(batch)
        assert all(np.isfinite(v) for v in metrics.values()), field
        assert trainer.steps_taken == 1
    # the batch norm trains and evaluates now (it raised naming item 10 before);
    # the fast train decode refuses it with JAX's gate
    cfg = flagship_config(tiny=True)
    cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", W
    cfg.model.compute_dtype, cfg.loss.no_vgg_loss = "float32", True
    cfg.model.norm = "batch"
    trainer = Trainer(copy.deepcopy(cfg), mode="train", device="cpu")
    stats = {k: v.clone() for k, v in trainer.gan.disc.state_dict().items()
             if k.endswith("BatchNorm_0.mean")}
    assert stats and all(np.isfinite(v) for v in trainer.step(batch).values())
    now = trainer.gan.disc.state_dict()
    assert all(not torch.equal(v, now[k]) for k, v in stats.items())
    assert np.isfinite(trainer.get_eval_loss(batch))
    assert trainer.get_img(batch).shape == (1, H, W, 3)
    cfg.optim.fast_train = True
    with pytest.raises(ValueError, match="only instance norm"):
        Trainer(cfg, mode="train", device="cpu")
    # model.niter_fix_global trains now; on a global netG it is ignored, as in JAX
    cfg = flagship_config(tiny=True)
    cfg.model.niter_fix_global = 1
    trainer = Trainer(cfg, mode="train", device="cpu")
    assert not trainer._global_frozen
    assert all(p.requires_grad for p in trainer.gan.codec.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(flagship_config(tiny=True), mode="train")


def _count(monkeypatch):
    calls = {"forward": 0, "backward": 0}
    for key, name in (("forward", "fused_instance_norm_plain"),
                      ("backward", "fused_instance_norm_bwd_plain")):
        fn = getattr(instance_norm, name)

        def counted(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(instance_norm, name, counted)
    return calls


@pytest.mark.parametrize("remat", [True, False])
def test_k3_launches_per_training_step(monkeypatch, remat):
    """At the flagship's depth (4 downsamples, 9 res blocks; narrow widths),
    the kernel configuration's train step runs K3 at all 45 norm sites of
    netG (27), netE (9) and netE4label (9): forward 45, again 45 when block
    remat recomputes every block in the backward, and backward 45;
    evaluation runs the forward alone. The default configuration runs
    none."""
    cfg = flagship_config(tiny=True, kernels=True)
    m = cfg.model
    m.compute_dtype, m.fast_inference, m.ndf = "float32", False, 8
    m.n_downsample_global, m.n_blocks_global = 4, 9
    m.n_downsample_E = m.n_downsample_E4label = 4
    cfg.loss.no_vgg_loss = True
    cfg.optim.remat = remat
    cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", W
    rng = np.random.default_rng(0)
    batch = {"label": rng.integers(0, 35, (2, H, W)).astype(np.float32),
             "instance": rng.integers(0, 1000, (2, H, W)).astype(np.int32),
             "image": rng.normal(size=(2, H, W, 3)).astype(np.float32)}
    calls = _count(monkeypatch)
    trainer = Trainer(cfg, mode="train", device="cpu")
    metrics = trainer.step(batch)
    assert all(np.isfinite(v) for v in metrics.values())
    assert calls == {"forward": 90 if remat else 45, "backward": 45}
    calls.update(forward=0, backward=0)
    trainer.get_eval_loss(batch)
    assert calls == {"forward": 45, "backward": 0}
    m.fused_instance_norm = False
    calls.update(forward=0, backward=0)
    Trainer(cfg, mode="train", device="cpu").step(batch)
    assert calls == {"forward": 0, "backward": 0}


def test_k3_launches_per_phase1_training_step(monkeypatch):
    """The flagship's phase 1 (no netE) at its depth runs K3 at the 36 norm
    sites of netG (27) and netE4label (9): forward 72 with block remat,
    backward 36; evaluation 36."""
    cfg = flagship_config(tiny=True, kernels=True)
    m = cfg.model
    m.compute_dtype, m.fast_inference, m.ndf, m.no_feat = "float32", False, 8, True
    m.n_downsample_global, m.n_blocks_global, m.n_downsample_E4label = 4, 9, 4
    cfg.loss.no_vgg_loss = cfg.loss.no_distortion_loss = True
    cfg.optim.remat = True
    cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", W
    batch = {k: v.numpy() for k, v in _tensor_batch(0).items()}
    calls = _count(monkeypatch)
    trainer = Trainer(cfg, mode="train", device="cpu")
    assert trainer.gan.codec.netE is None
    assert all(np.isfinite(v) for v in trainer.step(batch).values())
    assert calls == {"forward": 72, "backward": 36}
    calls.update(forward=0, backward=0)
    trainer.get_eval_loss(batch)
    assert calls == {"forward": 36, "backward": 0}


def _remat_replay(cfg, batch):
    """loss_and_grads without remat, with block remat and with decode remat,
    from the same generator seed: the metrics and gradients of the last two
    against the first."""
    from jpdse_tpu_torch.train import step

    out = []
    for remat, granularity in ((False, "block"), (True, "block"), (True, "decode")):
        cfg.optim.remat, cfg.optim.remat_granularity = remat, granularity
        trainer = Trainer(cfg, mode="train", device="cpu")
        assert trainer.gan.codec.remat_decode == (remat and granularity == "decode")
        out.append(step.loss_and_grads(trainer.gan, batch, torch.Generator().manual_seed(4)))
    for metrics, grads in out[1:]:
        for k in step.METRICS:
            assert metrics[k].item() == pytest.approx(out[0][0][k].item(), rel=1e-6), k
        for got, want in zip(grads[0] + grads[1], out[0][1][0] + out[0][1][1]):
            assert (got - want).abs().max() <= 1e-5 * max(want.abs().max(), 1e-3)


def _tiny_train_config():
    cfg = flagship_config(tiny=True)
    m = cfg.model
    m.compute_dtype, m.fast_inference, m.ndf = "float32", False, 8
    cfg.loss.no_vgg_loss = True
    cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", W
    return cfg


def _tensor_batch(seed):
    rng = np.random.default_rng(seed)
    return {"label": torch.from_numpy(rng.integers(0, 35, (2, H, W)).astype(np.float32)),
            "instance": torch.from_numpy(rng.integers(0, 1000, (2, H, W)).astype(np.int32)),
            "image": torch.from_numpy(rng.normal(size=(2, H, W, 3)).astype(np.float32))}


def test_decode_granularity_remat_replays_the_binarizer_draws():
    """remat_granularity 'decode' recomputes the whole decode, binarizers
    included, in the backward; the recompute replays the generator's state,
    so the stochastic codes, the metrics and the gradients equal those of
    block remat and of no remat from the same generator seed."""
    _remat_replay(_tiny_train_config(), _tensor_batch(1))


@pytest.mark.parametrize("before_res", [False, True], ids=["after_res", "before_res"])
def test_decode_remat_replays_the_generator_binarizer_draws(before_res):
    """The same with the generator's bottleneck binarized (the encoders
    unbinarized), whose binarizer draws in the decode too; and the draws
    are the generator's: another seed changes the step."""
    cfg = _tiny_train_config()
    m = cfg.model
    m.no_generator_binarization, m.bin_generator_before_res = False, before_res
    m.no_encoder_binarization = m.no_label_encoder_binarization = True
    m.generator_binarizer_out_channels = 16
    batch = _tensor_batch(6)
    _remat_replay(cfg, batch)
    from jpdse_tpu_torch.train import step

    trainer = Trainer(cfg, mode="train", device="cpu")
    a, b = (step.loss_and_grads(trainer.gan, batch, torch.Generator().manual_seed(s))[0]
            for s in (4, 5))
    assert a["G_GAN"].item() != b["G_GAN"].item()


def test_bf16_training_step_keeps_fp32_parameters():
    """``optim.fp16`` selects bf16 compute: a step runs with finite losses,
    the parameters and Adam's moments stay fp32, and VGG computes in its
    own fp32."""
    cfg = flagship_config(tiny=True)
    cfg.model.fast_inference, cfg.model.ndf = False, 8
    cfg.model.compute_dtype, cfg.optim.fp16 = "float32", True
    cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", W
    rng = np.random.default_rng(2)
    batch = {"label": rng.integers(0, 35, (2, H, W)).astype(np.float32),
             "instance": rng.integers(0, 1000, (2, H, W)).astype(np.int32),
             "image": rng.normal(size=(2, H, W, 3)).astype(np.float32)}
    trainer = Trainer(cfg, mode="train", device="cpu")
    assert trainer.gan.codec.dtype == torch.bfloat16
    metrics = trainer.step(batch)
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["G_VGG"] > 0
    assert all(p.dtype == torch.float32 for p in trainer.gan.codec.parameters())
    assert all(s["exp_avg"].dtype == torch.float32 for s in trainer.gan.opt_g.state.values())
    assert trainer.gan.vgg(torch.zeros(1, 32, 32, 3, dtype=torch.bfloat16))[0].dtype == torch.float32


def test_base_codec_recipe_trains_and_phase_b_restores_it(tmp_path):
    """The base-codec recipe (raw semantics over a jpg-decoded image, the
    data pipeline's round trip memoized under cache_images) through
    train.run.main: phase A trains two epochs and saves, every epoch logs
    its loader wait; phase B (distortion only) restores every leaf of G
    from it, its Adams fresh, and trains on."""
    root, a_dir, b_dir = tmp_path / "cityscapes", tmp_path / "phaseA", tmp_path / "phaseB"
    write_tree(root)
    base = ["--no_feat_encoding", "--no_label_encoding", "--use_compressed", "--ext", "jpg",
            "--quality", "50", "--cache_images", "1", "--no_vgg_loss"]
    argv_a = train_argv(root, a_dir, *base, "--num_epochs", "2", "--val_interval", "2")
    trainer, text = _quiet(lambda: run.main(argv_a, device="cpu"))
    assert trainer.steps_taken == 4 and (a_dir / "params_g.pt").exists()
    waits = [line for line in text.splitlines() if ": loader wait " in line]
    assert [w.split(":")[0] for w in waits] == ["epoch 1", "epoch 2"]
    assert (a_dir / "loss_log.txt").read_text().count(": loader wait ") == 2
    argv_b = train_argv(root, b_dir, *base, "--num_epochs", "1", "--val_interval", "1",
                        "--no_d_gan_loss", "--no_g_gan_loss", "--no_gan_feat_loss",
                        "--schedule_lr", "1", "--load_model", "--checkpoints_dir", str(a_dir))
    trainer_b, text = _quiet(lambda: run.main(argv_b, device="cpu"))
    n = len(trainer_b.gan.codec.state_dict()) + len(trainer_b.gan.disc.state_dict())
    assert f"restored params from {a_dir}: {n}/{n} leaves matched" in text
    assert trainer_b.start_epoch == 2 and trainer_b.steps_taken == 6  # A's 4, then 2
    assert trainer_b.gan.codec.netG.head.conv.conv.weight.shape[1] == 39
