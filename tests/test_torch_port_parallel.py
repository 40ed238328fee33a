"""The port's data-parallel training over a process group on the CPU (gloo):
``parallel/distributed.py``, ``parallel/mesh.py``, the loader's rank
shards, the device cache's multi-process gates, and ``train/step.py``'s
global step, held against JAX's loader and the port's own single-process
step.

The two-rank cases run in one spawn of two gloo processes (at the end of
the module's fixture): each rank steps batch 1, its row of a global batch
of 2, for two steps of the phase-2 recipe at the tiny config that
``test_torch_port_train_step.py`` holds against JAX (fp32; float64; with
``pool_size`` 2 and dropout), and runs ``train.run.main`` on synthetic PNGs
and then resumes it with ``--load_model``. The parent process steps the
same recipe in one process on the whole global batch. No JAX step is
compiled here: the single-process step is the one the JAX tests pin.

Both sides' binarizers draw their uniforms as the stochastic sign does,
recorded and compared bit for bit (each rank's are its row of one process's
draws), and take the deterministic sign, as the JAX tests' harness does:
a bit whose pre-sign lies at its threshold within the two sides' rounding
would otherwise decode different codes. Dropout's masks and the pool's
draws are the real ones.

Tolerances: in fp32, ``test_torch_port_train_step.py``'s rule (metrics
1e-4 relative, each gradient tensor 1e-4 of its max-abs; a bias an
InstanceNorm follows 0 to rounding, at most 1e-5 of its network's largest
gradient): the two sides differ by float reassociation over the batch. In
float64, 1e-9 in relative L2 for every gradient and parameter (a bias an
InstanceNorm follows within 1e-9 absolute), and the metrics, which the
step hands over in fp32, within 2 of their ulps. Across the ranks the
parameters are bit-identical after each step.

This module imports only the port, numpy and PIL at its top: the spawned
ranks import it and need no JAX.
"""

import builtins
import contextlib
import copy
import io
import os
import re
import socket
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jpdse_tpu_torch.config import Config, NotPorted, check_train_ported
from jpdse_tpu_torch.data.loader import DataLoader
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import build_discriminator
from jpdse_tpu_torch.models.vgg import init_vgg19
from jpdse_tpu_torch.ops import quantizers
from jpdse_tpu_torch.parallel import distributed, mesh as mesh_mod
from jpdse_tpu_torch.parallel.mesh import draw_rows
from jpdse_tpu_torch.train import step
from jpdse_tpu_torch.train.state import create_train_state
from test_torch_port_threads import port_test_threads  # noqa: F401

B, H, W = 2, 64, 128  # the global batch: one image a rank
CASES = ("fp32", "float64", "pool_dropout")
RTOL = 1e-4
F64_TOL = 1e-9
NORMED_BIAS = re.compile(r"(^|\.)(head|down\.\d+|up(\.\d+)?|res\.\d+|layer[1-9]|c7|d1)\..*bias$")


# -- the recipe ----------------------------------------------------------------------
def global_batch() -> dict:
    """A synthetic global batch of 2, as __graft_entry__._batch makes one."""
    rng = np.random.default_rng(21)
    return {"label": rng.integers(0, 35, (B, H, W)).astype(np.float32),
            "instance": rng.integers(0, 6, (B, H, W)).astype(np.int32),
            "image": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)}


def case_config(cfg_dict: dict, case: str) -> Config:
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    if case == "pool_dropout":
        cfg.model.pool_size, cfg.model.use_dropout = 2, True
    cfg.validate()
    return cfg


def build_state(cfg: Config, case: str, mesh):
    """The port's training state from seeded weights (the same in every
    process; under a mesh rank 0's are broadcast too), in float64 for that
    case."""
    codec = SemanticCodec(cfg, device="cpu", seed=12)
    disc = build_discriminator(cfg, "cpu", torch.Generator().manual_seed(3))
    vgg = init_vgg19("cpu", torch.Generator().manual_seed(0))
    if case == "float64":
        codec, disc, vgg = codec.double(), disc.double(), vgg.double()
        codec.dtype = torch.float64
    return create_train_state(cfg, codec, disc, vgg, (H, W, cfg.netD_input_nc), mesh)


@contextlib.contextmanager
def recorded_sign(draws: list):
    """The binarizers draw their uniforms as the stochastic sign does (for
    the global batch, this rank's rows kept), which are recorded, and take
    the deterministic sign: a bit whose pre-sign lies at its threshold
    within the two sides' rounding would otherwise decode different codes."""
    real = quantizers.stochastic_sign_ste

    def sign(x, generator):
        draws.append(draw_rows(x.shape, lambda s: torch.rand(
            s, dtype=x.dtype, device=x.device, generator=generator)).clone())
        return quantizers.deterministic_sign_ste(x)

    quantizers.stochastic_sign_ste = sign
    try:
        yield
    finally:
        quantizers.stochastic_sign_ste = real


def run_case(cfg_dict: dict, case: str, batch: dict, mesh) -> list:
    """Two steps; per step the metrics, both players' gradients, the
    parameters after it (named, on the CPU) and the binarizers' draws."""
    cfg = case_config(cfg_dict, case)
    state = build_state(cfg, case, mesh)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if case == "float64":
        b["image"] = b["image"].double()
    gen = torch.Generator().manual_seed(0)
    names = ([n for n, _ in state.codec.named_parameters()],
             [n for n, _ in state.disc.named_parameters()])
    out = []
    for _ in range(2):
        draws: list = []
        with recorded_sign(draws):
            metrics, grads = step.loss_and_grads(state, b, gen)
        step.apply(state, grads)
        out.append({
            "metrics": {k: v.item() for k, v in metrics.items()},
            "grads": [dict(zip(n, (g.detach().clone() for g in gs))) for n, gs in zip(names, grads)],
            "params": [{k: v.detach().clone() for k, v in m.state_dict().items()}
                       for m in (state.codec, state.disc)],
            "draws": draws,
        })
    return out


# -- the ranks -----------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def writes_recorded(root: str, seen: list):
    """Record every file under ``root`` opened for writing."""
    real_open = builtins.open

    def recording(file, mode="r", *a, **k):
        if any(c in str(mode) for c in "wax") and str(file).startswith(root):
            seen.append(str(file))
        return real_open(file, mode, *a, **k)

    builtins.open = recording
    try:
        yield
    finally:
        builtins.open = real_open


def rank_main(rank: int, port: int, work: str) -> None:
    """One of the two ranks: the process group from JAX's environment, the
    step cases, then the training entry point and its resume."""
    from jpdse_tpu_torch.train import run

    os.environ.update(JPDSE_COORDINATOR=f"localhost:{port}", JPDSE_NUM_PROCESSES="2",
                      JPDSE_PROCESS_ID=str(rank))
    torch.set_num_threads(2)
    assert distributed.initialize(device="cpu") and distributed.world() == 2
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    result = {}
    for case in CASES:
        mesh = mesh_mod.mesh_from_config(case_config(spec["cfg"], case).parallel)
        rows = {k: v[mesh.rows(1)] for k, v in spec["batch"].items()}
        result[case] = run_case(spec["cfg"], case, rows, mesh)
    cli = {}
    for name, argv in (("train", spec["argv"]), ("resume", spec["resume"])):
        seen: list = []
        with redirect_stdout(io.StringIO()) as text, writes_recorded(spec["run_dir"], seen):
            trainer = run.main(argv, device="cpu")
        cli[name] = {"text": text.getvalue(), "writes": seen,
                     "steps": trainer.steps_taken, "start_epoch": trainer.start_epoch}
    result["cli"] = cli
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    dist.destroy_process_group()


def write_tree(root: Path, n: int = 4) -> None:
    from PIL import Image

    rng = np.random.default_rng(5)
    for split in ("train", "val"):
        for i in range(n):
            name = f"lindau_{i:06d}_000019"
            d, g = root / "leftImg8bit" / split / "lindau", root / "gtFine" / split / "lindau"
            d.mkdir(parents=True, exist_ok=True)
            g.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
                d / f"{name}_leftImg8bit.png")
            Image.fromarray(rng.integers(0, 35, (H, W), dtype=np.uint8)).save(
                g / f"{name}_gtFine_labelIds.png")
            Image.fromarray(rng.integers(0, 6, (H, W), dtype=np.uint8)).save(
                g / f"{name}_gtFine_instanceIds.png")


def cli_argv(root: Path, run_dir: Path) -> list:
    tiny = ["--ngf", "8", "--nef", "8", "--ne4lf", "8", "--ndf", "8",
            "--n_downsample_global", "2", "--n_blocks_global", "1", "--n_downsample_E", "2",
            "--n_downsample_E4label", "2", "--encoder_binarizer_out_channels", "8",
            "--label_encoder_binarizer_out_channels", "8", "--label_encoder_out_channels", "8",
            "--no_generator_binarization", "--no_vgg_loss"]
    pp = []
    for prefix in ("", "val_"):
        pp += [f"--{prefix}preprocess_mode", "fixed", f"--{prefix}load_size", str(W),
               f"--{prefix}crop_size", str(W)]
    return ["--dataset", "cityscapes", "--root_dir", str(root), "--batch_size", "1",
            "--num_workers", "1", "--seed", "0", "--normalize_std", "1", "--remat", "1",
            "--max_recon_dump", "1", "--num_epochs", "1", "--val_interval", "1",
            "--always_save", "--save_dir", str(run_dir)] + tiny + pp


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The phase-2 recipe's config (tiny, batch 2) from the JAX tests'
    harness, the single-process steps on the global batch, and the two
    ranks' results from one spawn."""
    from test_torch_port_train_step import jax_config

    work = tmp_path_factory.mktemp("ranks")
    cfg_dict = jax_config("phase2", False).to_dict()
    batch = global_batch()
    root, run_dir = work / "cityscapes", work / "run"
    write_tree(root)
    argv = cli_argv(root, run_dir)
    resume = argv + ["--load_model", "--checkpoints_dir", str(run_dir)]
    torch.save({"cfg": cfg_dict, "batch": batch, "argv": argv, "resume": resume,
                "run_dir": str(run_dir)}, work / "spec.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(r, port, str(work))) for r in range(2)]
    for p in procs:
        p.start()
    single = {case: run_case(cfg_dict, case, batch, None) for case in CASES}
    for p in procs:
        p.join(timeout=600)
    assert [p.exitcode for p in procs] == [0, 0], "a rank failed"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"single": single, "ranks": ranks, "run_dir": run_dir}


def _check_fp32(got: dict, want: dict) -> None:
    for k in step.METRICS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=RTOL, atol=0,
                                   err_msg=k)
    for net_got, net_want in zip(got["grads"], want["grads"]):
        top = max(g.abs().max().item() for g in net_want.values())
        for n, w in net_want.items():
            g = net_got[n]
            if NORMED_BIAS.search(n):
                assert max(g.abs().max().item(), w.abs().max().item()) <= 1e-5 * top, n
                continue
            err = (g - w).abs().max().item()
            assert err <= RTOL * w.abs().max().item(), f"{n}: {err} of {w.abs().max().item()}"


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / max(b.norm().item(), 1e-300)).item()


def _check_float64(got: dict, want: dict) -> None:
    for k in step.METRICS:  # the step hands its metrics over in fp32, so to 2 of its ulps
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2 * 2.0**-23,
                                   atol=0, err_msg=k)
    for kind in ("grads", "params"):
        for net_got, net_want in zip(got[kind], want[kind]):
            for n, w in net_want.items():
                if NORMED_BIAS.search(n):
                    assert (net_got[n] - w).abs().max().item() <= F64_TOL, f"{kind} {n}"
                else:
                    assert _rel_l2(net_got[n], w) <= F64_TOL, f"{kind} {n}"


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_step_as_one_process_on_the_global_batch(two_ranks, case):
    """Each rank's two steps against one process's on the global batch,
    and the two ranks' parameters bit-identical after each step."""
    single, ranks = two_ranks["single"][case], [r[case] for r in two_ranks["ranks"]]
    for k in range(2):
        for r, got in enumerate(ranks):
            # each rank's uniforms are its row of one process's draws for the global batch
            assert len(got[k]["draws"]) == len(single[k]["draws"]) == 2
            for u, want in zip(got[k]["draws"], single[k]["draws"]):
                assert torch.equal(u, want[r:r + 1])
            (_check_float64 if case == "float64" else _check_fp32)(got[k], single[k])
        for a, b in zip(ranks[0][k]["params"], ranks[1][k]["params"]):
            assert all(torch.equal(a[n], b[n]) for n in a), f"step {k + 1}: ranks differ"
        if case != "float64":
            for a, b in zip(ranks[0][k]["grads"], ranks[1][k]["grads"]):
                assert all(torch.equal(a[n], b[n]) for n in a)
    if case == "pool_dropout":  # the pool filled with the global batch and then swapped
        assert single[1]["metrics"]["D_fake"] != single[0]["metrics"]["D_fake"]


def test_two_rank_training_entry_point_writes_once_and_resumes(two_ranks):
    """``train.run.main`` under two processes: rank 0 alone writes, both
    ranks log the same losses (the all-reduced metrics), each rank takes
    its shard's two steps, and ``--load_model`` resumes at epoch 2."""
    run_dir = two_ranks["run_dir"]
    cli = [r["cli"] for r in two_ranks["ranks"]]
    for f in ("opt.json", "params_g.pt", "params_d.pt", "opt.pt", "trainer_meta.json",
              "loss_log.txt", "metrics.jsonl"):
        assert (run_dir / f).exists(), f
    assert cli[0]["train"]["writes"] and not cli[1]["train"]["writes"]
    assert not cli[1]["resume"]["writes"]

    def losses(text):
        return [line for line in text.splitlines() if line.startswith("g_gan:")]

    for name in ("train", "resume"):
        assert len(losses(cli[0][name]["text"])) == 2
        assert losses(cli[0][name]["text"]) == losses(cli[1][name]["text"])
    assert "multi-process mesh: dcn=2" in cli[1]["train"]["text"]
    for r in cli:
        assert r["train"]["steps"] == 2 and r["train"]["start_epoch"] == 0
        assert r["resume"]["steps"] == 4 and r["resume"]["start_epoch"] == 1


# -- the loader's shards -------------------------------------------------------------
class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffled", "in_order"])
def test_rank_shards_equal_jax_loader(shuffle):
    """30 images over 4 ranks: the port's index batches equal JAX's
    DataLoader(rank=, world=) for every rank and two epochs, padded by
    wrapping to 8 each, and the shards cover every image."""
    from jpdse_tpu.data.loader import DataLoader as JaxLoader

    seen = []
    for epoch in (0, 3):
        for rank in range(4):
            kw = dict(batch_size=3, shuffle=shuffle, drop_last=shuffle, seed=7, rank=rank,
                      world=4)
            port, ref = DataLoader(_Indices(30), **kw), JaxLoader(_Indices(30), **kw)
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got = [list(map(int, b)) for b in port._index_batches()]
            assert got == [list(map(int, b)) for b in ref._index_batches()]
            assert len(port) == len(ref) == len(got)
            seen += [i for b in got for i in b] if epoch == 0 else []
    if not shuffle:
        assert sorted(set(seen)) == list(range(30)) and len(seen) == 32


# -- refusals, declines and a failed rendezvous ---------------------------------------
def _cfg(**parallel) -> Config:
    from jpdse_tpu_torch.config import flagship_config

    cfg = flagship_config(tiny=True)
    for k, v in parallel.items():
        setattr(cfg.parallel, k, v)
    return cfg


def test_spatial_axis_is_not_ported():
    cfg = _cfg(spatial_axis=2)
    with pytest.raises(NotPorted, match="item 12's remainder \\(the spatial axis\\)"):
        check_train_ported(cfg)
    with pytest.raises(NotPorted, match="item 12's remainder"):
        mesh_mod.mesh_from_config(cfg.parallel)


def test_a_data_axis_in_one_process_raises_naming_the_equivalent_run():
    for axis in (-1, 0, 1):
        assert mesh_mod.mesh_from_config(_cfg(data_axis=axis).parallel) is None
    with pytest.raises(ValueError, match="requests a 2x1 \\(data x spatial\\) mesh but only 1 "
                                         "devices are visible.*run 2 processes.*batch_size / 2"):
        mesh_mod.mesh_from_config(_cfg(data_axis=2).parallel)


def test_device_cache_declines_on_several_devices(monkeypatch):
    """JAX's two gates, in its words: a mesh, then more than one process."""
    from jpdse_tpu_torch.data import device_cache

    cfg = _cfg()
    cfg.data.device_cache = cfg.data.cache_images = True

    class Loader:
        dataset = type("D", (), {"_cache_enabled": True})()

    for mesh, world, why in ((mesh_mod.DataMesh(0, 2), 2, "mesh sharding places batches "
                              "per-shard"), (None, 2, "multi-host feeds per-rank shards")):
        monkeypatch.setattr(distributed, "world", lambda w=world: w)
        for fn in (device_cache.maybe_device_cache, device_cache.maybe_val_cache):
            with redirect_stdout(io.StringIO()) as out:
                assert fn(Loader(), cfg, "cpu", mesh=mesh) is None
            assert f"unavailable: {why}; using host batches" in out.getvalue()


def test_failed_initialization_raises():
    """A rendezvous that fails raises (the JAX package would carry on in one
    process); a multi-process request without its coordinator raises too."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        s.listen(1)
        port = s.getsockname()[1]
        with pytest.raises(RuntimeError, match="initializing the gloo process group failed"):
            distributed.initialize("cpu", coordinator_address=f"localhost:{port}",
                                   num_processes=2, process_id=0, timeout_s=5)
    assert not distributed.active()
    with pytest.raises(ValueError, match="needs a coordinator"):
        distributed.initialize("cpu", num_processes=2, process_id=0)
    assert distributed.initialize("cpu", num_processes=1) is False
