"""The port's spatial axis on the CPU (gloo): ``parallel/spatial.py``'s row
exchange, every H-sharded layer against the same layer on the whole
tensor, K3's partial-statistics form, and training and evaluation of the
flagship's standard path with H sharded over a process group, held against
the port's own single process and against JAX's sharded step.

One spawn of four gloo processes runs, in turn:

1. the layers at S = 4 (one group of all four ranks) and at S = 2 (two
   groups of two): each layer of ``models/layers.py``, the semantics, the
   generator, the discriminator (uneven rows: 32 -> 17 -> 9 -> 5 -> 6 -> 7)
   and VGG on a float64 input whose rows the ranks split, its output
   gathered and held against the layer on the whole input within 1e-12,
   and ``torch.autograd.gradcheck`` (fast mode) of the whole sharded
   function (scatter, layer, gather), every rank in lockstep on the same
   global input;
2. the tiny phase-2 recipe (64x128, global batch 2, ``pool_size`` 2,
   dropout) over a data 2 x spatial 2 mesh, in the default and the kernel
   configuration (``fused_instance_norm``), in fp32 and float64, two steps
   each (in fp32 each step on one process's code bits, and the second from
   its state after the first: parameters, Adams, pool); then one step of
   the plain phase-2 recipe at JAX's weights on the same mesh, the layout
   of JAX's ``dryrun_multichip(4)``, which the parent holds against JAX's
   ``make_sharded_train_step`` on a 2 x 2 mesh of the virtual CPU devices;
3. two worlds of two ranks at ``spatial_axis`` 2: ranks 0-1 step the
   default configuration, take one step of the plain phase-2 recipe at
   JAX's weights (which the parent holds against JAX's
   ``make_sharded_train_step`` on a 1 x 2 mesh of the virtual CPU devices)
   and run ``test.main`` on the standard path; ranks 2-3 step the kernel
   configuration and run
   ``train.run.main``.

The parent meanwhile takes the same steps in one process on the whole
batch, JAX's sharded steps and ``test.main`` in one process.

Tolerances: float64, 1e-9 in relative L2 for every gradient and parameter
(a bias an InstanceNorm follows within 1e-9 absolute) and the metrics,
handed over in fp32, within 2 of their ulps; fp32,
``test_torch_port_train_step.py``'s rule (metrics 1e-4 relative, each
gradient tensor 1e-4 of its max-abs, a normed bias 0 to 1e-5 of its
network's largest gradient). The binarizers draw their uniforms, recorded
and compared bit for bit (each rank's are its batch rows and H rows of one
process's draws), and take the deterministic sign, as
``test_torch_port_parallel.py`` does; in fp32 the ranks take one process's
code bits, each differing from their own sign only where the pre-sign lies
within 1e-5 of 0 (a bit that fp32 rounding moves would decode a different
code). Across the ranks the parameters are bit-identical after each step.
"""

import contextlib
import copy
import functools
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

from jpdse_tpu_torch.config import Config, flagship_config
from jpdse_tpu_torch.models import layers
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import MultiscaleDiscriminator, NLayerDiscriminator, \
    build_discriminator
from jpdse_tpu_torch.models.generator import Encoder, GlobalGenerator
from jpdse_tpu_torch.models.vgg import init_vgg19
from jpdse_tpu_torch.ops import instance_norm as k3
from jpdse_tpu_torch.ops import quantizers
from jpdse_tpu_torch.ops.semantics import instance_edges
from jpdse_tpu_torch.parallel import distributed, mesh as mesh_mod, spatial
from jpdse_tpu_torch.parallel.mesh import DataMesh, draw_rows
from jpdse_tpu_torch.parallel.spatial import SpatialShard
from jpdse_tpu_torch.train import step
from jpdse_tpu_torch.train.state import create_train_state
from test_torch_port_k3_apply_plan import apply_items, apply_plan, apply_plan_lib  # noqa: F401
from test_torch_port_threads import port_test_threads  # noqa: F401

B, H, W = 2, 64, 128
RTOL = 1e-4
F64_TOL = 1e-9
LAYER_TOL = 1e-12
CASES = ("fp32", "float64")
CONFIGS = ("default", "kernel")


# -- the recipe ----------------------------------------------------------------------
def global_batch() -> dict:
    rng = np.random.default_rng(21)
    return {"label": rng.integers(0, 35, (B, H, W)).astype(np.float32),
            "instance": rng.integers(0, 6, (B, H, W)).astype(np.int32),
            "image": rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)}


def case_config(cfg_dict: dict, config: str, spatial_axis: int = 1, pool_dropout=True) -> Config:
    cfg = Config.from_dict(copy.deepcopy(cfg_dict))
    cfg.model.fused_instance_norm = config == "kernel"
    if pool_dropout:
        cfg.model.pool_size, cfg.model.use_dropout = 2, True
    cfg.parallel.spatial_axis = spatial_axis
    cfg.validate()
    return cfg


def build_state(cfg: Config, case: str, mesh, states=None):
    """Seeded weights (or ``states``, G's and D's state dicts), in float64
    for that case."""
    codec = SemanticCodec(cfg, device="cpu", seed=12)
    disc = build_discriminator(cfg, "cpu", torch.Generator().manual_seed(3))
    vgg = init_vgg19("cpu", torch.Generator().manual_seed(0))
    if states is not None:
        codec.load_state_dict(states["g"])
        disc.load_state_dict(states["d"])
        vgg.load_state_dict(states["v"])
    if case == "float64":
        codec, disc, vgg = codec.double(), disc.double(), vgg.double()
        codec.dtype = torch.float64
    h = H if mesh is None or mesh.spatial == 1 else H // mesh.spatial
    return create_train_state(cfg, codec, disc, vgg, (h, W, cfg.netD_input_nc), mesh)


class _Pinned(torch.autograd.Function):
    """A given sign pattern with the straight-through (identity) gradient."""

    @staticmethod
    def forward(ctx, x, signs):
        return signs.to(x.dtype).clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def recorded_sign(draws: list, signs: list, pinned=None):
    """The binarizers draw their uniforms as the stochastic sign does (for
    the global batch, this rank's rows kept), which are recorded, and take
    the deterministic sign, recorded with its pre-sign; or, given
    ``pinned`` (a function of the call's index and the pre-sign), that
    sign pattern, which may differ from the deterministic sign only where
    the pre-sign is within 1e-5 of 0 (fp32 rounding on either side)."""
    real = quantizers.stochastic_sign_ste

    def sign(x, generator):
        draws.append(draw_rows(x.shape, lambda s: torch.rand(
            s, dtype=x.dtype, device=x.device, generator=generator), spatial.global_h(x)).clone())
        if pinned is None:
            out = quantizers.deterministic_sign_ste(x)
        else:
            want = pinned(len(signs))
            flipped = want != torch.sign(x.detach())
            assert not (flipped & (x.detach().abs() >= 1e-5)).any(), "a bit away from 0 differs"
            out = _Pinned.apply(x, want)
        signs.append(out.detach().clone())
        return out

    quantizers.stochastic_sign_ste = sign
    try:
        yield
    finally:
        quantizers.stochastic_sign_ste = real


def snapshot(state) -> dict:
    """What a step starts from: both players' parameters and Adams, the
    replay pool, the step count and the distortion weight."""
    pool = None if state.pool is None else (state.pool.images.clone(), state.pool.num_imgs)
    return copy.deepcopy({"g": state.codec.state_dict(), "d": state.disc.state_dict(),
                          "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict(),
                          "pool": pool, "steps": state.steps_taken,
                          "lambda": state.lambda_distortion_weight})


def restore(state, snap: dict, mesh) -> None:
    """Start the next step from one process's ``snap``: this rank's H rows
    of the pool's images."""
    state.codec.load_state_dict(snap["g"])
    state.disc.load_state_dict(snap["d"])
    state.opt_g.load_state_dict(snap["opt_g"])
    state.opt_d.load_state_dict(snap["opt_d"])
    if snap["pool"] is not None:
        images, n = snap["pool"]
        if mesh is not None and mesh.spatial > 1:
            images = images[:, mesh.h_rows(images.shape[1])]
        state.pool.images.copy_(images)
        state.pool.num_imgs = n
    state.steps_taken, state.lambda_distortion_weight = snap["steps"], snap["lambda"]


def run_steps(cfg: Config, case: str, batch: dict, mesh, n_steps: int = 2, states=None,
              resume=None) -> list:
    """Steps; per step the metrics, both players' gradients, the parameters
    after it, the binarizers' draws and (one process) a snapshot of the
    state after it. With ``resume``, one process's snapshots, each step
    after the first starts from the previous one's: in fp32 an Adam step
    moves a parameter whose gradient is rounding noise by up to lr either
    way, so each step is held from the same point, as
    ``test_torch_port_train_step.py`` holds its steps."""
    state = build_state(cfg, case, mesh, states)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if case == "float64":
        b["image"] = b["image"].double()
    gen = torch.Generator().manual_seed(0)
    names = ([n for n, _ in state.codec.named_parameters()],
             [n for n, _ in state.disc.named_parameters()])
    out = []
    for k in range(n_steps):
        pinned = None
        if resume is not None:
            if k:
                restore(state, resume[k - 1]["snapshot"], mesh)
            pinned = functools.partial(_rows_of, resume[k]["signs"], mesh)
        draws: list = []
        signs: list = []
        with recorded_sign(draws, signs, pinned):
            metrics, grads = step.loss_and_grads(state, b, gen)
        step.apply(state, grads)
        out.append({
            "metrics": {k: v.item() for k, v in metrics.items()},
            "grads": [dict(zip(n, (g.detach().clone() for g in gs))) for n, gs in zip(names, grads)],
            "params": [{k: v.detach().clone() for k, v in m.state_dict().items()}
                       for m in (state.codec, state.disc)],
            "draws": draws,
            "signs": signs,
            "snapshot": snapshot(state) if mesh is None else None,
        })
    return out


def _rows_of(whole: list, mesh, i: int) -> torch.Tensor:
    """This rank's batch rows and H rows of one process's i-th tensor."""
    t = whole[i]
    if mesh is None:
        return t
    b = t.shape[0] // mesh.n_data
    t = t[mesh.data_index * b:(mesh.data_index + 1) * b]
    return t[:, mesh.h_rows(t.shape[1])] if mesh.spatial > 1 else t


# -- the layers ----------------------------------------------------------------------
class _Scatter(torch.autograd.Function):
    """The whole tensor, the same on every rank -> this rank's rows; the
    gradient of the whole is every rank's placed and summed."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.shape = shard, x.shape
        return spatial.mark(shard.rows(x).clone(), x.shape[1])

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        lo, hi = ctx.shard.owned(ctx.shape[1])
        full[:, lo:hi] = g
        return ctx.shard.all_reduce_(full), None


class _Assemble(torch.autograd.Function):
    """This rank's rows of an output -> the whole output on every rank; each
    rank's gradient of the whole (the same on every rank) gives its rows."""

    @staticmethod
    def forward(ctx, y, shard, hg):
        ctx.shard, ctx.hg = shard, hg
        return spatial.gather_rows(y, shard, hg)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.shard.owned(ctx.hg)
        return g[:, lo:hi].contiguous(), None, None


def sharded(fn, shard):
    """The whole function of ``fn`` run on rows: scatter, ``fn`` under the
    shard, gather (every output, a tensor or a list)."""
    def whole(x):
        with spatial.sharding(shard):
            out = fn(_Scatter.apply(x, shard))
            outs = out if isinstance(out, (list, tuple)) else [out]
            got = [_Assemble.apply(y, shard, spatial.global_h(y, shard)) for y in outs]
        return got if isinstance(out, (list, tuple)) else got[0]
    return whole


def _module(make, seed: int):
    torch.manual_seed(seed)
    m = make().double()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0, 0.3)
    return m


def _dropout_block(padding):
    blk = _module(lambda: layers.ResnetBlock(4, padding_type=padding, use_dropout=True), 3)
    return lambda x: blk(x, deterministic=False, generator=torch.Generator().manual_seed(5))


def _take(mode, pad):
    """The halo primitive alone: the tensor padded by ``pad`` rows of
    ``mode`` on each side, each rank asking for its rows of the padded
    tensor (from whichever ranks own their sources)."""
    def fn(x):
        shard = spatial.current()
        hg = spatial.global_h(x)
        if shard is None:
            idx = [spatial.source_row(r, hg, mode) for r in range(-pad, hg + pad)]
            rows = [x[:, i] if i >= 0 else torch.zeros_like(x[:, 0]) for i in idx]
            return torch.stack(rows, dim=1)
        bp = shard.bounds(hg + 2 * pad)
        out = spatial.take_rows(x, hg, lambda s: range(bp[s] - pad, bp[s + 1] - pad), mode)
        return spatial.mark(out, hg + 2 * pad)
    return fn


def layer_cases():
    """(name, global input shape, the layer as a function of rows, whether
    gradcheck applies: a binarizer's straight-through sign has no finite
    difference)."""
    gen = _module(lambda: GlobalGenerator(5, 3, ngf=4, n_downsampling=2, n_blocks=1,
                                          use_dropout=True), 7)
    bgen = _module(lambda: GlobalGenerator(5, 3, ngf=4, n_downsampling=2, n_blocks=1,
                                           binarize=True, binarizer_out_channels=4,
                                           use_dropout=True), 7)
    enc = _module(lambda: Encoder(3, 3, ngf=4, n_downsampling=2), 8)
    benc = _module(lambda: Encoder(3, 3, ngf=4, n_downsampling=2, binarize=True,
                                   binarizer_out_channels=4), 8)
    d1 = _module(lambda: NLayerDiscriminator(4, ndf=4, n_layers=3), 9)
    dms = _module(lambda: MultiscaleDiscriminator(4, ndf=4, n_layers=3, num_D=2), 10)
    head = _module(lambda: layers.ConvNormAct(3, 4, 7, reflect=3), 11)
    khead = _module(lambda: layers.ConvNormAct(3, 4, 7, reflect=3, fused=True), 11)
    down = _module(lambda: layers.ConvNormAct(4, 6, 3, stride=2, padding=1), 12)
    up = _module(lambda: layers.ConvTransposeNormAct(4, 3), 13)
    kup = _module(lambda: layers.ConvTransposeNormAct(4, 3, fused=True), 13)
    kres = _module(lambda: layers.ResnetBlock(4, fused=True), 14)
    vgg = init_vgg19("cpu", torch.Generator().manual_seed(0)).double()

    def semantics(x):
        # ids from the input's sign pattern, so the function is defined on rows
        ids = spatial.like((x[..., 0] > 0).long() + (x[..., 1] > 0.5).long(), x)
        return spatial.like(instance_edges(ids, torch.float64) * x[..., :1], x)

    def iw_pool(x):
        ids = (x[..., 0].detach() * 3).floor().clamp(-2, 2).long() + 2
        return layers.instance_wise_avg_pool(x, ids, 5)

    cases = [
        ("take_rows reflect 3", (1, 16, 3, 2), _take("reflect", 3)),
        ("take_rows replicate 5", (1, 12, 3, 2), _take("replicate", 5)),
        ("take_rows zero 4", (1, 8, 3, 2), _take("zero", 4)),
        ("reflect 7x7 conv + norm + relu", (1, 16, 5, 3), head),
        ("K3 reflect 7x7 conv + norm + relu", (1, 16, 5, 3), khead),
        ("stride-2 3x3 conv + norm", (2, 16, 6, 4), down),
        ("transposed conv + norm", (1, 8, 4, 4), up),
        ("K3 transposed conv + norm", (1, 8, 4, 4), kup),
        ("res block reflect + dropout", (1, 8, 5, 4), _dropout_block("reflect")),
        ("res block replicate + dropout", (1, 8, 5, 4), _dropout_block("replicate")),
        ("res block zero + dropout", (1, 8, 5, 4), _dropout_block("zero")),
        ("K3 res block (residual)", (1, 8, 5, 4), kres),
        ("instance norm", (2, 8, 3, 5), layers.instance_norm),
        ("avg_pool_3s2 of 12 rows", (1, 12, 5, 2), layers.avg_pool_3s2),
        ("avg_pool_3s2 of 16 rows", (1, 16, 6, 2), layers.avg_pool_3s2),
        ("instance-wise pool", (2, 8, 5, 3), iw_pool),
        ("instance edges", (2, 16, 5, 2), semantics),
        ("generator + dropout", (1, 16, 8, 5),
         lambda x: gen(x, deterministic=False, generator=torch.Generator().manual_seed(6))),
        ("generator + stochastic binarizer + dropout", (1, 16, 8, 5),
         lambda x: bgen(x, deterministic=False, generator=torch.Generator().manual_seed(6)),
         False),
        ("encoder", (1, 16, 8, 3), enc),
        ("encoder + binarizer", (1, 16, 8, 3), benc, False),
        ("NLayerDiscriminator 32 rows", (1, 32, 6, 4), d1),
        ("MultiscaleDiscriminator 64 rows", (1, 64, 6, 4),
         lambda x: [f for scale in dms(x) for f in scale]),
        ("VGG19 to relu5_1", (1, 64, 16, 3), vgg),
    ]
    return [c if len(c) == 4 else c + (True,) for c in cases]


def layer_checks(shard: SpatialShard) -> dict:
    """Each layer case's forward error (gathered against the whole) and
    whether gradcheck passed, every rank of the group in lockstep."""
    out = {}
    for i, (name, shape, fn, grad) in enumerate(layer_cases()):
        rng = np.random.default_rng(i)
        x = torch.from_numpy(rng.normal(size=shape))
        want = fn(x)
        got = sharded(fn, shard)(x)
        wants = want if isinstance(want, (list, tuple)) else [want]
        gots = got if isinstance(got, (list, tuple)) else [got]
        err = max(float((g - w).abs().max() / max(w.abs().max(), 1e-30))
                  for g, w in zip(gots, wants))
        torch.manual_seed(0)
        ok = not grad or torch.autograd.gradcheck(
            lambda t: sharded(fn, shard)(t), (x.clone().requires_grad_(),), fast_mode=True,
            raise_exception=False)
        out[name] = {"err": err, "gradcheck": bool(ok),
                     "shapes": [tuple(g.shape) for g in gots] == [tuple(w.shape) for w in wants]}
    return out


def flagship_48(shard: SpatialShard) -> dict:
    """The tiny flagship's standard decode (float64) at H = 48 on this
    rank's rows of the batch as ``shard_batch`` gives them (12 of 48 over
    four ranks), gathered, against one process."""
    cfg = flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    cfg.parallel.spatial_axis = shard.size
    codec = SemanticCodec(cfg, device="cpu", seed=5, dtype=torch.float64).double()
    rng = np.random.default_rng(2)
    batch = {"label": torch.from_numpy(rng.integers(0, 35, (1, 48, 32)).astype(np.float32)),
             "instance": torch.from_numpy(rng.integers(0, 6, (1, 48, 32)).astype(np.int32)),
             "image": torch.from_numpy(rng.uniform(-1, 1, (1, 48, 32, 3)))}
    mine, got_shard = step.shard_batch(DataMesh(shard.index, shard.size, shard.size), cfg,
                                       batch)
    with spatial.sharding(shard):
        got = spatial.gather_rows(codec.decode(codec.prepare(mine))[0], shard)
    want = codec.decode(codec.prepare(batch))[0]
    return {"rows": sorted({(v.shape[1], spatial.global_h(v)) for v in mine.values()}),
            "shard": (got_shard.index, got_shard.size),
            "err": float((got - want).abs().max() / want.abs().max())}


# -- the ranks -----------------------------------------------------------------------
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(port: int, world: int, rank: int) -> None:
    os.environ.update(JPDSE_COORDINATOR=f"localhost:{port}", JPDSE_NUM_PROCESSES=str(world),
                      JPDSE_PROCESS_ID=str(rank))
    assert distributed.initialize(device="cpu") and distributed.world() == world


def rank_main(rank: int, ports: list, work: str) -> None:
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    result = {}
    _join(ports[0], 4, rank)
    # 1. the layers: S = 4, then S = 2 in two groups of two
    groups = distributed.new_groups([range(4), range(2), range(2, 4)])
    result["layers 4"] = layer_checks(SpatialShard(rank, 4, groups[0]))
    result["flagship 48"] = flagship_48(SpatialShard(rank, 4, groups[0]))
    result["layers 2"] = layer_checks(SpatialShard(rank % 2, 2, groups[1 + rank // 2]))
    # 2. data 2 x spatial 2
    for config in CONFIGS:
        for case in CASES:
            cfg = case_config(spec["cfg"], config, 2)
            mesh = mesh_mod.mesh_from_config(cfg.parallel)
            assert (mesh.n_data, mesh.spatial, mesh.data_index) == (2, 2, rank // 2)
            rows = {k: v[mesh.rows(1)] for k, v in spec["batch"].items()}
            result[f"2x2 {config} {case}"] = run_steps(cfg, case, rows, mesh,
                                                       resume=spec["resume"].get((config, case)))
    cfg = case_config(spec["cfg"], "default", 2, pool_dropout=False)
    mesh = mesh_mod.mesh_from_config(cfg.parallel)
    rows = {k: v[mesh.rows(1)] for k, v in spec["jax_batch"].items()}
    result["2x2 jax weights"] = run_steps(cfg, "fp32", rows, mesh, 1, spec["jax_states"])
    dist.destroy_process_group()
    # 3. two worlds of two at spatial 2
    pair, local = rank // 2, rank % 2
    _join(ports[1 + pair], 2, local)
    if pair == 0:
        for case in CASES:
            cfg = case_config(spec["cfg"], "default", 2)
            mesh = mesh_mod.mesh_from_config(cfg.parallel)
            result[f"s2 default {case}"] = run_steps(cfg, case, spec["batch"], mesh,
                                                     resume=spec["resume"].get(("default", case)))
        cfg = case_config(spec["cfg"], "default", 2, pool_dropout=False)
        mesh = mesh_mod.mesh_from_config(cfg.parallel)
        result["jax weights"] = run_steps(cfg, "fp32", spec["jax_batch"], mesh, 1,
                                          spec["jax_states"])
        with redirect_stdout(io.StringIO()) as text:
            result["test.main"] = _test_main(spec, local, "0")
        result["test.main text"] = text.getvalue()
    else:
        for case in CASES:
            cfg = case_config(spec["cfg"], "kernel", 2)
            mesh = mesh_mod.mesh_from_config(cfg.parallel)
            result[f"s2 kernel {case}"] = run_steps(cfg, case, spec["batch"], mesh,
                                                    resume=spec["resume"].get(("kernel", case)))
        from jpdse_tpu_torch.train import run

        with redirect_stdout(io.StringIO()) as text:
            trainer = run.main(spec["train_argv"], device="cpu")
        result["train.run.main"] = {"text": text.getvalue(), "steps": trainer.steps_taken}
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    dist.destroy_process_group()


# -- evaluation ----------------------------------------------------------------------
def write_tree(root: Path, split: str, n: int = 2) -> None:
    from PIL import Image

    rng = np.random.default_rng(5)
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


TINY = ["--ngf", "8", "--nef", "8", "--ne4lf", "8", "--ndf", "8", "--n_downsample_global", "2",
        "--n_blocks_global", "1", "--n_downsample_E", "2", "--n_downsample_E4label", "2",
        "--encoder_binarizer_out_channels", "8", "--label_encoder_binarizer_out_channels", "8",
        "--label_encoder_out_channels", "8", "--no_generator_binarization"]


def _test_main(spec: dict, tag, fast: str = "1") -> dict:
    """``test.main`` of the run, on the fast path (``fast`` '1') or the
    standard path ('0')."""
    from jpdse_tpu_torch import test as port_test

    out = Path(spec["eval_dir"]) / f"out_{tag}"
    argv = ["--load_opt", "--opt_file", spec["opt_file"], "--checkpoints_dir", spec["run"],
            "--save_dir", str(out), "--fast_inference", fast]
    metrics = port_test.main(argv, device="cpu")
    codes = {}
    if (out / "codes").exists():
        codes = {p.name: p.read_bytes() for p in sorted((out / "codes").iterdir())}
    return {"metrics": metrics, "codes": codes}


def eval_setup(work: Path) -> dict:
    """A tiny Cityscapes test split (twice the eval size), a run's opt.json
    at the tiny flagship widths (fp32, 'fixed' to 64x128,
    ``spatial_axis`` 2) and a seeded codec's params_g.pt."""
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.train.checkpoint import save_params

    root, run = work / "cityscapes", work / "run"
    write_tree(root, "test")
    argv = ["--dataset", "cityscapes", "--root_dir", str(root), "--test_preprocess_mode",
            "fixed", "--test_crop_size", str(W), "--test_load_size", str(W), "--normalize_std",
            "1", "--seed", "3", "--num_workers", "1", "--spatial_axis", "2",
            "--save_dir", str(run)] + TINY
    cfg = parse_config(argv, is_train=True)
    run.mkdir(parents=True, exist_ok=True)
    cfg.save(str(run / "opt.json"))
    one = copy.deepcopy(cfg)
    one.parallel.spatial_axis = 1
    save_params(str(run), SemanticCodec(one, device="cpu", seed=4).state_dict())
    return {"opt_file": str(run / "opt.json"), "run": str(run), "eval_dir": str(work)}


def train_argv(work: Path) -> list:
    root = work / "cityscapes"
    for split in ("train", "val"):
        write_tree(root, split)
    pp = []
    for prefix in ("", "val_"):
        pp += [f"--{prefix}preprocess_mode", "fixed", f"--{prefix}load_size", str(W),
               f"--{prefix}crop_size", str(W)]
    return ["--dataset", "cityscapes", "--root_dir", str(root), "--batch_size", "1",
            "--num_workers", "1", "--seed", "0", "--normalize_std", "1", "--remat", "1",
            "--num_epochs", "1", "--val_interval", "1", "--max_recon_dump", "1",
            "--always_save", "--spatial_axis", "2", "--fused_instance_norm", "1",
            "--save_dir", str(work / "train_run")] + TINY + pp


# -- the parent ----------------------------------------------------------------------
def _jax_sharded(weights, n_data: int = 1, n_spatial: int = 2):
    """JAX's phase-2 step on an ``n_data`` x ``n_spatial`` (data x
    spatial) mesh of the virtual CPU devices, at the port state's
    parameters: (metrics, grads_g, grads_d), with the
    test_torch_port_train_step harness's stand-in optimizer and
    deterministic sign."""
    import jax
    import jax.numpy as jnp
    import jpdse_tpu.ops.quantizers as jq
    import jpdse_tpu.train.step as jstep
    from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
    from jpdse_tpu.models.codec import build_discriminator as jax_build_disc
    from jpdse_tpu.models.vgg import Vgg19Features as JaxVgg
    from jpdse_tpu.parallel.mesh import make_mesh, make_sharded_train_step
    from jpdse_tpu.train.state import create_train_state as jax_create_state
    from test_torch_port_train_step import _capture, _det_sign, jax_config

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "stochastic_sign_ste", _det_sign)
        mp.setattr(jstep, "make_optimizers", lambda c: (_capture(), _capture()))
        cfg = jax_config("phase2", False)
        codec, disc, net = JaxCodec(cfg), jax_build_disc(cfg), JaxVgg()
        params_v = weights["v"]
        fn = jstep.make_train_step(cfg, codec, disc,
                                   lambda x: net.apply({"params": params_v}, x), donate=False)
        mesh = make_mesh(n_data, n_spatial, jax.devices()[:n_data * n_spatial])
        sharded_fn = make_sharded_train_step(fn, mesh)
        jstate = jax_create_state(cfg, weights["g"], weights["d"])
        batch = {k: jnp.asarray(v) for k, v in weights["batch"].items()}
        new, metrics = sharded_fn(jstate, batch, jax.random.PRNGKey(0))
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree_util.tree_map(np.asarray, new.opt_state_g["g"]),
                jax.tree_util.tree_map(np.asarray, new.opt_state_d["g"]), None)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results from one spawn, and the parent's: the
    single-process steps, JAX's sharded step, one process's test.main and,
    while the ranks run, JAX's float64 step that arbitrates the sharded
    step's fp32 misses."""
    from test_torch_port_train_step import jax_config, jax_step, port_state, recipe_weights
    from jpdse_tpu_torch.convert import deconv_groups, from_jax_params

    work = tmp_path_factory.mktemp("spatial")
    cfg_dict = jax_config("phase2", False).to_dict()
    weights = recipe_weights("phase2")
    jcfg = Config.from_dict(cfg_dict)
    jax_states = {"g": from_jax_params(weights["g"], deconv_groups(jcfg)),
                  "d": from_jax_params(weights["d"]), "v": from_jax_params(weights["v"])}
    spec = {"cfg": cfg_dict, "batch": global_batch(), "jax_batch": weights["batch"],
            "jax_states": jax_states, "train_argv": train_argv(work / "train")}
    spec.update(eval_setup(work / "eval"))
    # the fp32 steps first: the ranks start their second step from one process's first
    single = {(config, "fp32"): run_steps(case_config(cfg_dict, config), "fp32", spec["batch"],
                                          None) for config in CONFIGS}
    spec["resume"] = {key: [{"snapshot": s["snapshot"], "signs": s["signs"]} for s in v]
                      for key, v in single.items()}
    torch.save(spec, work / "spec.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    ports = [free_port() for _ in range(3)]
    procs = [ctx.Process(target=rank_main, args=(r, ports, str(work))) for r in range(4)]
    for p in procs:
        p.start()
    single.update({(config, "float64"): run_steps(case_config(cfg_dict, config), "float64",
                                                  spec["batch"], None) for config in CONFIGS})
    single["jax weights"] = run_steps(case_config(cfg_dict, "default", pool_dropout=False),
                                      "fp32", spec["jax_batch"], None, 1, jax_states)
    jax_out = {"1x2": _jax_sharded(weights), "2x2": _jax_sharded(weights, 2, 2)}
    one = dict(spec, opt_file=str(work / "eval" / "opt1.json"))
    cfg1 = Config.load(spec["opt_file"])
    cfg1.parallel.spatial_axis = 1
    cfg1.save(one["opt_file"])
    with redirect_stdout(io.StringIO()):
        single["test.main"] = _test_main(one, "single", "0")
    jax64 = jax_step("phase2", False, weights, port_state("phase2", False, weights), x64=True)
    for p in procs:
        p.join(timeout=600)
    assert [p.exitcode for p in procs] == [0, 0, 0, 0], "a rank failed"
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return {"single": single, "ranks": got, "jax": jax_out, "jax64": jax64, "weights": weights}


# -- the checks ----------------------------------------------------------------------
# (a batch norm's own bias is not one: BatchNorm_0.bias trains)
NORMED_BIAS = re.compile(r"(^|\.)(head|down\.\d+|up(\.\d+)?|res\.\d+|layer[1-9]|c7|d1)\."
                         r"(?!.*BatchNorm_0).*bias$")


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
    for k in step.METRICS:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=2 * 2.0**-23,
                                   atol=0, err_msg=k)
    for kind in ("grads", "params"):
        for net_got, net_want in zip(got[kind], want[kind]):
            for n, w in net_want.items():
                if NORMED_BIAS.search(n):
                    assert (net_got[n] - w).abs().max().item() <= F64_TOL, f"{kind} {n}"
                else:
                    assert _rel_l2(net_got[n], w) <= F64_TOL, f"{kind} {n}"


def _h_rows(u: torch.Tensor, index: int, size: int) -> torch.Tensor:
    lo, hi = spatial.bounds(u.shape[1], size)[index:index + 2]
    return u[:, lo:hi]


def _hold(ranks_out: list, single: list, data: int, size: int, case: str) -> None:
    """Each rank's steps against one process's, its draws its batch rows and
    H rows of one process's, the parameters bit-identical across ranks."""
    b = B // data
    for k in range(len(single)):
        for r, got in enumerate(ranks_out):
            d, s = r // size, r % size
            assert len(got[k]["draws"]) == len(single[k]["draws"]) == 2
            for u, want in zip(got[k]["draws"], single[k]["draws"]):
                assert torch.equal(u, _h_rows(want[d * b:(d + 1) * b], s, size))
            (_check_float64 if case == "float64" else _check_fp32)(got[k], single[k])
        for other in ranks_out[1:]:
            for a, c in zip(ranks_out[0][k]["params"], other[k]["params"]):
                assert all(torch.equal(a[n], c[n]) for n in a), f"step {k + 1}: ranks differ"


@pytest.mark.parametrize("size", [4, 2])
def test_every_sharded_layer_matches_the_whole(ranks, size):
    """Each layer on rows, gathered, against the layer on the whole input
    (float64, 1e-12 of its max-abs), and gradcheck of the sharded whole,
    at S = 4 and S = 2, on every rank."""
    for r, res in enumerate(ranks["ranks"]):
        for name, v in res[f"layers {size}"].items():
            assert v["shapes"], f"S={size} rank {r} {name}: shapes"
            assert v["err"] <= LAYER_TOL, f"S={size} rank {r} {name}: {v['err']}"
            assert v["gradcheck"], f"S={size} rank {r} {name}: gradcheck"
    assert len(ranks["ranks"][0][f"layers {size}"]) == len(layer_cases())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("config", CONFIGS)
def test_data_2_x_spatial_2_steps_as_one_process(ranks, config, case):
    _hold([r[f"2x2 {config} {case}"] for r in ranks["ranks"]],
          ranks["single"][(config, case)], 2, 2, case)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("config", CONFIGS)
def test_two_spatial_ranks_step_as_one_process(ranks, config, case):
    pair = ranks["ranks"][:2] if config == "default" else ranks["ranks"][2:]
    _hold([r[f"s2 {config} {case}"] for r in pair], ranks["single"][(config, case)], 1, 2,
          case)


def _matches_jax(ranks: dict, got: dict, mesh: str) -> None:
    """A rank's step at JAX's weights against JAX's sharded step on
    ``mesh``, by ``test_torch_port_train_step.py``'s rule (a miss
    arbitrated by JAX's float64 step)."""
    from test_torch_port_train_step import assert_step_matches, port_state

    weights = ranks["weights"]
    state = port_state("phase2", False, weights)
    names = [[n for n, _ in m.named_parameters()] for m in (state.codec, state.disc)]
    grads = ([got["grads"][0][n] for n in names[0]], [got["grads"][1][n] for n in names[1]])
    metrics = {k: torch.tensor(v) for k, v in got["metrics"].items()}
    assert_step_matches((metrics, grads), ranks["jax"][mesh], (state.codec, state.disc),
                        lambda: ranks["jax64"])


def test_the_sharded_step_matches_jax_sharded_step(ranks):
    """One step of the plain phase-2 recipe at JAX's weights, two spatial
    ranks against JAX's ``make_sharded_train_step`` on a 1 x 2 mesh, and
    against the port's one process."""
    _hold([r["jax weights"] for r in ranks["ranks"][:2]], ranks["single"]["jax weights"], 1, 2,
          "fp32")
    _matches_jax(ranks, ranks["ranks"][0]["jax weights"][0], "1x2")


def test_the_2x2_sharded_step_matches_jax_2x2_mesh(ranks):
    """The same step with the four ranks as data 2 x spatial 2, the layout
    of JAX's ``dryrun_multichip(4)``: against JAX's
    ``make_sharded_train_step`` on ``make_mesh(2, 2, jax.devices()[:4])``
    (every rank's all-reduced gradients), and against the port's one
    process (each rank's uniforms its batch and H rows of one process's,
    the parameters bit-identical across the ranks)."""
    _hold([r["2x2 jax weights"] for r in ranks["ranks"]], ranks["single"]["jax weights"], 2, 2,
          "fp32")
    for res in ranks["ranks"]:
        _matches_jax(ranks, res["2x2 jax weights"][0], "2x2")


def test_sharded_test_main_writes_one_process_codes_and_metrics(ranks):
    """``test.main`` under two spatial ranks on the standard path (the fast
    path's: ``test_torch_port_spatial_paths.py``); on every rank the rates
    equal one process's (the
    Shannon estimate within 1e-6) and the distortions within 1e-3 relative
    (``test_torch_port_eval.py``'s rule: a reconstruction that differs by
    rounding can move a pixel's uint8 level); rank 0's ``_code`` and
    ``.rc`` bytes equal one process's; rank 1 writes none."""
    want = ranks["single"]["test.main"]
    assert want["codes"], "one process wrote no codes"
    for r in (0, 1):
        got = ranks["ranks"][r]["test.main"]
        assert sorted(got["metrics"]) == sorted(want["metrics"])
        for k in ("actual_bpp", "coded_bpp", "total_bpp", "n_images"):
            assert got["metrics"][k] == want["metrics"][k], k
        assert got["metrics"]["shannon_bpp"] == pytest.approx(want["metrics"]["shannon_bpp"],
                                                              rel=1e-6)
        for k in ("L1", "MSE", "PSNR", "MS-SSIM"):
            assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-3), k
        if r == 0:
            assert got["codes"] == want["codes"]
        else:
            assert not got["codes"]
        text = ranks["ranks"][r]["test.main text"]
        assert "fast inference path" not in text and "multi-process mesh: dcn=1 x data=1 x " \
               "spatial=2" in text


def test_spatial_training_entry_point(ranks):
    """``train.run.main`` at spatial 2 in the kernel configuration: both
    ranks take the group's two steps and log the same losses."""
    runs = [r["train.run.main"] for r in ranks["ranks"][2:]]

    def losses(text):
        return [line for line in text.splitlines() if line.startswith("g_gan:")]

    assert [r["steps"] for r in runs] == [2, 2]
    assert len(losses(runs[0]["text"])) == 2 and losses(runs[0]["text"]) == losses(runs[1]["text"])
    assert "spatial=2" in runs[0]["text"]


# -- K3's partial-statistics form, plain ------------------------------------------------
@pytest.mark.parametrize("relu,residual", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("size", [2, 3, 4])
def test_partial_k3_plain_forms_match_the_one_launch_plain_forms(size, relu, residual):
    """A slab split into ``size`` rank slabs (uneven for 3): stats of each,
    stacked in rank order, apply on each, concatenated, against
    ``fused_instance_norm_plain``; sums of each, dx of each, against
    ``fused_instance_norm_bwd_plain``; in fp32 and float64."""
    for dtype, tol in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        gen = torch.Generator().manual_seed(size)
        x = torch.randn((2, 13, 6, 5), generator=gen, dtype=dtype) * 3 + 1
        res = torch.randn(x.shape, generator=gen, dtype=dtype) if residual else None
        g = torch.randn(x.shape, generator=gen, dtype=dtype)
        b = spatial.bounds(x.shape[1], size)
        parts = [x[:, b[s]:b[s + 1]] for s in range(size)]
        stats = torch.stack([k3.instance_norm_stats_plain(p) for p in parts])
        assert stats.shape == (size, 2, 5, 3)
        ys, mss = zip(*(k3.instance_norm_apply_plain(
            p, None if res is None else res[:, b[s]:b[s + 1]], stats, relu)
            for s, p in enumerate(parts)))
        want = k3.fused_instance_norm_plain(x, res, relu)
        assert (torch.cat(ys, 1) - want).abs().max() <= tol * want.abs().max()
        assert all(torch.equal(m, mss[0]) for m in mss)  # every rank merges alike
        sums = torch.stack([k3.instance_norm_bwd_sums_plain(p, g[:, b[s]:b[s + 1]], mss[0], relu)
                            for s, p in enumerate(parts)])
        dx = torch.cat([k3.instance_norm_bwd_dx_plain(p, g[:, b[s]:b[s + 1]], mss[0], sums,
                                                      x.shape[1] * x.shape[2], relu)
                        for s, p in enumerate(parts)], 1)
        want_dx = k3.fused_instance_norm_bwd_plain(x, g, relu, stats=mss[0])
        assert (dx - want_dx).abs().max() <= tol * want_dx.abs().max()


@pytest.mark.parametrize("shape", [(1, 256 * 1024, 64), (2, 32 * 64, 1024), (1, 7, 3),
                                   (3, 1000, 40)])
@pytest.mark.parametrize("vec", [1, 8, 4])
def test_apply_plan_covers_every_value_once(apply_plan_lib, shape, vec):
    """The apply and dx launches' partition (``csrc/part_plan.h``'s
    ``make_apply_plan`` and ``apply_item``, built by the host's compiler):
    each (b, row, channel) in exactly one CTA."""
    b, hw, c = shape
    if c % vec:
        return
    items = apply_items(apply_plan_lib, b, hw, c, vec)
    grid, chunks, rows = apply_plan(apply_plan_lib, b, hw, c, vec)[:3]
    assert len(items) == grid and rows == -(-hw // chunks)
    cover = np.zeros((b, hw, c), np.int64) if b * hw * c <= 2**22 else None
    if cover is None:  # count instead of marking
        total = sum((c1 - c0) * (r1 - r0) for _, c0, c1, r0, r1 in items)
        assert total == b * hw * c
        return
    for bi, c0, c1, r0, r1 in items:
        cover[bi, r0:r1, c0:c1] += 1
    assert (cover == 1).all()


# -- the mesh and the refusals ---------------------------------------------------------
def test_mesh_indices_and_draw_rows():
    """Rank r of S is data index r // S, spatial index r % S; draw_rows
    keeps a rank's batch rows and H rows of one global draw."""
    m = DataMesh(5, 8, 2)
    assert (m.data_index, m.spatial_index, m.n_data) == (2, 1, 4)
    assert m.rows(3) == slice(6, 9) and m.h_rows(64) == slice(32, 64)
    gen = torch.Generator().manual_seed(0)
    whole = torch.rand((8, 64, 3), generator=gen)
    with mesh_mod.drawing(DataMesh(5, 8, 2)), spatial.sharding(SpatialShard(1, 2)):
        got = draw_rows((2, 32, 3), lambda s: torch.rand(s, generator=gen.manual_seed(0)), 64)
        with pytest.raises(spatial.UnknownHeight):  # a rank's rows do not say the height
            draw_rows((2, 32, 3), lambda s: torch.rand(s, generator=gen))
    assert torch.equal(got, whole[4:6, 32:])


def test_uneven_generator_rows_raise_naming_item_13(ranks):
    """An H of 48 over S = 4 at the tiny flagship (whose VGG's relu5_1 has 3
    rows) raised naming item 13 while the sharded layers needed even
    splits; it now shards the batch (12 rows a rank, marked with 48) and
    the standard decode on the rows equals one process's (float64)."""
    for r, res in enumerate(ranks["ranks"]):
        got = res["flagship 48"]
        assert got["shard"] == (r, 4) and got["rows"] == [(12, 48)], got
        assert got["err"] <= LAYER_TOL, f"rank {r}: {got['err']}"
