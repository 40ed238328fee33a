"""The spatial axis at uneven heights on the CPU (gloo): every H that S
divides runs sharded, though the deeper layers' rows split unevenly over
the ranks and a rank may own none, held against the port's own single
process and against JAX's mesh-sharded runs (GSPMD pads what does not
split).

The cases are the heights that raised before this slice, at the tiny
config: the flagship at H = 48 over S = 4 (VGG's relu5_1 has 3 rows, rank
0 owns none), the flagship at H = 40 over S = 2 (VGG's relu4_1 5 rows,
split 2 / 3; the discriminator's 21 and 11) and the LocalEnhancer at
H = 24 over S = 2 (its global trunk's deepest rows 3, split 1 / 2).

One spawn of four gloo processes runs, in turn:

1. every sharded layer at uneven heights, at S = 4 and at S = 2 (two groups
   of two), against the layer on the whole input (float64, 1e-12 of its
   max-abs), with ``torch.autograd.gradcheck`` (fast mode) of the sharded
   whole (``test_torch_port_spatial.py``'s scatter, layer, gather): the
   stride-2 conv, the transposed conv (one of them from a rank without
   rows), the pools (VGG's max pool included), the instance, K3 partial,
   batch and s2d norms on slabs with an empty rank, the semantics, the
   generator with dropout and the binarizer's draws at 20 rows (5 at its
   res blocks: 1 / 1 / 1 / 2), the discriminator and VGG; each case's
   all-reduces counted on every rank (the same count and bytes on every
   rank of a group: the same exchange plans); an unmarked tensor raises;
2. the fast path (``FastCodec``) of the tiny flagship at H = 48 over S = 4
   and of the tiny LocalEnhancer at H = 24 over S = 4 (its global trunk's
   fine rows 12 split 3 / 3 / 3 / 3 and its s2d rows 6 split 1 / 2 / 1 / 2,
   so a rank's s2d rows are not its fine rows) and over S = 2, in float64
   against one process (1e-9 in relative L2, the codes equal);
3. the flagship at H = 48 over S = 4: one float64 ``loss_and_grads`` of the
   phase-2 recipe in the kernel configuration against one process (1e-9),
   and one fp32 step at JAX's weights;
4. two worlds of two at ``spatial_axis`` 2: ranks 0-1 the flagship at
   H = 40 (float64 in the kernel configuration, with dropout, and through
   the fast train decode, against one process; one fp32 step at JAX's
   weights; ``Trainer.compress`` / ``decompress`` on the fast path in
   float64 and ``test.main`` on a split of 36-row images, whose rows at
   1/4 split 4 / 5), ranks 2-3 the
   LocalEnhancer's hires recipe at H = 24 (float64 in the kernel
   configuration against one process; one fp32 step at JAX's weights).

The parent meanwhile runs JAX's ``make_sharded_train_step`` on a 1 x 4 and
a 1 x 2 mesh of the virtual CPU devices, JAX's float64 steps that
arbitrate an fp32 miss (``test_torch_port_train_step.py``'s rule: 1e-4 of
each tensor's max-abs), JAX's ``FastCodec(..., sharded=True)`` and one
process's streams and ``test.main``. Both packages' binarizers take the
deterministic sign (the port's ranks draw and record the uniforms first).

At the tiny depth the training draws (the binarizers' at 1/4, dropout's
at 1/4) fall on even splits; the layer cases draw at uneven heights, and
``test_uneven_draws_are_one_process_rows`` holds a draw of every uneven
split against one process's.
"""

import io
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_port_spatial as sp
import test_torch_port_spatial_paths as spp
from jpdse_tpu_torch.config import Config
from jpdse_tpu_torch.models import layers
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import MultiscaleDiscriminator
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.models.generator import Encoder, GlobalGenerator
from jpdse_tpu_torch.models.vgg import init_vgg19, max_pool_2s2
from jpdse_tpu_torch.ops.s2d import instance_norm_s2d
from jpdse_tpu_torch.ops.semantics import degrade_ids, instance_edges
from jpdse_tpu_torch.parallel import distributed, mesh as mesh_mod, spatial
from jpdse_tpu_torch.parallel.mesh import DataMesh, draw_rows
from jpdse_tpu_torch.parallel.spatial import SpatialShard
from jpdse_tpu_torch.train import step
from test_torch_port_k3_apply_plan import apply_items, apply_plan, apply_plan_lib  # noqa: F401
from test_torch_port_threads import port_test_threads  # noqa: F401

B, W = 2, 32
F64_TOL = 1e-9
LAYER_TOL = 1e-12
# (name, netG, H, S): the heights that raised before this slice
CASES = (("flagship 48 / 4", "global", 48, 4), ("flagship 40 / 2", "global", 40, 2),
         ("local 24 / 2", "local", 24, 2))
TIMEOUT = 900


# -- 1. the layers -------------------------------------------------------------------------
def _bn(x, bn):
    with layers.norm_context(mode=layers.BATCH, world=True):
        return bn(x)


def _fused(relu: bool, residual: bool):
    """K3's partial form (its plain versions on the CPU) at every shard."""
    def fn(x):
        res = spatial.like(torch.tanh(x), x) if residual else None
        return layers._fused_norm(x, relu=relu, residual=res)
    return fn


def _s2d_norm(shift: bool):
    return lambda x: instance_norm_s2d(x, use_shift=shift)


def _ids(x):
    """Ids from the input's sign pattern, so the function is defined on
    rows."""
    return spatial.like((x[..., 0] > 0).long() + (x[..., 1] > 0.5).long(), x)


def _degrade(x):
    ids = degrade_ids(_ids(x), 4)
    return spatial.like(instance_edges(ids, torch.float64) * x[..., :1], x)


def _dropout_gen(gen):
    return lambda x: gen(x, deterministic=False, generator=torch.Generator().manual_seed(6))


def layer_cases():
    """(name, global input shape, the layer as a function of rows, whether
    gradcheck applies), each at a height whose rows (or whose output's)
    split unevenly over 4 and over 2 ranks, several with a rank of none."""
    down = sp._module(lambda: layers.ConvNormAct(4, 6, 3, stride=2, padding=1), 12)
    kdown = sp._module(lambda: layers.ConvNormAct(4, 6, 3, stride=2, padding=1, fused=True), 12)
    up = sp._module(lambda: layers.ConvTransposeNormAct(4, 3), 13)
    kup = sp._module(lambda: layers.ConvTransposeNormAct(4, 3, fused=True), 13)
    kres = sp._module(lambda: layers.ResnetBlock(4, fused=True), 14)
    bn = sp._module(lambda: layers.BatchNorm(3), 15)
    gen = sp._module(lambda: GlobalGenerator(5, 3, ngf=4, n_downsampling=2, n_blocks=1,
                                          use_dropout=True), 7)
    bgen = sp._module(lambda: GlobalGenerator(5, 3, ngf=4, n_downsampling=2, n_blocks=1,
                                           binarize=True, binarizer_out_channels=4,
                                           use_dropout=True), 7)
    kenc = sp._module(lambda: Encoder(3, 3, ngf=4, n_downsampling=2, fused=True), 8)
    dms = sp._module(lambda: MultiscaleDiscriminator(4, ndf=4, n_layers=3, num_D=2), 10)
    vgg = init_vgg19("cpu", torch.Generator().manual_seed(0)).double()
    cases = [
        ("stride-2 conv + norm of 10 rows", (1, 10, 6, 4), down),
        ("stride-2 conv + norm of 6 rows (3 out)", (1, 6, 6, 4), down),
        ("K3 stride-2 conv + norm of 6 rows", (1, 6, 6, 4), kdown),
        ("transposed conv + norm of 5 rows", (1, 5, 4, 4), up),
        ("transposed conv + norm of 3 rows", (1, 3, 4, 4), up),
        ("K3 transposed conv + norm of 3 rows", (1, 3, 4, 4), kup),
        ("K3 res block of 7 rows", (1, 7, 5, 4), kres),
        ("instance norm of 3 rows", (2, 3, 3, 5), layers.instance_norm),
        ("instance norm of 7 rows", (2, 7, 3, 5), layers.instance_norm),
        ("K3 norm + relu of 3 rows", (2, 3, 3, 5), _fused(True, False)),
        ("K3 norm + residual of 5 rows", (2, 5, 3, 5), _fused(False, True)),
        ("batch norm of 3 rows", (2, 3, 4, 3), lambda x: _bn(x, bn)),
        ("s2d norm of 3 rows", (1, 3, 4, 8), _s2d_norm(False)),
        ("s2d norm + shift of 3 rows", (1, 3, 4, 8), _s2d_norm(True)),
        ("s2d norm + shift of 5 rows", (1, 5, 4, 8), _s2d_norm(True)),
        ("avg_pool_3s2 of 7 rows", (1, 7, 5, 2), layers.avg_pool_3s2),
        ("avg_pool_3s2 of 10 rows", (1, 10, 5, 2), layers.avg_pool_3s2),
        ("VGG max pool of 7 rows", (1, 7, 4, 2), max_pool_2s2),
        ("VGG max pool of 10 rows", (1, 10, 4, 2), max_pool_2s2),
        ("instance edges of 7 rows", (2, 7, 5, 2),
         lambda x: spatial.like(instance_edges(_ids(x), torch.float64) * x[..., :1], x)),
        ("semantics at 1/4 of 10 rows", (1, 10, 6, 2), _degrade),
        ("generator + dropout of 20 rows", (1, 20, 8, 5), _dropout_gen(gen)),
        ("generator + stochastic binarizer + dropout of 20 rows", (1, 20, 8, 5),
         _dropout_gen(bgen), False),
        ("K3 encoder of 20 rows", (1, 20, 8, 3), kenc),
        ("MultiscaleDiscriminator of 20 rows", (1, 20, 6, 4),
         lambda x: [f for scale in dms(x) for f in scale]),
        ("VGG19 to relu5_1 of 40 rows", (1, 40, 16, 3), vgg),
    ]
    return [c if len(c) == 4 else c + (True,) for c in cases]


def layer_checks(shard: SpatialShard) -> dict:
    """Each case's forward error (gathered against the whole), whether
    gradcheck passed, and the all-reduces it made on this rank (count and
    bytes), every rank of the group in lockstep."""
    out = {}
    for i, (name, shape, fn, grad) in enumerate(layer_cases()):
        rng = np.random.default_rng(i)
        x = torch.from_numpy(rng.normal(size=shape))
        want = fn(x)
        spatial.traffic.update(calls=0, bytes=0)
        got = sp.sharded(fn, shard)(x)
        traffic = dict(spatial.traffic)
        wants = want if isinstance(want, (list, tuple)) else [want]
        gots = got if isinstance(got, (list, tuple)) else [got]
        err = max(float((g - w).abs().max() / max(w.abs().max(), 1e-30))
                  for g, w in zip(gots, wants))
        torch.manual_seed(0)
        ok = not grad or torch.autograd.gradcheck(
            lambda t: sp.sharded(fn, shard)(t), (x.clone().requires_grad_(),), fast_mode=True,
            raise_exception=False)
        out[name] = {"err": err, "gradcheck": bool(ok), "traffic": traffic,
                     "shapes": [tuple(g.shape) for g in gots] == [tuple(w.shape) for w in wants]}
    x = spatial.like(torch.zeros((1, 3, 4, 2), dtype=torch.float64), torch.zeros(0))
    with spatial.sharding(shard):
        try:
            layers.avg_pool_3s2(x + 1.0)  # an element-wise output nobody marked
            out["unmarked"] = "ran"
        except spatial.UnknownHeight as e:
            out["unmarked"] = str(e)
    return out


# -- 2. the fast path --------------------------------------------------------------------
def case_batch(h: int, compressed: bool = False, seed: int = 11) -> dict:
    """A batch of B images of ``h`` rows (numpy, ``__graft_entry__._batch``'s
    laws), with the base codec's decoded image for the hires recipe."""
    rng = np.random.default_rng(seed)
    batch = {"label": rng.integers(0, 35, (B, h, W)).astype(np.float32),
             "instance": rng.integers(0, 1000, (B, h, W)).astype(np.int32),
             "image": rng.normal(size=(B, h, W, 3)).astype(np.float32)}
    if compressed:
        batch["compressed"] = np.clip(batch["image"] + rng.normal(0, 0.1, batch["image"].shape),
                                      -1, 1).astype(np.float32)
    return batch


def fast_case(codec: str, h: int, shard: SpatialShard) -> dict:
    """The tiny flagship's or LocalEnhancer's fast path in float64 at ``h``
    rows on this rank's rows (``test_torch_port_spatial_paths.fast_calls``),
    against one process: relative L2 of decode and decode_from_codes,
    whether the codes are equal."""
    cfg = spp.fast_config(codec, shard.size)
    state = SemanticCodec(spp.fast_config(codec), device="cpu", seed=5).state_dict()
    fast = FastCodec(cfg, state, device="cpu", dtype=torch.float64)
    batch = {k: torch.from_numpy(v) for k, v in case_batch(h).items()}
    batch["image"] = batch["image"].double()
    want = spp.fast_calls(fast, batch)
    got = spp.fast_calls(fast, batch, shard=shard)
    return {"decode": spp._rel_l2(got["decode"], want["decode"]),
            "from_codes": spp._rel_l2(got["from_codes"], want["from_codes"]),
            "codes": len(got["codes"]) == len(want["codes"]) and all(
                torch.equal(a, b) for a, b in zip(got["codes"], want["codes"])),
            "shape": tuple(got["decode"].shape) == tuple(want["decode"].shape)}


def jax_weight_fast(spec: dict, key: str, shard: SpatialShard) -> dict:
    """The tiny flagship's fast path in fp32 at JAX's weights on this rank's
    rows, gathered: decode, codes and decode_from_codes of JAX's codes."""
    jf = spec["jax_fast"][key]
    fast = FastCodec(spp.fast_config("flagship", shard.size), jf["state"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in jf["batch"].items()}
    got = spp.fast_calls(fast, batch, [torch.from_numpy(c) for c in jf["codes"]], shard)
    return {"decode": got["decode"].numpy(), "codes": [c.numpy() for c in got["codes"]],
            "from_codes": got["from_codes"].numpy()}


# -- 3. the training steps -----------------------------------------------------------------
def step_config(spec: dict, recipe: str, config: str, spatial_axis: int, extra=()) -> Config:
    """The recipe in the default or the kernel configuration (the replay
    pool and dropout where ``extra`` asks)."""
    cfg = sp.case_config(spec["cfgs"][recipe], config, spatial_axis, pool_dropout=False)
    if "pool dropout" in extra:
        cfg.model.pool_size, cfg.model.use_dropout = 2, True
    cfg.validate()
    return cfg


def build_state(cfg: Config, case: str, mesh, h: int, states=None):
    """``test_torch_port_spatial.build_state`` at ``h`` rows: the replay
    pool holds this rank's rows of them."""
    from jpdse_tpu_torch.train.state import create_train_state
    from jpdse_tpu_torch.models.discriminator import build_discriminator

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
    rows = h if mesh is None or mesh.spatial == 1 else len(range(h)[mesh.h_rows(h)])
    return create_train_state(cfg, codec, disc, vgg, (rows, W, cfg.netD_input_nc), mesh)


def one_step(cfg: Config, case: str, batch: dict, mesh, states=None) -> dict:
    """One step's metrics, both players' gradients and the binarizers'
    draws (``test_torch_port_spatial.run_steps``'s record), and the
    all-reduces this rank made over its spatial group."""
    h = batch["image"].shape[1]
    state = build_state(cfg, case, mesh, h, states)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if case == "float64":
        b["image"] = b["image"].double()
    names = ([n for n, _ in state.codec.named_parameters()],
             [n for n, _ in state.disc.named_parameters()])
    draws: list = []
    spatial.traffic.update(calls=0, bytes=0)
    with sp.recorded_sign(draws, []):
        metrics, grads = step.loss_and_grads(state, b, torch.Generator().manual_seed(0))
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "grads": [dict(zip(n, (g.detach().clone() for g in gs)))
                      for n, gs in zip(names, grads)],
            "draws": draws, "traffic": dict(spatial.traffic)}


# the float64 steps: (case, recipe, configuration, extra)
F64_STEPS = {"flagship 48 / 4": [("phase2", "kernel", ())],
             "flagship 40 / 2": [("phase2", "kernel", ()), ("phase2", "default", ("pool dropout",)),
                                 ("fast_train", "default", ())],
             "local 24 / 2": [("hiresA", "kernel", ())]}
# the fp32 step at JAX's weights against JAX's sharded step
JAX_STEPS = {"flagship 48 / 4": "phase2", "flagship 40 / 2": "phase2", "local 24 / 2": "hiresA"}


def case_steps(spec: dict, case: str, s: int) -> dict:
    """The case's float64 steps and its fp32 step at JAX's weights on this
    rank's rows at spatial ``s``."""
    out = {}
    h = dict((c[0], c[2]) for c in CASES)[case]
    for recipe, config, extra in F64_STEPS[case]:
        cfg = step_config(spec, recipe, config, s, extra)
        mesh = mesh_mod.mesh_from_config(cfg.parallel)
        out[("float64", recipe, config, extra)] = one_step(
            cfg, "float64", spec["batches"][(recipe, h)], mesh)
    recipe = JAX_STEPS[case]
    cfg = step_config(spec, recipe, "default", s)
    mesh = mesh_mod.mesh_from_config(cfg.parallel)
    out["jax weights"] = one_step(cfg, "fp32", spec["jax"][case]["batch"], mesh,
                                  spec["jax"][case]["states"])
    return out


# -- 4. the stream methods and test.main ---------------------------------------------------
def eval_setup(work: Path) -> dict:
    """A tiny Cityscapes test split read 'fixed' to 72x36 (36 rows: the
    codes and the generator's deepest rows at 1/4 are 9, split 4 / 5 over
    two ranks), a run's opt.json at the tiny flagship widths (fp32,
    ``spatial_axis`` 2) and a seeded codec's params_g.pt."""
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.train.checkpoint import save_params

    root, run = work / "cityscapes", work / "run"
    sp.write_tree(root, "test")
    argv = ["--dataset", "cityscapes", "--root_dir", str(root), "--test_preprocess_mode",
            "fixed", "--test_crop_size", "72", "--test_load_size", "72", "--normalize_std",
            "1", "--seed", "3", "--num_workers", "1", "--spatial_axis", "2",
            "--save_dir", str(run)] + sp.TINY
    cfg = parse_config(argv, is_train=True)
    run.mkdir(parents=True, exist_ok=True)
    cfg.save(str(run / "opt.json"))
    one = Config.from_dict(cfg.to_dict())
    one.parallel.spatial_axis = 1
    save_params(str(run), SemanticCodec(one, device="cpu", seed=4).state_dict())
    one.save(str(work / "opt1.json"))
    return {"opt_file": str(run / "opt.json"), "opt1": str(work / "opt1.json"),
            "run": str(run), "eval_dir": str(work)}


# -- the ranks -----------------------------------------------------------------------------
def rank_main(rank: int, ports: list, work: str) -> None:
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    result = {}
    sp._join(ports[0], 4, rank)
    groups = distributed.new_groups([range(4), range(2), range(2, 4)])
    four = SpatialShard(rank, 4, groups[0])
    pair = SpatialShard(rank % 2, 2, groups[1 + rank // 2])
    # 1. the layers
    result["layers 4"] = layer_checks(four)
    result["layers 2"] = layer_checks(pair)
    # 2. the fast path
    result["fast flagship 48 / 4"] = fast_case("flagship", 48, four)
    result["fast local 24 / 4"] = fast_case("local", 24, four)
    result["fast local 24 / 2"] = fast_case("local", 24, pair)
    result["fast flagship 40 / 2"] = fast_case("flagship", 40, pair)
    result["jax fast 48 / 4"] = jax_weight_fast(spec, "48 / 4", four)
    result["jax fast 40 / 2"] = jax_weight_fast(spec, "40 / 2", pair)
    # 3. the flagship at 48 over four ranks
    result["steps flagship 48 / 4"] = case_steps(spec, "flagship 48 / 4", 4)
    dist.destroy_process_group()
    # 4. two worlds of two at spatial 2
    sp._join(ports[1 + rank // 2], 2, rank % 2)
    if rank < 2:
        result["steps flagship 40 / 2"] = case_steps(spec, "flagship 40 / 2", 2)
        result["streams"] = spp.streams(spec, spec["opt_file"])
        with redirect_stdout(io.StringIO()) as text:
            result["test.main"] = sp._test_main(spec, rank, "1")
        result["test.main text"] = text.getvalue()
    else:
        result["steps local 24 / 2"] = case_steps(spec, "local 24 / 2", 2)
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    dist.destroy_process_group()


# -- the parent: one process and JAX -------------------------------------------------------
def _mesh(s: int):
    import jax
    from jpdse_tpu.parallel.mesh import make_mesh

    return make_mesh(1, s, jax.devices()[:s])


def jax_fast(h: int, s: int) -> dict:
    """JAX's tiny flagship weights (fp32), a batch of ``h`` rows, and its
    sharded FastCodec's codes, decode and decode_from_codes on a 1 x ``s``
    mesh."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _flagship_cfg
    from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
    from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
    from jpdse_tpu.models.fast_codec import FastCodec as JaxFastCodec
    from jpdse_tpu.parallel.mesh import batch_sharding, replicated, shard_batch_flexible
    from jpdse_tpu_torch.convert import from_jax_params
    from test_torch_port_codec import _jax_params, _jax_presign

    jcfg = _flagship_cfg(tiny=True)
    jcfg.model.compute_dtype = "float32"
    jcodec = JaxCodec(jcfg)
    batch = {k: v for k, v in case_batch(h, seed=1).items()}
    inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"])
    params = _jax_params(jcodec, inputs)
    fast = JaxFastCodec(jcfg, params, dtype=jnp.float32, sharded=True)
    mesh = _mesh(s)
    weights = jax.device_put(fast.weights, replicated(mesh))
    sharded = shard_batch_flexible(batch, mesh, shard_spatial=True)
    assert sharded["image"].sharding.spec[1] == "spatial"
    codes = [np.asarray(c, np.float32) for c in jax.jit(fast.codes_shaped_fn)(weights, sharded)]
    placed = [jax.device_put(c, batch_sharding(mesh, c.ndim, True)) for c in codes]
    return {"state": from_jax_params(params), "batch": batch, "codes": codes,
            "decode": np.asarray(jax.jit(fast.decode_fn)(weights, sharded)),
            "from_codes": np.asarray(jax.jit(fast.decode_from_codes_fn)(weights, placed)),
            "presign": _jax_presign(jcodec, params, inputs)}


def jax_weights(recipe: str, h: int) -> dict:
    """The recipe's JAX weights (``test_torch_port_train_step.recipe_weights``,
    whose convolutions take any height) with a batch of ``h`` rows."""
    from test_torch_port_train_step import recipe_weights

    return dict(recipe_weights(recipe), batch=case_batch(h, recipe == "hiresA", seed=13))


def jax_step(recipe: str, weights: dict, s: int = 1, x64: bool = False):
    """JAX's step of the recipe (default configuration) at ``weights``, on a
    1 x ``s`` (data x spatial) mesh, or in one process in float64 with
    ``x64``: (metrics, grads_g, grads_d, None), with
    ``test_torch_port_train_step.py``'s stand-in optimizer and
    deterministic sign. Compiled for this batch here, never cached across
    batches."""
    import jax
    import jax.numpy as jnp
    import jpdse_tpu.ops.quantizers as jq
    import jpdse_tpu.train.step as jstep
    from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
    from jpdse_tpu.models.codec import build_discriminator as jax_build_disc
    from jpdse_tpu.models.vgg import Vgg19Features as JaxVgg
    from jpdse_tpu.parallel.mesh import make_sharded_train_step
    from jpdse_tpu.train.state import create_train_state as jax_create_state
    from test_torch_port_train_step import _capture, _det_sign, jax_config, jax_precision

    with jax_precision(x64) as ftype, pytest.MonkeyPatch.context() as mp:
        def cast(tree):
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, ftype) if np.asarray(a).dtype.kind == "f" else a, tree)

        mp.setattr(jq, "stochastic_sign_ste", _det_sign)
        mp.setattr(jstep, "make_optimizers", lambda c: (_capture(), _capture()))
        cfg = jax_config(recipe, False)
        codec, disc = JaxCodec(cfg), jax_build_disc(cfg)
        params_v, net = cast(weights["v"]), JaxVgg(dtype=ftype)
        fn = jstep.make_train_step(cfg, codec, disc,
                                   lambda x: net.apply({"params": params_v}, x), donate=False)
        if not x64:
            fn = make_sharded_train_step(fn, _mesh(s))
        jstate = jax_create_state(cfg, cast(weights["g"]), cast(weights["d"]))
        batch = {k: jnp.asarray(v) for k, v in cast(weights["batch"]).items()}
        new, metrics = fn(jstate, batch, jax.random.PRNGKey(0))
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree_util.tree_map(np.asarray, new.opt_state_g["g"]),
                jax.tree_util.tree_map(np.asarray, new.opt_state_d["g"]), None)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results from one spawn, each joined with a timeout;
    the parent's one-process steps, JAX's sharded runs and one process's
    streams and test.main."""
    from jpdse_tpu_torch.convert import deconv_groups, from_jax_params
    from test_torch_port_train_step import jax_config

    work = tmp_path_factory.mktemp("spatial_uneven")
    recipes = {r for steps in F64_STEPS.values() for r, _, _ in steps} | set(JAX_STEPS.values())
    cfgs = {r: jax_config(r, False).to_dict() for r in recipes}
    hs = dict((c[0], c[2]) for c in CASES)
    batches = {(recipe, hs[case]): case_batch(hs[case], recipe == "hiresA")
               for case, steps in F64_STEPS.items() for recipe, _, _ in steps}
    jax_in = {}
    for case, recipe in JAX_STEPS.items():
        weights = jax_weights(recipe, hs[case])
        groups = deconv_groups(Config.from_dict(cfgs[recipe]))
        jax_in[case] = {"batch": weights["batch"], "weights": weights, "states": {
            "g": from_jax_params(weights["g"], groups), "d": from_jax_params(weights["d"]),
            "v": from_jax_params(weights["v"])}}
    spec = {"cfgs": cfgs, "batches": batches, "jax": jax_in,
            "jax_fast": {"48 / 4": jax_fast(48, 4), "40 / 2": jax_fast(40, 2)}}
    spec.update(eval_setup(work / "eval"))
    torch.save(spec, work / "spec.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    ports = [sp.free_port() for _ in range(3)]
    procs = [ctx.Process(target=rank_main, args=(r, ports, str(work))) for r in range(4)]
    for p in procs:
        p.start()
    single = {}
    for case, steps in F64_STEPS.items():
        for recipe, config, extra in steps:
            single[(case, recipe, config, extra)] = one_step(
                step_config(spec, recipe, config, 1, extra), "float64",
                batches[(recipe, hs[case])], None)
    jax_out = {case: jax_step(JAX_STEPS[case], jax_in[case]["weights"], dict(
        (c[0], c[3]) for c in CASES)[case]) for case in JAX_STEPS}
    single["streams"] = spp.streams(spec, spec["opt1"])
    with redirect_stdout(io.StringIO()):
        single["test.main"] = sp._test_main(dict(spec, opt_file=spec["opt1"]), "single", "1")
    for p in procs:
        p.join(timeout=TIMEOUT)
    for p in procs:
        if p.is_alive():  # a hang fails the test instead of taking the suite's time
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0, 0, 0], "a rank failed or hung"
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return {"ranks": got, "single": single, "jax": jax_out, "spec": spec}


# -- the checks ----------------------------------------------------------------------------
def _group(size: int, r: int) -> list:
    """The ranks of rank r's spatial group in the first world (S = 4: all
    four; S = 2: the pair)."""
    return list(range(4)) if size == 4 else [r - r % 2, r - r % 2 + 1]


@pytest.mark.parametrize("size", [4, 2])
def test_every_sharded_layer_matches_the_whole_at_uneven_heights(ranks, size):
    """Each layer on uneven rows (a rank of none among them), gathered,
    against the layer on the whole input (float64, 1e-12 of its max-abs),
    and gradcheck of the sharded whole, on every rank; every rank of a
    group made the same all-reduces (count and bytes: the same exchange
    plans, slot for slot)."""
    res = [r[f"layers {size}"] for r in ranks["ranks"]]
    for r, checks in enumerate(res):
        for name, v in checks.items():
            if name == "unmarked":
                continue
            assert v["shapes"], f"S={size} rank {r} {name}: shapes"
            assert v["err"] <= LAYER_TOL, f"S={size} rank {r} {name}: {v['err']}"
            assert v["gradcheck"], f"S={size} rank {r} {name}: gradcheck"
            for other in _group(size, r):
                assert res[other][name]["traffic"] == v["traffic"], \
                    f"S={size} {name}: ranks {r} and {other} exchanged differently"
    assert len(res[0]) == len(layer_cases()) + 1


@pytest.mark.parametrize("size", [4, 2])
def test_an_unmarked_tensor_raises_on_every_rank(ranks, size):
    """A sharded layer given a tensor that carries no global height raises
    ``UnknownHeight`` on every rank, before any exchange: a rank's own rows
    do not say the height."""
    for r in ranks["ranks"]:
        assert "carries no global height" in r[f"layers {size}"]["unmarked"]


def test_uneven_draws_are_one_process_rows():
    """``draw_rows`` at an uneven split (a rank of none included) keeps
    this rank's rows of one process's draw at the global height; without
    the height a sharded draw raises."""
    for hg, size in ((3, 4), (5, 4), (43, 4), (43, 2), (21, 2), (7, 3)):
        whole = torch.rand((2, hg, 3), generator=torch.Generator().manual_seed(hg))
        for index in range(size):
            shard = SpatialShard(index, size)
            with spatial.sharding(shard):
                got = draw_rows((2, 0, 3), lambda s: torch.rand(
                    s, generator=torch.Generator().manual_seed(hg)), hg)
                with pytest.raises(spatial.UnknownHeight):
                    draw_rows((2, 0, 3), lambda s: torch.rand(s))
            lo, hi = shard.owned(hg)
            assert torch.equal(got, whole[:, lo:hi]) and spatial.global_h(got) == hg
    mesh = DataMesh(3, 4, 2)  # data index 1, spatial index 1, with a data axis
    whole = torch.rand((4, 43, 3), generator=torch.Generator().manual_seed(0))
    with mesh_mod.drawing(mesh), spatial.sharding(SpatialShard(1, 2)):
        got = draw_rows((2, 22, 3), lambda s: torch.rand(
            s, generator=torch.Generator().manual_seed(0)), 43)
    assert torch.equal(got, whole[2:4, 21:])


@pytest.mark.parametrize("key", ["fast flagship 48 / 4", "fast local 24 / 4", "fast local 24 / 2",
                                 "fast flagship 40 / 2"])
def test_sharded_fast_path_matches_one_process_at_uneven_heights(ranks, key):
    """decode, get_codes_shaped and decode_from_codes on the ranks' rows,
    gathered, against one process, float64: 1e-9 in relative L2, the codes
    equal (the LocalEnhancer over four ranks: its global trunk's s2d rows
    are not its fine rows' halves)."""
    for r, res in enumerate(ranks["ranks"]):
        got = res[key]
        assert got["shape"] and got["codes"], f"{key} rank {r}: {got}"
        assert got["decode"] <= F64_TOL and got["from_codes"] <= F64_TOL, f"{key} rank {r}: {got}"


@pytest.mark.parametrize("key", ["48 / 4", "40 / 2"])
def test_sharded_fast_path_matches_jax_sharded_fast_codec(ranks, key):
    """The tiny flagship's fast path in fp32 at JAX's weights on uneven rows
    against JAX's ``FastCodec(..., sharded=True)`` on a 1 x S mesh: images
    within 2e-4, codes equal except where JAX's pre-sign lies within 1e-5
    of 0."""
    jf = ranks["spec"]["jax_fast"][key]
    for r, res in enumerate(ranks["ranks"]):
        got = res[f"jax fast {key}"]
        for a, b, pre in zip(got["codes"], jf["codes"], jf["presign"]):
            differ = a != b
            assert not (differ & (np.abs(np.asarray(pre)) >= spp.NEAR_ZERO)).any(), f"rank {r}"
        for name in ("decode", "from_codes"):
            np.testing.assert_allclose(got[name], jf[name], atol=spp.IMAGE_TOL, rtol=0,
                                       err_msg=f"{key} rank {r} {name}")


def _check_float64(got: dict, want: dict) -> None:
    """``test_torch_port_spatial._check_float64`` on gradients and metrics."""
    sp._check_float64(dict(got, params=[{}, {}]), dict(want, params=[{}, {}]))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_float64_step_at_uneven_heights_matches_one_process(ranks, case):
    """One float64 ``loss_and_grads`` of each recipe of the case (the kernel
    configuration's standard path; at 40 / 2 also the replay pool with
    dropout and the fast train decode) on every rank against one process
    (1e-9), the binarizers' draws each rank's rows of one process's, bit
    for bit, and every rank of the group with the same all-reduces."""
    size = dict((c[0], c[3]) for c in CASES)[case]
    members = {4: [0, 1, 2, 3], 2: [0, 1] if case.startswith("flagship") else [2, 3]}[size]
    for recipe, config, extra in F64_STEPS[case]:
        want = ranks["single"][(case, recipe, config, extra)]
        traffic = None
        for i, r in enumerate(members):
            got = ranks["ranks"][r][f"steps {case}"][("float64", recipe, config, extra)]
            _check_float64(got, want)
            assert len(got["draws"]) == len(want["draws"])
            for u, w in zip(got["draws"], want["draws"]):
                assert torch.equal(u, sp._h_rows(w, i, size)), f"{case} {recipe}: draws"
            traffic = traffic or got["traffic"]
            assert got["traffic"] == traffic and traffic["calls"] > 0, f"{case}: exchanges"


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_the_sharded_step_matches_jax_sharded_step_at_uneven_heights(ranks, case):
    """One fp32 step at JAX's weights on the ranks' uneven rows against
    JAX's ``make_sharded_train_step`` on a 1 x S mesh, by
    ``test_torch_port_train_step.py``'s rule: 1e-4 of each tensor's max-abs,
    a miss held against JAX's float64 step, and where that misses too the
    port's own float64 step against JAX's float64 step (1e-5)."""
    from test_torch_port_train_step import assert_step_matches, port_state, port_step_f64

    recipe = JAX_STEPS[case]
    weights = ranks["spec"]["jax"][case]["weights"]
    r = 2 if case.startswith("local") else 0
    got = ranks["ranks"][r][f"steps {case}"]["jax weights"]
    state = port_state(recipe, False, weights)
    names = [[n for n, _ in m.named_parameters()] for m in (state.codec, state.disc)]
    grads = ([got["grads"][0][n] for n in names[0]], [got["grads"][1][n] for n in names[1]])
    metrics = {k: torch.tensor(v) for k, v in got["metrics"].items()}
    batch = {k: torch.from_numpy(v) for k, v in weights["batch"].items()}
    assert_step_matches((metrics, grads), ranks["jax"][case], (state.codec, state.disc),
                        lambda: jax_step(recipe, weights, x64=True),
                        lambda: port_step_f64(state, batch))


def test_sharded_streams_match_one_process(ranks):
    """``Trainer.compress`` on two ranks' uneven rows (the fast path in
    float64): every rank's streams byte-identical to one process's, and its
    ``decompress`` one process's image."""
    want = ranks["single"]["streams"]
    for r in (0, 1):
        got = ranks["ranks"][r]["streams"]
        assert got["streams"] == want["streams"], f"rank {r}"
        np.testing.assert_array_equal(got["image"], want["image"])
        assert "fast inference path enabled" in got["text"]


def test_sharded_test_main_writes_one_process_codes_and_rates(ranks):
    """``test.main --fast_inference 1`` at spatial 2 on 36-row images: the
    rates one process's, the distortions within 1e-3 relative; rank 0's
    ``.rc`` files byte-identical to one process's, rank 1 writes none."""
    want = ranks["single"]["test.main"]
    assert want["codes"], "one process wrote no codes"
    for r in (0, 1):
        got = ranks["ranks"][r]["test.main"]
        for k in ("actual_bpp", "coded_bpp", "total_bpp", "n_images"):
            assert got["metrics"][k] == want["metrics"][k], k
        assert got["metrics"]["shannon_bpp"] == pytest.approx(want["metrics"]["shannon_bpp"],
                                                              rel=1e-6)
        for k in ("L1", "MSE", "PSNR", "MS-SSIM"):
            assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-3), k
        assert got["codes"] == want["codes"] if r == 0 else not got["codes"]
        assert "spatial=2" in ranks["ranks"][r]["test.main text"]


# -- K3's partial form on uneven and empty slabs, plain --------------------------------------
@pytest.mark.parametrize("relu,residual", [(True, False), (False, True)])
@pytest.mark.parametrize("rows,size", [(3, 4), (5, 4), (7, 3), (2, 4)])
def test_partial_k3_plain_forms_take_uneven_and_empty_slabs(rows, size, relu, residual):
    """A slab of ``rows`` rows split over ``size`` ranks as the spatial axis
    splits it (ranks of none among them): each rank's stats (an empty
    slab's are (0, 0, 0)), merged in rank order to the same statistics on
    every rank, apply on each, against ``fused_instance_norm_plain``; sums
    and dx likewise against its backward; float64."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    gen = torch.Generator().manual_seed(rows * size)
    x = torch.randn((2, rows, 6, 5), generator=gen, dtype=torch.float64) * 3 + 1
    res = torch.randn(x.shape, generator=gen, dtype=torch.float64) if residual else None
    g = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    b = spatial.bounds(rows, size)
    parts = [x[:, b[s]:b[s + 1]] for s in range(size)]
    stats = torch.stack([k3.instance_norm_stats_plain(p) for p in parts])
    for s, p in enumerate(parts):
        if p.shape[1] == 0:
            assert torch.equal(stats[s], torch.zeros_like(stats[s]))
    ys, mss = zip(*(k3.instance_norm_apply_plain(
        p, None if res is None else res[:, b[s]:b[s + 1]], stats, relu)
        for s, p in enumerate(parts)))
    want = k3.fused_instance_norm_plain(x, res, relu)
    assert (torch.cat(ys, 1) - want).abs().max() <= 1e-12 * want.abs().max()
    assert all(torch.equal(m, mss[0]) for m in mss)
    sums = torch.stack([k3.instance_norm_bwd_sums_plain(p, g[:, b[s]:b[s + 1]], mss[0], relu)
                        for s, p in enumerate(parts)])
    dx = torch.cat([k3.instance_norm_bwd_dx_plain(p, g[:, b[s]:b[s + 1]], mss[0], sums,
                                                  rows * x.shape[2], relu)
                    for s, p in enumerate(parts)], 1)
    want_dx = k3.fused_instance_norm_bwd_plain(x, g, relu, stats=mss[0])
    assert (dx - want_dx).abs().max() <= 1e-12 * want_dx.abs().max()


@pytest.mark.parametrize("hw", [0, 1, 7])
def test_k3_plans_take_an_empty_slab(apply_plan_lib, hw):
    """The one-launch plan's mirror (``plan``) and the apply and dx launches'
    partition (``csrc/part_plan.h``'s ``instance_norm_apply_plan``) give an
    empty slab one chunk of no rows, so its launches have a CTA per slab
    (the stats write the (0, 0, 0) part, the apply the merged mean and
    rstd); a slab of rows plans as it did."""
    from jpdse_tpu_torch.ops import instance_norm as k3

    grid, chunks, rows = k3.plan(2, hw, 64, 4, 132)
    assert grid >= 2 and chunks >= 1 and rows >= 1 and (hw == 0 or chunks * rows >= hw)
    items = k3.block_items(2, hw, 64, 4, grid, chunks, rows)
    assert sum(r1 - r0 for its in items for _, c0, c1, r0, r1 in its if c0 == 0) == 2 * hw
    agrid, achunks = apply_plan(apply_plan_lib, 2, hw, 64, 4)[:2]
    assert achunks >= 1 and agrid == 2 * achunks
    assert sum(r1 - r0 for _, _, _, r0, r1 in apply_items(apply_plan_lib, 2, hw, 64, 4)) == 2 * hw
    assert k3.max_chunks(hw, 64, 4) >= 1
