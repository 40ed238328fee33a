"""The spatial axis beyond the standard path on the CPU (gloo): the s2d
fast path, the ``.jpds`` stream methods, the fast train decode and the
LocalEnhancer, each over a spatial group of S ranks, held against the
port's own single process and against JAX's mesh-sharded runs.

One spawn of four gloo processes runs, in turn:

1. the fast path (``FastCodec``) in float64 at S = 4 and at S = 2 (two
   groups of two): ``decode``, ``get_codes_shaped`` and
   ``decode_from_codes`` of the tiny flagship and of the tiny LocalEnhancer
   (``_FastLocalG``), ``norm_shift`` off and on, each rank's rows gathered
   and held against the same call on the whole batch in one process
   (1e-9 in relative L2, the codes equal); then at S = 2 the tiny flagship
   in fp32 at JAX's weights, which the parent holds against JAX's
   ``FastCodec(..., sharded=True)`` jitted on a 1 x 2 mesh of the virtual
   CPU devices (images within 2e-4, codes equal except where the pre-sign
   is within 1e-5 of 0);
2. two worlds of two ranks at ``spatial_axis`` 2. Ranks 0-1 take two steps
   of the phase-2 recipe through the fast train decode (``optim.fast_train``)
   in float64 against one process (every gradient, parameter and metric
   within 1e-9, the binarizers' uniforms each rank's rows of one process's,
   bit for bit), and one fp32 step at JAX's weights, which the parent holds
   against JAX's ``make_sharded_train_step`` with ``fast_train`` on a 1 x 2
   mesh by ``test_torch_port_train_step.py``'s rule; then
   ``Trainer.compress`` / ``decompress`` (the fast path in float64: the
   streams byte-identical to one process's on every rank, the decompressed
   image equal to one process's) and ``test.main`` with ``fast_inference``
   (the fast path taken, no fallback; the ``.rc`` files and the rates one
   process's). Ranks 2-3 take the tiny hires recipe's two steps (a
   LocalEnhancer, its global trunk frozen for the first, unfrozen for the
   second) in the default and the ``fused_instance_norm`` configuration in
   float64 against one process, and an fp32 step of each, frozen and
   unfrozen, at JAX's weights, which the parent holds against JAX's sharded
   step (``freeze_global`` as it is).

Each rank computes its own one-process reference (no collective); the
parent meanwhile runs JAX and the one-process ``Trainer`` and ``test.main``.
Both packages' binarizers take the deterministic sign (the port's ranks
draw and record the uniforms first, as ``test_torch_port_spatial.py``).
"""

import contextlib
import io
import os
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_port_spatial as sp
from jpdse_tpu_torch.config import Config, flagship_config
from jpdse_tpu_torch.models import fast_codec as fast_codec_mod
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.ops import quantizers
from jpdse_tpu_torch.parallel import distributed, mesh as mesh_mod, spatial
from jpdse_tpu_torch.parallel.spatial import SpatialShard
from jpdse_tpu_torch.train import step
from test_torch_port_threads import port_test_threads  # noqa: F401

B, H, W = 2, 64, 128
F64_TOL = 1e-9
IMAGE_TOL = 2e-4
NEAR_ZERO = 1e-5
CODECS = ("flagship", "local")
SHIFTS = (False, True)
FUSED = (False, True)


# -- the configurations ----------------------------------------------------------------
def fast_config(codec: str, spatial_axis: int = 1) -> Config:
    """The tiny flagship (fp32) or the tiny LocalEnhancer over the flagship's
    assembly (ngf 4, one enhancer of one res block)."""
    cfg = flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    if codec == "local":
        m = cfg.model
        m.netG, m.ngf, m.n_local_enhancers, m.n_blocks_local = "local", 4, 1, 1
    cfg.parallel.spatial_axis = spatial_axis
    cfg.validate()
    return cfg


def fast_batch(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"label": torch.from_numpy(rng.integers(0, 35, (B, H, W)).astype(np.float32)),
            "instance": torch.from_numpy(rng.integers(0, 6, (B, H, W)).astype(np.int32)),
            "image": torch.from_numpy(rng.uniform(-1, 1, (B, H, W, 3)))}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.double() - b.double()).norm() / max(b.double().norm().item(), 1e-300)).item()


# -- 1. the fast path ------------------------------------------------------------------
def fast_calls(fast: FastCodec, batch: dict, codes=None, shard=None) -> dict:
    """decode, get_codes_shaped and decode_from_codes (of ``codes``, else of
    the call's own codes) of the whole batch, or under ``shard`` of this
    rank's rows, gathered."""
    if shard is None:
        got = {"decode": fast.decode(batch), "codes": fast.get_codes_shaped(batch)}
        got["from_codes"] = fast.decode_from_codes(got["codes"] if codes is None else codes)
        return got
    mine = {k: shard.rows(v) for k, v in batch.items()}
    with spatial.sharding(shard):
        got = {"decode": spatial.gather_rows(fast.decode(mine), shard),
               "codes": [spatial.gather_rows(c, shard) for c in fast.get_codes_shaped(mine)]}
        feed = got["codes"] if codes is None else codes
        got["from_codes"] = spatial.gather_rows(
            fast.decode_from_codes([shard.rows(c) for c in feed]), shard)
    return got


def fast_checks(shard: SpatialShard) -> dict:
    """Per codec and norm_shift: the relative L2 of the sharded decode and
    decode_from_codes against one process's, float64, and whether the codes
    are equal."""
    out = {}
    batch = fast_batch()
    batch["image"] = batch["image"].double()
    for codec in CODECS:
        for shift in SHIFTS:
            cfg = fast_config(codec, shard.size)
            cfg.model.fast.norm_shift = shift
            state = SemanticCodec(fast_config(codec), device="cpu", seed=5).state_dict()
            fast = FastCodec(cfg, state, device="cpu", dtype=torch.float64)
            want = fast_calls(fast, batch)
            got = fast_calls(fast, batch, shard=shard)
            out[(codec, shift)] = {
                "decode": _rel_l2(got["decode"], want["decode"]),
                "from_codes": _rel_l2(got["from_codes"], want["from_codes"]),
                "codes": len(got["codes"]) == len(want["codes"]) and all(
                    torch.equal(a, b) for a, b in zip(got["codes"], want["codes"])),
                "n_codes": len(want["codes"]),
                "shape": tuple(got["decode"].shape) == tuple(want["decode"].shape)}
    return out


def local_24(shard: SpatialShard) -> dict:
    """The tiny LocalEnhancer's fast path at H = 24, whose global trunk's
    deepest rows (3) split 1 / 2 over a pair (the height that raised before
    the uneven splits ran), on this rank's rows of the batch as
    ``shard_batch`` gives them, against one process (float64)."""
    cfg = fast_config("local", shard.size)
    state = SemanticCodec(fast_config("local"), device="cpu", seed=5).state_dict()
    fast = FastCodec(cfg, state, device="cpu", dtype=torch.float64)
    batch = {k: v[:, :24, :32].contiguous() for k, v in fast_batch().items()}
    mine, got_shard = step.shard_batch(mesh_mod.DataMesh(shard.index, shard.size, shard.size),
                                       cfg, batch)
    with spatial.sharding(shard):
        got = spatial.gather_rows(fast.decode(mine), shard)
    return {"rows": [(tuple(v.shape), spatial.global_h(v)) for v in mine.values()],
            "shard": (got_shard.index, got_shard.size),
            "decode": _rel_l2(got, fast.decode(batch))}


def jax_weight_fast(spec: dict, shard: SpatialShard) -> dict:
    """The tiny flagship's fast path in fp32 at JAX's weights, on this
    rank's rows, gathered: decode, codes and decode_from_codes of JAX's
    sharded codes."""
    cfg = fast_config("flagship", shard.size)
    fast = FastCodec(cfg, spec["jax_fast"]["state"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in spec["jax_fast"]["batch"].items()}
    codes = [torch.from_numpy(c) for c in spec["jax_fast"]["codes"]]
    got = fast_calls(fast, batch, codes, shard)
    return {"decode": got["decode"].numpy(), "codes": [c.numpy() for c in got["codes"]],
            "from_codes": got["from_codes"].numpy()}


# -- 2. the training steps ---------------------------------------------------------------
def run_steps(cfg: Config, case: str, batch: dict, mesh, freeze=(None, None), states=None
              ) -> list:
    """Steps from seeded weights (or ``states``), the LocalEnhancer's
    global trunk frozen (True) or unfrozen (False) before each, or left as
    it is (None): per step the metrics, both players' gradients, the
    parameters after it and the binarizers' draws."""
    state = sp.build_state(cfg, case, mesh, states)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if case == "float64":
        b["image"] = b["image"].double()
    gen = torch.Generator().manual_seed(0)
    names = ([n for n, _ in state.codec.named_parameters()],
             [n for n, _ in state.disc.named_parameters()])
    out = []
    for frozen in freeze:
        if frozen is not None:
            state.codec.netG.global_trunk.requires_grad_(not frozen)
        draws: list = []
        with sp.recorded_sign(draws, []):
            metrics, grads = step.loss_and_grads(state, b, gen)
        step.apply(state, grads)
        out.append({
            "metrics": {k: v.item() for k, v in metrics.items()},
            "grads": [dict(zip(n, (g.detach().clone() for g in gs)))
                      for n, gs in zip(names, grads)],
            "params": [{k: v.detach().clone() for k, v in m.state_dict().items()}
                       for m in (state.codec, state.disc)],
            "draws": draws})
    return out


def step_case(spec: dict, recipe: str, fused: bool, spatial_axis: int) -> Config:
    return sp.case_config(spec["cfgs"][recipe], "kernel" if fused else "default", spatial_axis,
                          pool_dropout=False)


def f64_pair(spec: dict, recipe: str, fused: bool, freeze) -> dict:
    """The recipe's float64 steps on this rank's rows at spatial 2 and, in
    this rank alone, in one process on the whole batch."""
    cfg = step_case(spec, recipe, fused, 2)
    mesh = mesh_mod.mesh_from_config(cfg.parallel)
    got = run_steps(cfg, "float64", spec["batches"][recipe], mesh, freeze)
    want = run_steps(step_case(spec, recipe, fused, 1), "float64", spec["batches"][recipe], None,
                     freeze)
    return {"got": got, "want": want}


def jax_weight_steps(spec: dict, recipe: str, fused: bool, freeze) -> list:
    """One fp32 step at JAX's weights on this rank's rows at spatial 2 for
    each entry of ``freeze``, each from JAX's weights: (metrics, G's and
    D's gradients)."""
    cfg = step_case(spec, recipe, fused, 2)
    mesh = mesh_mod.mesh_from_config(cfg.parallel)
    return [run_steps(cfg, "fp32", spec["jax_steps"][recipe]["batch"], mesh, (frozen,),
                      spec["jax_steps"][recipe]["states"])[0] for frozen in freeze]


# -- 2. the stream methods and test.main -------------------------------------------------
@contextlib.contextmanager
def float64_fast_path():
    """The fast path's compute type float64 (the serving Trainer's
    ``FastCodec``), so that a stream's code bits rest on no rounding."""
    saved = fast_codec_mod.compute_dtype
    fast_codec_mod.compute_dtype = lambda cfg: torch.float64
    try:
        yield
    finally:
        fast_codec_mod.compute_dtype = saved


def streams(spec: dict, opt_file: str) -> dict:
    """``Trainer.compress`` of the split's first batch and ``decompress`` of
    its first stream, through the fast path in float64."""
    from jpdse_tpu_torch.cli import parse_config
    from jpdse_tpu_torch.config import derive_eval_config
    from jpdse_tpu_torch.data import create_dataloader
    from jpdse_tpu_torch.trainer import Trainer

    argv = ["--load_opt", "--opt_file", opt_file, "--checkpoints_dir", spec["run"],
            "--fast_inference", "1"]
    with float64_fast_path(), redirect_stdout(io.StringIO()) as text:
        cfg = derive_eval_config(parse_config(argv, is_train=False), mode="test")
        trainer = Trainer(cfg, mode="test", device="cpu")
        trainer.load()
        batch = next(iter(create_dataloader(cfg)))
        data = trainer.compress(batch)
        image = trainer.decompress(data[0])
    return {"streams": data, "image": image, "text": text.getvalue()}


# -- the ranks ---------------------------------------------------------------------------
def rank_main(rank: int, ports: list, work: str) -> None:
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    result = {}
    sp._join(ports[0], 4, rank)
    # 1. the fast path: S = 4, then S = 2 in two groups of two
    groups = distributed.new_groups([range(4), range(2), range(2, 4)])
    result["fast 4"] = fast_checks(SpatialShard(rank, 4, groups[0]))
    pair = SpatialShard(rank % 2, 2, groups[1 + rank // 2])
    result["fast 2"] = fast_checks(pair)
    result["local 24"] = local_24(pair)
    result["jax weights fast"] = jax_weight_fast(spec, pair)
    dist.destroy_process_group()
    # 2. two worlds of two at spatial 2
    sp._join(ports[1 + rank // 2], 2, rank % 2)
    if rank < 2:
        result["fast_train f64"] = f64_pair(spec, "fast_train", False, (None, None))
        result["fast_train jax"] = jax_weight_steps(spec, "fast_train", False, (None,))
        result["streams"] = streams(spec, spec["opt_file"])
        with redirect_stdout(io.StringIO()) as text:
            result["test.main"] = sp._test_main(spec, rank, "1")
        result["test.main text"] = text.getvalue()
    else:
        for fused in FUSED:
            result[f"hires f64 {fused}"] = f64_pair(spec, "hiresA", fused, (True, False))
            result[f"hires jax {fused}"] = jax_weight_steps(spec, "hiresA", fused,
                                                            (True, False))
    torch.save(result, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    dist.destroy_process_group()


# -- the parent: JAX's sharded runs --------------------------------------------------------
def _mesh_1x2():
    import jax
    from jpdse_tpu.parallel.mesh import make_mesh

    return make_mesh(1, 2, jax.devices()[:2])


def jax_fast_setup() -> dict:
    """JAX's tiny flagship weights (fp32) and batch, and its sharded
    FastCodec's decode, codes and decode_from_codes on a 1 x 2 mesh."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _batch, _flagship_cfg
    from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
    from jpdse_tpu.models.codec import prepare_inputs as jax_prepare_inputs
    from jpdse_tpu.models.fast_codec import FastCodec as JaxFastCodec
    from jpdse_tpu.parallel.mesh import batch_sharding, replicated, shard_batch_flexible
    from jpdse_tpu_torch.convert import from_jax_params
    from test_torch_port_codec import _jax_params, _jax_presign

    jcfg = _flagship_cfg(tiny=True)
    jcfg.model.compute_dtype = "float32"
    jcodec = JaxCodec(jcfg)
    batch = {k: np.array(v) for k, v in _batch(jcfg, B, H, W, np.random.default_rng(1)).items()}
    inputs = jax_prepare_inputs(jcfg, batch["label"], batch["instance"], batch["image"])
    params = _jax_params(jcodec, inputs)
    fast = JaxFastCodec(jcfg, params, dtype=jnp.float32, sharded=True)
    mesh = _mesh_1x2()
    weights = jax.device_put(fast.weights, replicated(mesh))
    sharded = shard_batch_flexible(batch, mesh, shard_spatial=True)
    assert sharded["image"].sharding.spec[1] == "spatial"
    codes = [np.asarray(c, np.float32) for c in jax.jit(fast.codes_shaped_fn)(weights, sharded)]
    placed = [jax.device_put(c, batch_sharding(mesh, c.ndim, True)) for c in codes]
    return {"state": from_jax_params(params), "batch": batch, "codes": codes,
            "decode": np.asarray(jax.jit(fast.decode_fn)(weights, sharded)),
            "from_codes": np.asarray(jax.jit(fast.decode_from_codes_fn)(weights, placed)),
            "presign": _jax_presign(jcodec, params, inputs)}


def jax_sharded_step(recipe: str, fused: bool, weights: dict, frozen: bool):
    """JAX's step of the recipe at its weights on a 1 x 2 (data x spatial)
    mesh, the global trunk frozen as ``frozen`` says: (metrics, grads_g,
    grads_d, None), with the stand-in optimizer and the deterministic sign
    of ``test_torch_port_train_step.py``."""
    import jax
    import jax.numpy as jnp
    import jpdse_tpu.models.fast_train as jft
    import jpdse_tpu.ops.quantizers as jq
    import jpdse_tpu.train.step as jstep
    from jpdse_tpu.models.codec import SemanticCodec as JaxCodec
    from jpdse_tpu.models.codec import build_discriminator as jax_build_disc
    from jpdse_tpu.models.vgg import Vgg19Features as JaxVgg
    from jpdse_tpu.parallel.mesh import make_sharded_train_step
    from jpdse_tpu.train.state import create_train_state as jax_create_state
    from test_torch_port_train_step import _capture, _det_sign, jax_config

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jq, "stochastic_sign_ste", _det_sign)
        mp.setattr(jft, "stochastic_sign_ste", lambda x, key: jft.deterministic_sign_ste(x))
        mp.setattr(jstep, "make_optimizers", lambda c: (_capture(), _capture()))
        cfg = jax_config(recipe, fused)
        codec, disc, net = JaxCodec(cfg), jax_build_disc(cfg), JaxVgg()
        params_v = weights["v"]
        fn = jstep.make_train_step(cfg, codec, disc,
                                   lambda x: net.apply({"params": params_v}, x), donate=False,
                                   freeze_global=frozen)
        sharded_fn = make_sharded_train_step(fn, _mesh_1x2())
        jstate = jax_create_state(cfg, weights["g"], weights["d"])
        batch = {k: jnp.asarray(v) for k, v in weights["batch"].items()}
        new, metrics = sharded_fn(jstate, batch, jax.random.PRNGKey(0))
        return ({k: float(v) for k, v in metrics.items()},
                jax.tree_util.tree_map(np.asarray, new.opt_state_g["g"]),
                jax.tree_util.tree_map(np.asarray, new.opt_state_d["g"]), None)


def jax_step_setup() -> tuple:
    """The recipes' configurations and batches for the ranks, JAX's
    weights carried into the port, and JAX's sharded steps at them."""
    from jpdse_tpu_torch.convert import deconv_groups, from_jax_params
    from test_torch_port_train_step import jax_config, recipe_weights

    cfgs, batches, jax_steps = {}, {}, {}
    for recipe in ("fast_train", "hiresA"):
        cfgs[recipe] = jax_config(recipe, False).to_dict()
        weights = recipe_weights(recipe)
        batches[recipe] = weights["batch"]
        groups = deconv_groups(Config.from_dict(cfgs[recipe]))
        jax_steps[recipe] = {"batch": weights["batch"], "states": {
            "g": from_jax_params(weights["g"], groups), "d": from_jax_params(weights["d"]),
            "v": from_jax_params(weights["v"])}}
    return cfgs, batches, jax_steps


def jax_steps_out() -> dict:
    from test_torch_port_train_step import recipe_weights

    out = {("fast_train", False, None): jax_sharded_step(
        "fast_train", False, recipe_weights("fast_train"), False)}
    for fused in FUSED:
        for frozen in (True, False):
            out[("hiresA", fused, frozen)] = jax_sharded_step(
                "hiresA", fused, recipe_weights("hiresA"), frozen)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results from one spawn; the parent's JAX runs and
    one process's streams and test.main."""
    work = tmp_path_factory.mktemp("spatial_paths")
    cfgs, batches, jax_steps = jax_step_setup()
    spec = {"cfgs": cfgs, "batches": batches, "jax_steps": jax_steps,
            "jax_fast": jax_fast_setup()}
    spec.update(sp.eval_setup(work / "eval"))
    torch.save(spec, work / "spec.pt")
    ctx = torch.multiprocessing.get_context("spawn")
    ports = [sp.free_port() for _ in range(3)]
    procs = [ctx.Process(target=rank_main, args=(r, ports, str(work))) for r in range(4)]
    for p in procs:
        p.start()
    jax_out = jax_steps_out()
    one = dict(spec, opt_file=str(work / "eval" / "opt1.json"))
    cfg1 = Config.load(spec["opt_file"])
    cfg1.parallel.spatial_axis = 1
    cfg1.save(one["opt_file"])
    single = {"streams": streams(spec, one["opt_file"])}
    with redirect_stdout(io.StringIO()):
        single["test.main"] = sp._test_main(one, "single", "1")
    for p in procs:
        p.join(timeout=600)
    assert [p.exitcode for p in procs] == [0, 0, 0, 0], "a rank failed"
    got = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return {"ranks": got, "jax": jax_out, "single": single, "spec": spec}


# -- (a) the sharded fast path against one process ------------------------------------------
@pytest.mark.parametrize("shift", SHIFTS, ids=["no_shift", "norm_shift"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("size", [4, 2])
def test_sharded_fast_path_matches_one_process(ranks, size, codec, shift):
    """decode, get_codes_shaped and decode_from_codes on S ranks' rows,
    gathered, against one process, float64: within 1e-9 in relative L2,
    the encoders' two codes equal, on every rank."""
    for r, res in enumerate(ranks["ranks"]):
        v = res[f"fast {size}"][(codec, shift)]
        assert v["shape"], f"rank {r}"
        assert v["decode"] <= F64_TOL and v["from_codes"] <= F64_TOL, f"rank {r}: {v}"
        assert v["codes"] and v["n_codes"] == 2, f"rank {r}"


# -- (b) against JAX's sharded FastCodec ---------------------------------------------------------
def test_sharded_fast_path_matches_jax_sharded_fast_codec(ranks):
    """Two ranks' fast path in fp32 at JAX's weights against JAX's
    ``FastCodec(cfg, params, sharded=True)`` on a 1 x 2 mesh: the images
    (decode, and decode_from_codes of JAX's codes) within 2e-4, the codes
    equal except where the pre-sign is within 1e-5 of 0."""
    from test_torch_port_codec import assert_codes_match

    want = ranks["spec"]["jax_fast"]
    for r, res in enumerate(ranks["ranks"]):
        got = res["jax weights fast"]
        for key in ("decode", "from_codes"):
            err = np.abs(got[key] - want[key]).max()
            assert got[key].shape == want[key].shape and err <= IMAGE_TOL, f"rank {r} {key}: {err}"
        assert len(got["codes"]) == len(want["codes"]) == 2
        for i, (a, b, p) in enumerate(zip(got["codes"], want["codes"], want["presign"])):
            assert_codes_match(a, b, p, f"rank {r} code {i}")


# -- (c) fast train -----------------------------------------------------------------------------
def _hold_f64(pair: list, draws: bool) -> None:
    """Each rank's float64 steps against its one process's, the draws its H
    rows of one process's, the parameters bit-identical across the ranks."""
    for k in range(len(pair[0]["want"])):
        for r, res in enumerate(pair):
            got, want = res["got"][k], res["want"][k]
            sp._check_float64(got, want)
            assert len(got["draws"]) == len(want["draws"]) == (2 if draws else 0)
            for u, w in zip(got["draws"], want["draws"]):
                assert torch.equal(u, sp._h_rows(w, r, 2)), f"rank {r} step {k + 1}: draws"
        for a, c in zip(pair[0]["got"][k]["params"], pair[1]["got"][k]["params"]):
            assert all(torch.equal(a[n], c[n]) for n in a), f"step {k + 1}: ranks differ"


def _hold_jax(pair: list, want: tuple, recipe: str, fused: bool, frozen) -> None:
    """Two ranks' fp32 step at JAX's weights: the metrics and gradients
    (reduced over the group) bit-equal across the ranks, and rank 0's
    against JAX's sharded step by
    ``test_torch_port_train_step.py``'s rule for its fp32-limited recipes:
    a miss arbitrated by JAX's float64 step, and where that misses, the
    port's own float64 step against JAX's float64 step in every tensor.
    Both recipes are fp32-limited here: the fast train decode's binarizer
    input, and the hires recipe's discriminator, whose leaky ReLUs take a
    pre-activation within fp32 rounding of the kink on either side (JAX's
    own unsharded fp32 step and the ranks' can land on the other side from
    JAX's float64 step)."""
    from test_torch_port_train_step import assert_step_matches, jax_step, port_state, \
        port_step_f64, recipe_weights

    got = pair[0]
    assert pair[1]["metrics"] == got["metrics"]
    for a, b in zip(got["grads"], pair[1]["grads"]):
        assert all(torch.equal(a[n], b[n]) for n in a)
    weights = recipe_weights(recipe)
    state = port_state(recipe, fused, weights)
    if frozen:
        state.codec.netG.global_trunk.requires_grad_(False)
    names = [[n for n, _ in m.named_parameters()] for m in (state.codec, state.disc)]
    grads = ([got["grads"][0][n] for n in names[0]], [got["grads"][1][n] for n in names[1]])
    metrics = {k: torch.tensor(v) for k, v in got["metrics"].items()}
    batch = {k: torch.from_numpy(v) for k, v in weights["batch"].items()}
    assert_step_matches(
        (metrics, grads), want, (state.codec, state.disc),
        lambda: jax_step(recipe, fused, weights, state, x64=True, freeze_global=bool(frozen)),
        lambda: port_step_f64(state, batch))


def test_fast_train_two_steps_at_spatial_2_match_one_process(ranks):
    _hold_f64([r["fast_train f64"] for r in ranks["ranks"][:2]], draws=True)


def test_fast_train_step_matches_jax_sharded_step(ranks, monkeypatch):
    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    _hold_jax([r["fast_train jax"][0] for r in ranks["ranks"][:2]],
              ranks["jax"][("fast_train", False, None)], "fast_train", False, None)


# -- (d) the LocalEnhancer ---------------------------------------------------------------
@pytest.mark.parametrize("fused", FUSED, ids=["default", "fused_instance_norm"])
def test_local_enhancer_frozen_then_unfrozen_at_spatial_2_match_one_process(ranks, fused):
    pair = [r[f"hires f64 {fused}"] for r in ranks["ranks"][2:]]
    _hold_f64(pair, draws=False)
    frozen = pair[0]["got"][0]["grads"][0]
    assert all(g.abs().max() == 0 for n, g in frozen.items() if n.startswith("netG.global."))


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen", "unfrozen"])
@pytest.mark.parametrize("fused", FUSED, ids=["default", "fused_instance_norm"])
def test_local_enhancer_step_matches_jax_sharded_step(ranks, fused, frozen):
    i = 0 if frozen else 1
    _hold_jax([r[f"hires jax {fused}"][i] for r in ranks["ranks"][2:]],
              ranks["jax"][("hiresA", fused, frozen)], "hiresA", fused, frozen)


# -- (e) the stream methods --------------------------------------------------------------
def test_sharded_compress_gives_one_process_streams(ranks):
    """Trainer.compress at spatial 2 through the fast path: on every rank the
    bytes of one process's streams; decompress (each rank decodes the whole
    image) equal to one process's; both ranks printed the fast path."""
    want = ranks["single"]["streams"]
    assert want["streams"] and "fast inference path enabled" in want["text"]
    for r in ranks["ranks"][:2]:
        got = r["streams"]
        assert got["streams"] == want["streams"]
        assert np.array_equal(got["image"], want["image"])
        assert "fast inference path enabled" in got["text"] and "spatial=2" in got["text"]


# -- (f) test.main ---------------------------------------------------------------------
def test_sharded_test_main_takes_the_fast_path(ranks):
    """``test.main --fast_inference 1`` at spatial 2: the fast path, no
    fallback; the rates one process's (the Shannon estimate within 1e-6),
    the distortions within 1e-3 relative; rank 0's ``.rc`` files one
    process's, rank 1 writes none."""
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
        text = ranks["ranks"][r]["test.main text"]
        assert "fast inference path enabled" in text and "using the standard path" not in text
        assert "spatial=2" in text


# -- what raises, in one process ---------------------------------------------------------------
@pytest.mark.parametrize("switch", ["head_pallas=1", "head_pallas=force", "front_realign=pallas",
                                    "fused_realign=pallas"])
def test_a_forced_kernel_on_a_shard_raises(switch):
    """A switch that forces K1, K2 or K4 raises ValueError on a rank's rows,
    at the stage that would launch it (before any exchange), from
    ``check_fast_parallel``, and from the Trainer's fast path instead of
    falling back; 'auto' takes the compositions (the test above)."""
    from jpdse_tpu_torch.config import check_fast_parallel
    from jpdse_tpu_torch.trainer import Trainer

    name, value = switch.split("=")
    cfg = fast_config("flagship")
    setattr(cfg.model.fast, name, value)
    fast = FastCodec(cfg, SemanticCodec(fast_config("flagship"), device="cpu", seed=5)
                     .state_dict(), device="cpu")
    trunk = fast.netE4label
    stage = trunk.back if name == "fused_realign" else trunk.front
    with spatial.sharding(SpatialShard(0, 2)), pytest.raises(ValueError, match=f"{name}="):
        stage(trunk.weights, torch.zeros((1, 8, 16, 4)))
    check_fast_parallel(cfg)  # one process: the kernels run
    cfg.parallel.spatial_axis = 2
    with pytest.raises(ValueError, match=f"spatial_axis 2: {name}="):
        check_fast_parallel(cfg)
    cfg.model.fast_inference = True
    trainer = Trainer.__new__(Trainer)
    trainer.cfg, trainer._fast_built = cfg, False
    with pytest.raises(ValueError, match="take a whole tensor"):
        trainer._fast


def test_local_enhancer_rows_that_the_pyramid_cannot_split_raise(ranks):
    """The LocalEnhancer's global trunk runs on the input pooled
    n_local_enhancers times: an H that splits for a global netG of the same
    depth but not for the pyramid (24 over 2: 3 rows at the trunk's bottom)
    raised naming item 13; it now shards the batch (12 rows a rank, marked
    with 24) and the fast path's decode on the rows equals one process's."""
    for r, res in enumerate(ranks["ranks"]):
        got = res["local 24"]
        assert got["shard"] == (r % 2, 2), r
        assert all(shape[1] == 12 and hg == 24 for shape, hg in got["rows"]), got["rows"]
        assert got["decode"] <= F64_TOL, f"rank {r}: {got['decode']}"
