"""The seg-trained VGG's trainer in the port (``train/seg_vgg.py``) against
the JAX package's ``tools/train_seg_vgg.py`` on the CPU: one step of the
port's ``SegVgg`` and of JAX's from equal parameters (``from_jax_params``)
on equal crops (the draws given): the loss within 1e-5 relative, each
gradient within 1e-4 of its max-abs of JAX's (where JAX's fp32 step misses,
JAX's step in float64 arbitrates), and Adam's update of those gradients
within 1e-7 of optax's; a few steps on a learnable target lower the loss;
the crops gathered on the device equal JAX's slice and flip; the trunk's
``.npz`` crosses between the packages bit for bit both ways; ``load_split``
equals JAX's; the committed ``artifacts/seg_vgg/vgg19_seg.npz`` gives the
same features in both packages' ``Vgg19Features`` (1e-4 of each slice's
max-abs); ``main`` trains, scores and writes JAX's files on a synthetic
split."""

import functools
import importlib.util
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from jpdse_tpu.models.vgg import Vgg19Features as JaxVgg19Features
from jpdse_tpu.models.vgg import init_vgg19 as jax_init_vgg19
from jpdse_tpu_torch.convert import from_jax_params, to_jax_params
from jpdse_tpu_torch.models.vgg import init_vgg19
from jpdse_tpu_torch.train import seg_vgg
from test_torch_port_threads import port_test_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LOSS_REL = 1e-5
GRAD_TOL = 1e-4  # of each gradient tensor's max-abs
FP32_LIMIT = 1e-2  # an fp32-limited gradient against JAX's float64 step
F64_TOL = 1e-5  # the port's float64 step against JAX's
ADAM_TOL = 1e-7
N_LABELS = 7
CROP = 32


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("train_seg_vgg",
                                                  REPO / "tools" / "train_seg_vgg.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["train_seg_vgg"] = mod
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_loss_and_grads(tool, params, xb, yb, x64=False):
    """The tool's loss_fn and its gradients (``main``'s), in fp32 or, with
    ``x64``, with the trunk and heads in float64."""
    with jax.enable_x64(x64), pytest.MonkeyPatch.context() as mp:
        if x64:
            mp.setattr(tool, "Vgg19Features",
                       functools.partial(JaxVgg19Features, dtype=jnp.float64))
            params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        model = tool.SegVgg(num_labels=N_LABELS)
        xb = jnp.asarray(xb, jnp.float64 if x64 else jnp.float32)
        yb = jnp.asarray(yb)

        def loss_fn(p):
            _, logits = model.apply({"params": p}, xb)
            loss = 0.0
            for lg in logits:
                f = yb.shape[1] // lg.shape[1]
                loss = loss + optax.softmax_cross_entropy_with_integer_labels(
                    lg, yb[:, ::f, ::f]).mean()
            return loss / len(logits)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        return float(loss), _flat(jax.device_get(grads))


def _split(rng, n=2, h=96, w=128):
    imgs = (rng.random((n, h, w, 3), np.float32) - 0.5).astype(np.float32)
    # labels smooth enough to be learnable: 16x16 blocks of N_LABELS classes
    blocks = rng.integers(0, N_LABELS, (n, h // 16, w // 16))
    labs = np.kron(blocks, np.ones((1, 16, 16), np.int64)).astype(np.int32)
    return imgs, labs


def _numpy_crops(imgs, labs, idx, y0, x0, flip, crop):
    """The tool's crop_one and flip (jax.lax.dynamic_slice, then [:, :, ::-1])."""
    xs, ys = [], []
    for i, y, x, f in zip(idx, y0, x0, flip):
        xb, yb = imgs[i, y:y + crop, x:x + crop], labs[i, y:y + crop, x:x + crop]
        xs.append(xb[:, ::-1] if f else xb)
        ys.append(yb[:, ::-1] if f else yb)
    return np.stack(xs), np.stack(ys)


@pytest.fixture(scope="module")
def step_inputs(tool):
    rng = np.random.default_rng(4)
    imgs, labs = _split(rng)
    idx, y0, x0, flip = (np.array([1, 0]), np.array([7, 64]), np.array([0, 96]),
                         np.array([True, False]))
    xb, yb = _numpy_crops(imgs, labs, idx, y0, x0, flip, CROP)
    model = tool.SegVgg(num_labels=N_LABELS)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(xb))["params"])
    draws = tuple(torch.from_numpy(np.asarray(a)) for a in (idx, y0, x0, flip))
    return {"imgs": imgs, "labs": labs, "draws": draws, "xb": xb, "yb": yb, "params": params}


def _port_model(params):
    model = seg_vgg.SegVgg(N_LABELS)
    model.load_state_dict(from_jax_params(params))
    return model


def test_crops_gathered_as_jax_slices_and_flips(step_inputs):
    xb, yb = seg_vgg.gather_crops(torch.from_numpy(step_inputs["imgs"]),
                                  torch.from_numpy(step_inputs["labs"]),
                                  *step_inputs["draws"], CROP)
    assert yb.dtype == torch.int64
    np.testing.assert_array_equal(xb.numpy(), step_inputs["xb"])
    np.testing.assert_array_equal(yb.numpy(), step_inputs["yb"])


def test_crop_draws_in_range_and_seeded():
    def draws(seed):
        return seg_vgg.draw_crops(torch.Generator().manual_seed(seed), 3, 96, 128, 64, 50)

    idx, y0, x0, flip = draws(1)
    assert idx.min() >= 0 and idx.max() <= 2 and len(set(idx.tolist())) == 3
    assert y0.min() >= 0 and y0.max() <= 32 and x0.min() >= 0 and x0.max() <= 64
    assert 0 < int(flip.sum()) < 50
    assert all(torch.equal(a, b) for a, b in zip(draws(1), draws(1)))
    assert not all(torch.equal(a, b) for a, b in zip(draws(1), draws(2)))


def test_segvgg_tree_round_trips_through_the_bridge(step_inputs):
    params = step_inputs["params"]
    state = from_jax_params(params)
    assert state["seg_head2.weight"].shape == (N_LABELS, 256, 1, 1)
    assert state["trunk.conv5_1.weight"].shape == (512, 512, 3, 3)
    model = _port_model(params)
    assert set(model.state_dict()) == set(state)
    back = _flat(to_jax_params(model.state_dict()))
    want = _flat(params)
    assert set(back) == set(want)
    for k in want:
        assert back[k].dtype == np.float32 and np.array_equal(back[k], want[k]), k


def _port_grads(params, xb, yb, dtype=torch.float32):
    model = _port_model(params).to(dtype)
    loss = seg_vgg.loss_and_grads(model, torch.from_numpy(xb).to(dtype), torch.from_numpy(yb))
    return model, float(loss), _flat(to_jax_params(
        {k: p.grad.double() if dtype == torch.float64 else p.grad
         for k, p in model.named_parameters()}))


def test_one_step_matches_jax(tool, step_inputs):
    """Where a gradient misses JAX's fp32 step, JAX's float64 step
    arbitrates; where it misses that too, the port's own float64 step must
    match JAX's float64 step within 1e-5 (the train-step tests' rule for an
    fp32-limited step) and the fp32 one stay within FP32_LIMIT. Here that
    is the first two stages' kernels and biases: PyTorch's fp32 conv
    backward on the CPU (oneDNN) misses float64 by up to 2.8e-3 of a
    tensor's max-abs at this input, its native kernels by 1.2e-6, XLA's by
    1e-6."""
    params, xb, yb = step_inputs["params"], step_inputs["xb"], step_inputs["yb"]
    model, loss, grads = _port_grads(params, xb, yb)
    want_loss, want = _jax_loss_and_grads(tool, params, xb, yb)
    assert abs(loss - want_loss) <= LOSS_REL * abs(want_loss), (loss, want_loss)
    assert set(grads) == set(want) and len(want) == 32
    exact = port64 = None
    for k in sorted(want):
        top = np.abs(want[k]).max()
        if np.abs(grads[k] - want[k]).max() <= GRAD_TOL * top:
            continue
        if exact is None:  # JAX's step in float64 arbitrates
            exact = _jax_loss_and_grads(tool, params, xb, yb, x64=True)[1]
        err, top = np.abs(grads[k] - exact[k]).max(), np.abs(exact[k]).max()
        if err <= GRAD_TOL * top:
            continue
        assert err <= FP32_LIMIT * top, (k, err, top)
        if port64 is None:
            port64 = _port_grads(params, xb, yb, torch.float64)[2]
        assert np.abs(port64[k] - exact[k]).max() <= F64_TOL * top, k

    # Adam's first update of these gradients against optax.adam's
    lr = 2e-4
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.optim.Adam(model.parameters(), lr=lr).step()
    delta = _flat(to_jax_params({k: p.detach() - before[k] for k, p in model.named_parameters()}))
    tx = optax.adam(lr)
    jax_grads = jax.tree_util.tree_map(np.asarray, to_jax_params(
        {k: p.grad for k, p in model.named_parameters()}))
    updates, _ = tx.update(jax_grads, tx.init(jax_grads))
    for k, u in _flat(jax.device_get(updates)).items():
        assert np.abs(delta[k] - u).max() <= ADAM_TOL, k


def test_train_steps_lower_the_loss():
    """A constant target (fittable through the heads' biases): five Adam
    steps at 1e-3 lower the cross-entropy, as JAX's test of the tool."""
    gen = torch.Generator().manual_seed(0)
    model = seg_vgg.init_seg_vgg(N_LABELS, "cpu", gen)
    x = torch.rand(2, 64, 64, 3, generator=gen) - 0.5
    y = torch.full((2, 64, 64), 3, dtype=torch.int64)
    feats, logits = model(x)
    assert len(feats) == 5 and [lg.shape[1:] for lg in logits] == [(16, 16, N_LABELS),
                                                                   (8, 8, N_LABELS),
                                                                   (4, 4, N_LABELS)]
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = [float(seg_vgg.train_step(model, opt, x, y)) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_trunk_npz_crosses_between_packages_bit_for_bit(tool, step_inputs, tmp_path):
    params = step_inputs["params"]
    model = _port_model(params)
    # the port's export read by JAX's init_vgg19
    ours = seg_vgg.export_trunk(model.trunk, str(tmp_path / "port.npz"))
    _, variables = jax_init_vgg19(0, ours)
    got = _flat(jax.device_get(variables["params"]))
    want = _flat(params["trunk"])
    assert set(got) == set(want) and len(want) == 26
    assert all(got[k].dtype == np.float32 and np.array_equal(got[k], want[k]) for k in want)
    # JAX's export read by the port's init_vgg19
    theirs = tool.export_trunk(params["trunk"], str(tmp_path / "jax.npz"))
    vgg = init_vgg19("cpu", None, theirs)
    trunk = model.trunk.state_dict()
    assert set(vgg.state_dict()) == set(trunk)
    assert all(torch.equal(v, trunk[k]) for k, v in vgg.state_dict().items())
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) and a[k].shape == b[k].shape for k in a.files)


def _write_tree(root: Path, rng, splits=(("train", 3), ("val", 2)), h=64, w=128):
    for split, n in splits:
        for i in range(n):
            city = ("aachen", "bonn")[i % 2]
            name = f"{city}_{i:06d}_000019"
            d, g = root / "leftImg8bit" / split / city, root / "gtFine" / split / city
            d.mkdir(parents=True, exist_ok=True)
            g.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (2 * h, 2 * w, 3), dtype=np.uint8)).save(
                d / f"{name}_leftImg8bit.png")
            lab = np.kron(rng.integers(0, 40, (h // 8, w // 8)), np.ones((16, 16), np.int64))
            Image.fromarray(lab.astype(np.uint8)).save(g / f"{name}_gtFine_labelIds.png")


def test_load_split_equals_jax(tool, tmp_path):
    _write_tree(tmp_path, np.random.default_rng(8))
    for mode in ("train", "val"):
        for size in ((1024, 512), (96, 48)):
            got, want = seg_vgg.load_split(str(tmp_path), mode, size), tool.load_split(
                str(tmp_path), mode, size)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and np.array_equal(a, b)
            assert got[1].max() == 34  # ids up to 39 clipped to num_labels - 1


def test_committed_seg_vgg_features_match_jax():
    path = REPO / "artifacts" / "seg_vgg" / "vgg19_seg.npz"
    if not path.exists():
        pytest.skip("artifacts/seg_vgg/vgg19_seg.npz is not in this copy")
    x = np.random.default_rng(6).random((1, 64, 64, 3), np.float32) - 0.5
    model, variables = jax_init_vgg19(0, str(path))
    want = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = init_vgg19("cpu", None, str(path))(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-4 * np.abs(b).max()


def test_main_trains_scores_and_writes_the_trunk(tmp_path, monkeypatch):
    """``main`` at 128x64 (it reads the split at 1024x512)."""
    root, out = tmp_path / "data", tmp_path / "out"
    _write_tree(root, np.random.default_rng(9))
    monkeypatch.setattr(seg_vgg, "load_split",
                        functools.partial(seg_vgg.load_split, size=(128, 64)))
    argv = ["--root", str(root), "--out", str(out), "--steps", "3", "--batch", "2", "--crop",
            "32", "--lr", "0.001", "--seed", "5", "--num_labels", "35"]
    with redirect_stdout(io.StringIO()) as log:
        got = seg_vgg.main(argv, device="cpu")
    text = log.getvalue()
    assert "3 train images (64, 128, 3) -> device" in text and "step 2: seg CE" in text
    assert len(got["losses"]) == len(got["step_ms"]) == 3 and np.isfinite(got["losses"]).all()
    acc = got["heldout_pixel_acc"]
    assert 0.0 <= acc <= 1.0
    assert (out / "TRAIN_META.txt").read_text() == (
        f"steps=3 batch=2 crop=32 lr=0.001 seed=5\nheldout_pixel_acc_1_16={acc:.4f}\n")
    vgg = init_vgg19("cpu", None, got["out_path"])
    trunk = got["model"].trunk.state_dict()
    assert all(torch.equal(v, trunk[k]) for k, v in vgg.state_dict().items())
    # the same seed, the same run
    with redirect_stdout(io.StringIO()):
        again = seg_vgg.main(argv[:3] + [str(tmp_path / "again")] + argv[4:], device="cpu")
    assert again["losses"] == got["losses"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            seg_vgg.main(argv)
