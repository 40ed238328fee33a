"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
(K1-K4) against their plain versions on the card, and the serving paths on
the card (default and kernel configuration) against the same paths on the
CPU. They skip without a card.

The GPU machine has no JAX, and tests/conftest.py imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from jpdse_tpu_torch.config import flagship_config
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.fast_codec import FastCodec
from jpdse_tpu_torch.ops import head_conv, instance_norm, realign

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _input(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,extra_rows",
    [((2, 6, 6, 20), 4), ((1, 7, 9, 32), 0), ((2, 32, 64, 256), 0), ((1, 16, 20, 256), 4)],
)
def test_realign_kernel_matches_plain(cuda, shape, extra_rows, dtype):
    y = _input(shape).to(cuda, dtype)
    before = realign.s2d_realign_pad3.launches
    got = realign.s2d_realign_pad3(y, extra_rows)
    torch.cuda.synchronize()
    assert realign.s2d_realign_pad3.launches == before + 1
    assert torch.equal(got, realign.s2d_realign_pad3_plain(y, extra_rows))


def test_kernel_config_on_card_matches_cpu(cuda):
    """The tiny flagship's kernel configuration in fp32 (TF32 off): the fast
    path with head_pallas='force' (K4 on every head) and the standard path
    with K3, on the card against the same paths on the CPU."""
    cfg = flagship_config(tiny=True, kernels=True)
    cfg.model.compute_dtype = "float32"
    cfg.model.fast.head_pallas = "force"
    codec = SemanticCodec(cfg, device="cpu", seed=3)
    state = codec.state_dict()
    rng = np.random.default_rng(4)
    batch = {
        "label": torch.from_numpy(rng.integers(0, 35, (2, 64, 128)).astype(np.float32)),
        "instance": torch.from_numpy(rng.integers(0, 1000, (2, 64, 128)).astype(np.int32)),
        "image": _input((2, 64, 128, 3), seed=5),
    }
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    card_codec = SemanticCodec(cfg, device=cuda, seed=None)
    card_codec.load_state_dict(state)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = codec.decode(codec.prepare(batch))[0]
            k3 = instance_norm.fused_instance_norm.launches
            got = card_codec.decode(card_codec.prepare(on_card))[0]
            assert instance_norm.fused_instance_norm.launches == k3 + 9 + 2 * 5
        k4 = head_conv.head_conv_s2d.launches
        fast = FastCodec(cfg, state, device=cuda).decode(on_card)
        torch.cuda.synchronize()
        assert head_conv.head_conv_s2d.launches == k4 + 3
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-4)
    np.testing.assert_allclose(fast.cpu().numpy(), want.numpy(), atol=2e-4)


def test_realign_kernel_rejects_what_it_cannot_take(cuda):
    y = _input((1, 8, 8, 16)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        realign.s2d_realign_pad3(y.transpose(1, 2))
    with pytest.raises(TypeError):
        realign.s2d_realign_pad3(y.to(torch.int32))
    with pytest.raises(ValueError, match="extra_rows"):
        realign.s2d_realign_pad3(y, extra_rows=20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,extra_rows", [((2, 8, 6, 3), 0), ((1, 12, 10, 39), 1),
                                              ((1, 16, 20, 36), 2), ((2, 64, 128, 3), 1)])
def test_s2d_pad3_kernel_matches_plain(cuda, shape, extra_rows, dtype):
    x = _input(shape).to(cuda, dtype)
    before = realign.s2d_pad3.launches
    got = realign.s2d_pad3(x, extra_rows)
    torch.cuda.synchronize()
    assert realign.s2d_pad3.launches == before + 1
    assert torch.equal(got, realign.s2d_pad3_plain(x, extra_rows))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 4, 1), (2, 8, 6, 5), (2, 6, 4, 39), (2, 8, 1024, 3),
                                   (2, 10, 6, 36), (2, 8, 1024, 39)])
def test_s2d_pad3_kernel_edge_shapes(cuda, shape, dtype, offset):
    """K2's tiling at small and odd widths and channel counts, at the largest
    extra_rows, with the input at and one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    x = _input((n + 1,)).to(cuda, dtype)[offset:offset + n].view(shape)
    extra = shape[1] // 2 - 2
    got = realign.s2d_pad3(x, extra)
    torch.cuda.synchronize()
    assert torch.equal(got, realign.s2d_pad3_plain(x, extra))


def test_codec_server_serves_bytes_on_card(cuda):
    """The tiny flagship's kernel configuration in fp32 (TF32 off), fast and
    standard path: the card's .jpds streams equal the CPU's, and the card's
    image decoded from them is within 2e-4 of the CPU's."""
    from jpdse_tpu_torch.serve import CodecServer

    rng = np.random.default_rng(6)
    batch = {
        "label": rng.integers(0, 35, (2, 64, 128)).astype(np.float32),
        "instance": rng.integers(0, 1000, (2, 64, 128)).astype(np.int32),
        "image": rng.normal(size=(2, 64, 128, 3)).astype(np.float32),
    }
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for fast in (True, False):
            cfg = flagship_config(tiny=True, kernels=True)
            cfg.model.compute_dtype = "float32"
            cfg.model.fast_inference = fast
            state = SemanticCodec(cfg, device="cpu", seed=3).state_dict()
            cpu, card = CodecServer(cfg, state, device="cpu"), CodecServer(cfg, state, device=cuda)
            streams = card.compress(batch)
            assert streams == cpu.compress(batch)
            for s in streams:
                np.testing.assert_allclose(card.decompress(s), cpu.decompress(s), atol=2e-4)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,has_res", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("shape", [(2, 8, 12, 6), (1, 64, 128, 64), (2, 16, 8, 1024)])
def test_instance_norm_kernel_matches_plain(cuda, shape, relu, has_res, dtype):
    """fp32 within 1e-5 (statistics summed in another order); bf16 within
    one ulp of the larger output beyond that 1e-5 (where x - mean or norm +
    residual cancels, the fp32 statistics' last digits are many of the tiny
    output's ulps); two runs give equal bits."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    res = _input(shape, seed=1).to(cuda, dtype) if has_res else None
    before = instance_norm.fused_instance_norm.launches
    got = instance_norm.fused_instance_norm(x, res, relu=relu)
    again = instance_norm.fused_instance_norm(x, res, relu=relu)
    want = instance_norm.fused_instance_norm_plain(x, res, relu=relu)
    torch.cuda.synchronize()
    assert instance_norm.fused_instance_norm.launches == before + 2
    assert torch.equal(got, again)
    g, w = got.float(), want.float()
    if dtype == torch.float32:
        assert (g - w).abs().max().item() <= 1e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
        assert ((g - w).abs() <= ulp + 1e-5).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,ho,wp,c,n", [(2, 8, 13, 12, 8), (1, 12, 12, 44, 32),
                                         # bf16: zero-padded by the wrapper to C, N
                                         # multiples of 8
                                         (1, 32, 67, 156, 256), (1, 16, 20, 144, 100),
                                         (1, 32, 67, 160, 256), (2, 8, 140, 16, 32),
                                         (1, 16, 20, 144, 256), (1, 5, 9, 8, 8)])
def test_head_conv_kernel_matches_plain(cuda, b, ho, wp, c, n, dtype, tol):
    """Relative to the largest output, the plain conv with TF32 off: fp32
    on CUDA cores, bf16 on wgmma."""
    kp = 4
    extra = head_conv.head_conv_extra_rows(ho, kp)
    xp = _input((b, ho + kp - 1 + extra, wp, c)).to(cuda, dtype)
    xp[:, ho + kp - 1:] = float("nan")  # rows past ho + kp - 1 are never read
    w = (_input((kp, kp * c, n), seed=1) * 0.02).to(cuda, dtype)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = head_conv.head_conv_s2d(xp, w, kp, ho=ho)
        want = head_conv.head_conv_s2d_plain(xp, w, kp, ho=ho)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.shape == (b, ho, wp - kp + 1, n)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("m,k,n", [(300, 72, 40), (1024, 2560, 256), (131, 40, 256)])
def test_head_conv_gemm_matches_matmul(cuda, m, k, n):
    """K4's dense-A mode against torch.matmul, relative to the largest
    output: both accumulate in fp32 and round once."""
    a = _input((m, k)).to(cuda, torch.bfloat16)
    b = (_input((k, n), seed=1) * 0.02).to(cuda, torch.bfloat16)
    before = head_conv.head_conv_gemm.launches
    got = head_conv.head_conv_gemm(a, b)
    want = torch.matmul(a, b)
    torch.cuda.synchronize()
    assert head_conv.head_conv_gemm.launches == before + 1
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 128, 64), (2, 16, 8, 1024), (2, 8, 12, 6)])
def test_instance_norm_is_one_launch(cuda, shape, dtype):
    """One call of K3 runs one device kernel, and two runs give equal bits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    first = instance_norm.fused_instance_norm(x, relu=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = instance_norm.fused_instance_norm(x, relu=True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 1, [(e.key, e.count) for e in kernels]
    assert torch.equal(first, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_realign_kernel_pads_channels(cuda, dtype):
    """K1 as K4's producer: the netG head's 156 s2d channels padded to 160."""
    y = _input((1, 32, 64, 156)).to(cuda, dtype)
    got = realign.s2d_realign_pad3(y, 1, 160)
    torch.cuda.synchronize()
    assert torch.equal(got, realign.s2d_realign_pad3_plain(y, 1, 160))


def test_fast_codec_on_card_matches_cpu(cuda):
    """The tiny flagship in fp32 (TF32 off): codes equal and images within
    2e-4 between the card (cuDNN + K1) and the CPU (plain versions)."""
    cfg = flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    state = SemanticCodec(cfg, device="cpu", seed=3).state_dict()
    rng = np.random.default_rng(4)
    batch = {
        "label": torch.from_numpy(rng.integers(0, 35, (2, 64, 128)).astype(np.float32)),
        "instance": torch.from_numpy(rng.integers(0, 1000, (2, 64, 128)).astype(np.int32)),
        "image": _input((2, 64, 128, 3), seed=5),
    }
    cpu = FastCodec(cfg, state, device="cpu")
    card = FastCodec(cfg, state, device=cuda)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        codes = cpu.get_codes_shaped(batch)
        card_codes = card.get_codes_shaped({k: v.to(cuda) for k, v in batch.items()})
        launches = realign.s2d_realign_pad3.launches
        image = card.decode_from_codes([c.to(cuda) for c in codes])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert realign.s2d_realign_pad3.launches == launches + 3
    for a, b in zip(codes, card_codes):
        assert torch.equal(a, b.cpu())
    want = cpu.decode_from_codes(codes)
    np.testing.assert_allclose(image.cpu().numpy(), want.numpy(), atol=2e-4)


def _eval_run(tmp_path, kernels: bool):
    """A synthetic Cityscapes test split (3 images at 128x256, read at
    64x128), the tiny flagship's opt.json in fp32 and its params_g.pt."""
    from PIL import Image

    from jpdse_tpu_torch.train.checkpoint import save_params

    rng = np.random.default_rng(8)
    img_dir = tmp_path / "data/leftImg8bit/test/lindau"
    gt_dir = tmp_path / "data/gtFine/test/lindau"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    for i in range(3):
        name = f"lindau_{i:06d}_000019"
        Image.fromarray(rng.integers(0, 256, (128, 256, 3), dtype=np.uint8)).save(
            img_dir / f"{name}_leftImg8bit.png")
        Image.fromarray(rng.integers(0, 35, (128, 256), dtype=np.uint8)).save(
            gt_dir / f"{name}_gtFine_labelIds.png")
        Image.fromarray(rng.integers(0, 6, (128, 256), dtype=np.uint8)).save(
            gt_dir / f"{name}_gtFine_instanceIds.png")
    cfg = flagship_config(tiny=True, kernels=kernels)
    cfg.model.compute_dtype = "float32"
    if kernels:
        cfg.model.fast.head_pallas = "force"
    cfg.data.root_dir = str(tmp_path / "data")
    cfg.data.test_preprocess.preprocess_mode = "fixed"
    cfg.data.test_preprocess.crop_size = 128
    run = tmp_path / "run"
    run.mkdir()
    cfg.save(str(run / "opt.json"))
    save_params(str(run), SemanticCodec(cfg, device="cpu", seed=3).state_dict())
    return ["--load_opt", "--opt_file", str(run / "opt.json"), "--checkpoints_dir", str(run)]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("path", ["fast", "standard"])
def test_evaluate_on_card_matches_cpu(cuda, tmp_path, path, kernels):
    """test.main at the tiny flagship in fp32 (TF32 off), on the card and on
    the CPU, in the default and the kernel configuration: rates and the
    .rc / _code bytes equal, the Shannon estimate within 1e-6 and the
    distortion within 1e-3 relative; compress writes the same streams."""
    from jpdse_tpu_torch import compress, test

    argv = _eval_run(tmp_path, kernels) + ["--fast_inference", "1" if path == "fast" else "0"]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = test.main(argv + ["--save_dir", str(tmp_path / "card")], device="cuda")
        compress.main(argv + ["--save_dir", str(tmp_path / "card_bits")], device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    want = test.main(argv + ["--save_dir", str(tmp_path / "cpu")], device="cpu")
    compress.main(argv + ["--save_dir", str(tmp_path / "cpu_bits")], device="cpu")
    for k in ("actual_bpp", "coded_bpp", "total_bpp", "n_images"):
        assert got[k] == want[k], k
    assert got["shannon_bpp"] == pytest.approx(want["shannon_bpp"], rel=1e-6)
    for k in ("L1", "MSE", "PSNR", "MS-SSIM"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    for cpu_dir, card_dir in (("cpu/codes", "card/codes"), ("cpu_bits", "card_bits")):
        files = sorted((tmp_path / cpu_dir).iterdir())
        assert len(files) == (6 if cpu_dir.endswith("codes") else 4)
        for f in files:
            assert (tmp_path / card_dir / f.name).read_bytes() == f.read_bytes(), f.name


# -- training: K3's backward and one train step ----------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 8, 12, 6), (1, 64, 128, 64), (2, 16, 8, 1024)])
def test_instance_norm_bwd_kernel_matches_plain(cuda, shape, relu, dtype):
    """K3's backward on the forward's statistics against its plain version
    (which recomputes them): fp32 within 1e-5, bf16 within one ulp beyond
    that; two runs bit-equal; one launch a call."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    g = _input(shape, seed=1).to(cuda, dtype)
    _, stats = instance_norm._forward(x, None, relu, 1e-5)
    before = instance_norm.fused_instance_norm_bwd.launches
    got = instance_norm.fused_instance_norm_bwd(x, g, stats, relu)
    again = instance_norm.fused_instance_norm_bwd(x, g, stats, relu)
    want = instance_norm.fused_instance_norm_bwd_plain(x, g, relu)
    torch.cuda.synchronize()
    assert instance_norm.fused_instance_norm_bwd.launches == before + 2
    assert torch.equal(got, again) and got.dtype == dtype
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert ((err - 1e-5).clamp_min(0) / ulp).max().item() <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [
    (1, 32, 64, 1024),  # each block's rows fit its shared-memory cache: one read
    (1, 64, 128, 512),  # the same, at 8 iterations a block in bf16
    (300, 64, 64, 16),  # blocks take 2-3 whole slabs, the later ones past the cache
])
def test_instance_norm_bwd_kernel_cache_shapes(cuda, shape, relu, dtype):
    """K3's backward where its cache holds a block's whole share and where
    it holds only the first of several items, against its plain version on
    the forward's statistics (so the ReLU's mask is the same): fp32 within
    1e-5, bf16 within one ulp beyond that; two runs bit-equal."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    g = _input(shape, seed=1).to(cuda, dtype)
    _, stats = instance_norm._forward(x, None, relu, 1e-5)
    got = instance_norm.fused_instance_norm_bwd(x, g, stats, relu)
    again = instance_norm.fused_instance_norm_bwd(x, g, stats, relu)
    want = instance_norm.fused_instance_norm_bwd_plain(x, g, relu, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and got.dtype == dtype
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= 1e-5
    else:
        mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        assert ((err - 1e-5).clamp_min(0) / ulp).max().item() <= 1.0


def test_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One training step of the tiny flagship in the kernel configuration
    (K3 forward, recompute and backward at its 19 norm sites), fp32 with
    TF32 off, deterministic binarization, on the card against the CPU from
    the same weights: the distortion-only recipe's metrics within 1e-4
    relative and its G gradients within 1e-4 of each tensor's max-abs; the
    GAN recipe's metrics within 1e-4 relative."""
    from jpdse_tpu_torch.ops import quantizers
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.trainer import Trainer

    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    rng = np.random.default_rng(6)
    batch = {"label": rng.integers(0, 35, (2, 64, 128)).astype(np.float32),
             "instance": rng.integers(0, 1000, (2, 64, 128)).astype(np.int32),
             "image": rng.normal(size=(2, 64, 128, 3)).astype(np.float32)}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for gan in (False, True):
            cfg = flagship_config(tiny=True, kernels=True)
            cfg.model.compute_dtype, cfg.model.fast_inference, cfg.model.ndf = "float32", False, 8
            cfg.optim.remat = True
            cfg.data.preprocess.preprocess_mode, cfg.data.preprocess.crop_size = "fixed", 128
            L = cfg.loss
            L.no_d_gan_loss = L.no_g_gan_loss = L.no_gan_feat_loss = L.no_vgg_loss = not gan
            cpu, card = Trainer(cfg, mode="train", device="cpu"), Trainer(cfg, mode="train",
                                                                          device=cuda)
            for a, b in ((cpu.gan.codec, card.gan.codec), (cpu.gan.disc, card.gan.disc),
                         (cpu.gan.vgg, card.gan.vgg)):
                if a is not None:
                    b.load_state_dict(a.state_dict())
            k3 = (instance_norm.fused_instance_norm.launches,
                  instance_norm.fused_instance_norm_bwd.launches)
            want, want_g = step.loss_and_grads(cpu.gan, cpu.place(batch), cpu.generator)
            got, got_g = step.loss_and_grads(card.gan, card.place(batch), card.generator)
            torch.cuda.synchronize()
            assert (instance_norm.fused_instance_norm.launches - k3[0],
                    instance_norm.fused_instance_norm_bwd.launches - k3[1]) == (38, 19)
            for k in step.METRICS:
                np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-4, atol=0,
                                           err_msg=k)
            if not gan:
                for (name, _), g, w in zip(cpu.gan.codec.named_parameters(), got_g[0],
                                           want_g[0]):
                    if name.endswith("bias") and "tail" not in name:
                        continue  # a bias an InstanceNorm follows: 0 to rounding
                    assert (g.cpu() - w).abs().max().item() <= 1e-4 * w.abs().max().item(), name
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
