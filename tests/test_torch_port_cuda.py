"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
(K1-K4) against their plain versions on the card, and the serving paths on
the card (default and kernel configuration) against the same paths on the
CPU. They skip without a card.

The GPU machine has no JAX, and tests/conftest.py imports it, so run them
there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import re

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


@pytest.mark.parametrize("how", ["0", "1"])
def test_fused_realign_off_launches_no_k1(cuda, how):
    """The fast path with ``fused_realign`` '0' or '1' (the composition)
    launches no K1 and decodes the image K1's form decodes, bit
    for bit; the fast train decode launches none of K1, K2 and K4 however
    the kernel switches are set."""
    from jpdse_tpu_torch.models.fast_train import make_fast_train_decode

    cfg = flagship_config(tiny=True)
    cfg.model.compute_dtype = "float32"
    state = SemanticCodec(cfg, device="cpu", seed=5).state_dict()
    rng = np.random.default_rng(8)
    batch = {"label": torch.from_numpy(rng.integers(0, 35, (2, 64, 128)).astype(np.float32)),
             "instance": torch.from_numpy(rng.integers(0, 1000, (2, 64, 128)).astype(np.int32)),
             "image": torch.from_numpy(rng.normal(size=(2, 64, 128, 3)).astype(np.float32))}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    want = FastCodec(cfg, state, device=cuda).decode(batch)
    cfg.model.fast.fused_realign = how
    before = realign.s2d_realign_pad3.launches
    got = FastCodec(cfg, state, device=cuda).decode(batch)
    torch.cuda.synchronize()
    assert realign.s2d_realign_pad3.launches == before
    assert torch.equal(got, want)
    cfg.model.fast.fused_realign = "auto"
    cfg.model.fast.head_pallas, cfg.model.fast.front_realign = "force", "pallas"
    codec = SemanticCodec(cfg, device=cuda, seed=5)
    counts = (realign.s2d_realign_pad3.launches, realign.s2d_pad3.launches,
              head_conv.head_conv_s2d.launches)
    fake, _ = make_fast_train_decode(cfg, codec)(codec.prepare(batch))
    fake.square().sum().backward()
    torch.cuda.synchronize()
    assert (realign.s2d_realign_pad3.launches, realign.s2d_pad3.launches,
            head_conv.head_conv_s2d.launches) == counts


def test_device_cache_batches_on_card_equal_host(cuda, tmp_path):
    """The device cache on the card: two epochs of assembled batches equal
    the host batches bit for bit, placed through the prefetch's side
    stream."""
    from PIL import Image

    from jpdse_tpu_torch import cli, data
    from jpdse_tpu_torch.data.device_cache import maybe_device_cache
    from jpdse_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.default_rng(2)
    for i in range(4):
        name = f"aachen_{i:06d}_000019"
        for sub, arr in (("leftImg8bit", rng.integers(0, 256, (48, 100, 3), dtype=np.uint8)),
                         ("gtFine", rng.integers(0, 34, (48, 100), dtype=np.uint8))):
            d = tmp_path / sub / "train" / "aachen"
            d.mkdir(parents=True, exist_ok=True)
            suffixes = ("_leftImg8bit",) if sub == "leftImg8bit" else ("_gtFine_labelIds",
                                                                        "_gtFine_instanceIds")
            for s in suffixes:
                Image.fromarray(arr).save(d / f"{name}{s}.png")
    cfg = cli.parse_config(["--dataset", "cityscapes", "--root_dir", str(tmp_path),
                            "--preprocess_mode", "fixed", "--load_size", "72", "--crop_size",
                            "72", "--batch_size", "2", "--seed", "5", "--cache_images", "1"],
                           True)
    host, meta = data.create_dataloader(cfg), data.create_dataloader(cfg)
    cache = maybe_device_cache(meta, cfg, cuda)
    assert cache is not None and cache.ds["image"].is_cuda
    meta.meta_only = True
    for epoch in range(2):
        host.set_epoch(epoch)
        meta.set_epoch(epoch)
        for hb, placed in zip(host, prefetch_to_device(meta, 2, cuda, cache.place)):
            for k in ("image", "label", "instance"):
                assert placed[k].is_cuda
                assert torch.equal(placed[k].cpu(), torch.from_numpy(hb[k])), k


@pytest.fixture
def nccl_world1(cuda):
    """A process group of one rank on NCCL over the card (the data-parallel
    path's collectives), torn down after the test."""
    import socket

    import torch.distributed as dist

    from jpdse_tpu_torch.parallel import distributed

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    distributed.initialize("cuda", f"localhost:{port}", 1, 0)
    try:
        yield distributed
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_world1_all_reduce_is_bit_equal_to_its_input(nccl_world1, dtype):
    """The mean all-reduce over flat buckets (several of them: tensors of
    mixed sizes past one bucket's bytes) leaves every tensor of one rank
    bit-equal, on the card."""
    import torch.distributed as dist

    assert dist.get_backend() == "nccl" and nccl_world1.world() == 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1024, 1024, 3, 3), (7,), (64, 3, 7, 7), (4096, 2048), ()]
    xs = [torch.randn(s, generator=gen, device="cuda", dtype=dtype) for s in shapes]
    want = [x.clone() for x in xs]
    nccl_world1.all_reduce_mean_(xs, bucket_bytes=8 * 2**20)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(xs, want))
    got = nccl_world1.all_gather_rows(want[3])
    assert torch.equal(got, want[3])


def test_world1_train_step_equals_the_single_process_step(nccl_world1, monkeypatch):
    """The tiny flagship's phase-2 step in the kernel configuration (K3
    forward and backward) through the data-parallel path of one NCCL rank
    against the same state without its mesh, on the card in fp32 with TF32
    off, cuDNN's deterministic algorithms and the deterministic sign: the
    same K3 launches, and metrics and gradients within 1e-4 of each
    tensor's max-abs. With cuDNN free to choose its algorithms, the two
    runs' netG head weight gradients differed by up to 1.4e-4 of its
    max-abs, in half the runs past the bound."""
    from jpdse_tpu_torch.models.discriminator import build_discriminator
    from jpdse_tpu_torch.ops import quantizers
    from jpdse_tpu_torch.parallel.mesh import mesh_from_config
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.train.state import create_train_state

    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = flagship_config(tiny=True, kernels=True)
    cfg.model.compute_dtype, cfg.model.fast_inference = "float32", False
    cfg.loss.no_vgg_loss = True
    mesh = mesh_from_config(cfg.parallel)
    assert mesh is not None and mesh.world == 1
    rng = np.random.default_rng(5)
    batch = {"label": torch.from_numpy(rng.integers(0, 35, (2, 64, 128)).astype(np.float32)),
             "instance": torch.from_numpy(rng.integers(0, 6, (2, 64, 128)).astype(np.int32)),
             "image": torch.from_numpy(rng.uniform(-1, 1, (2, 64, 128, 3)).astype(np.float32))}
    batch = {k: v.cuda() for k, v in batch.items()}
    outs, k3, names = [], [], None
    for m in (None, mesh):
        codec = SemanticCodec(cfg, device="cuda", seed=7)
        disc = build_discriminator(cfg, "cuda", torch.Generator(device="cuda").manual_seed(3))
        state = create_train_state(cfg, codec, disc, None, (64, 128, cfg.netD_input_nc), m)
        names = [[n for n, _ in net.named_parameters()] for net in (codec, disc)]
        before = (instance_norm.fused_instance_norm.launches,
                  instance_norm.fused_instance_norm_bwd.launches)
        outs.append(step.loss_and_grads(state, batch, torch.Generator(device="cuda")))
        torch.cuda.synchronize()
        k3.append((instance_norm.fused_instance_norm.launches - before[0],
                   instance_norm.fused_instance_norm_bwd.launches - before[1]))
    assert k3[0] == k3[1] and k3[0][1] > 0
    (m0, g0), (m1, g1) = outs
    for k in step.METRICS:
        assert abs(m1[k].item() - m0[k].item()) <= 1e-4 * max(abs(m0[k].item()), 1e-30), k
    normed_bias = re.compile(r"(^|\.)(head|down\.\d+|up(\.\d+)?|res\.\d+|layer[1-9])\..*bias$")
    for net_names, a_list, b_list in zip(names, g0, g1):
        top = max(a.abs().max().item() for a in a_list)
        for n, a, b in zip(net_names, a_list, b_list):
            if normed_bias.search(n):  # 0 to rounding on both sides
                assert max(a.abs().max().item(), b.abs().max().item()) <= 1e-5 * top, n
            else:
                assert (a - b).abs().max().item() <= 1e-4 * a.abs().max().item(), n


# -- K3's partial-statistics form (the spatial axis) ------------------------------------
PARTIAL_SHAPES = [
    (2, 8, 12, 6),  # vec 1 in fp32 and bf16
    (1, 64, 128, 64),  # many chunks a slab
    (2, 16, 8, 1024),  # two channel tiles
    (1, 4, 32, 64),  # 128 rows: one block holds a slab's rows
]


def _ulp_close(got, want, tol=1e-5):
    """fp32 within ``tol``; bf16 within one ulp of the larger beyond it; an
    empty slab's output matches an empty one."""
    if want.numel() == 0:
        return got.shape == want.shape
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        return (g - w).abs().max().item() <= tol * max(1.0, w.abs().max().item())
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    return bool(((g - w).abs() <= ulp + tol).all())


def _split(x, size):
    from jpdse_tpu_torch.parallel.spatial import bounds

    b = bounds(x.shape[1], size)
    return [x[:, b[s]:b[s + 1]].contiguous() for s in range(size)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PARTIAL_SHAPES)
def test_partial_stats_kernel_matches_plain(cuda, shape, dtype):
    """This rank's (count, mean, M2) per (b, c): the count exact, the mean
    and M2 within 1e-5 relative of the plain version's; two runs bit-equal;
    one launch a call."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    before = instance_norm.instance_norm_stats.launches
    got = instance_norm.instance_norm_stats(x)
    again = instance_norm.instance_norm_stats(x)
    want = instance_norm.instance_norm_stats_plain(x)
    torch.cuda.synchronize()
    assert instance_norm.instance_norm_stats.launches == before + 2
    assert torch.equal(got, again) and got.shape == (shape[0], shape[3], 3)
    assert torch.equal(got[..., 0], want[..., 0])
    for i in (1, 2):
        assert ((got[..., i] - want[..., i]).abs()
                <= 1e-5 * want[..., i].abs().clamp_min(1.0)).all(), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,has_res", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("shape", PARTIAL_SHAPES)
def test_partial_forward_kernels_match_the_one_launch_plain_form(cuda, shape, size, relu,
                                                                 has_res, dtype):
    """A slab cut into ``size`` rank slabs on one card: stats of each, the
    triples stacked in rank order, apply on each against its plain version
    on the same triples, and all of them together against
    ``fused_instance_norm_plain`` of the whole (the ulp rule); every rank's
    mean and rstd bit-equal."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    res = _input(shape, seed=1).to(cuda, dtype) if has_res else None
    parts = _split(x, size)
    rparts = _split(res, size) if has_res else [None] * size
    stats = torch.stack([instance_norm.instance_norm_stats(p) for p in parts])
    before = instance_norm.instance_norm_apply.launches
    ys, mss = [], []
    for p, r in zip(parts, rparts):
        y, ms = instance_norm.instance_norm_apply(p, r, stats, relu)
        want, _ = instance_norm.instance_norm_apply_plain(p, r, stats, relu)
        assert _ulp_close(y, want)
        ys.append(y)
        mss.append(ms)
    torch.cuda.synchronize()
    assert instance_norm.instance_norm_apply.launches == before + size
    assert all(torch.equal(m, mss[0]) for m in mss)
    assert _ulp_close(torch.cat(ys, 1), instance_norm.fused_instance_norm_plain(x, res, relu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", PARTIAL_SHAPES)
def test_partial_backward_kernels_match_plain(cuda, shape, relu, dtype):
    """Two rank slabs: the sums kernel against its plain version (1e-5 of
    the sums' max-abs), then dx of each from the stacked sums against its
    plain version on the same sums, and together against
    ``fused_instance_norm_bwd_plain`` of the whole on the same statistics
    (the ulp rule); two runs bit-equal."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    g = _input(shape, seed=1).to(cuda, dtype)
    parts, gparts = _split(x, 2), _split(g, 2)
    stats = torch.stack([instance_norm.instance_norm_stats(p) for p in parts])
    _, ms = instance_norm.instance_norm_apply(parts[0], None, stats, relu)
    sums = []
    for p, gp in zip(parts, gparts):
        got = instance_norm.instance_norm_bwd_sums(p, gp, ms, relu)
        assert torch.equal(got, instance_norm.instance_norm_bwd_sums(p, gp, ms, relu))
        want = instance_norm.instance_norm_bwd_sums_plain(p, gp, ms, relu)
        assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
        sums.append(got)
    sums = torch.stack(sums)
    count = float(shape[1] * shape[2])
    dxs = []
    for p, gp in zip(parts, gparts):
        dx = instance_norm.instance_norm_bwd_dx(p, gp, ms, sums, count, relu)
        assert torch.equal(dx, instance_norm.instance_norm_bwd_dx(p, gp, ms, sums, count, relu))
        assert _ulp_close(dx, instance_norm.instance_norm_bwd_dx_plain(p, gp, ms, sums, count,
                                                                       relu))
        dxs.append(dx)
    torch.cuda.synchronize()
    assert _ulp_close(torch.cat(dxs, 1),
                      instance_norm.fused_instance_norm_bwd_plain(x, g, relu, stats=ms))


# (rows, ranks): the spatial axis's splits of a slab's rows, uneven, some with ranks of none
UNEVEN_SPLITS = [(3, 4), (2, 4), (7, 3), (13, 3), (43, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,has_res", [(True, False), (False, True)])
@pytest.mark.parametrize("rows,size", UNEVEN_SPLITS)
@pytest.mark.parametrize("width,c", [(12, 6), (32, 64)])
def test_partial_kernels_take_uneven_and_empty_slabs(cuda, width, c, rows, size, relu, has_res,
                                                     dtype):
    """A slab of ``rows`` rows split over ``size`` "ranks" as the spatial
    axis splits it (odd heights, ranks of none): each rank's stats, apply,
    sums and dx launch (an empty slab's too: one launch each, no launch
    error) against its plain version on the same slab; an empty slab's
    stats and sums exactly 0; the stats merged in rank order to the same
    mean and rstd bits on every rank; together against the one-launch plain
    form of the whole (the ulp rule)."""
    shape = (2, rows, width, c)
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    res = _input(shape, seed=1).to(cuda, dtype) if has_res else None
    g = _input(shape, seed=2).to(cuda, dtype)
    parts, gparts = _split(x, size), _split(g, size)
    rparts = _split(res, size) if has_res else [None] * size
    names = ("instance_norm_stats", "instance_norm_apply", "instance_norm_bwd_sums",
             "instance_norm_bwd_dx")
    before = {n: getattr(instance_norm, n).launches for n in names}
    stats = []
    for p in parts:
        got = instance_norm.instance_norm_stats(p)
        want = instance_norm.instance_norm_stats_plain(p)
        if p.shape[1] == 0:
            assert torch.equal(got, torch.zeros_like(got))
        assert torch.equal(got[..., 0], want[..., 0])
        assert ((got[..., 1:] - want[..., 1:]).abs()
                <= 1e-5 * want[..., 1:].abs().clamp_min(1.0)).all()
        stats.append(got)
    stats = torch.stack(stats)
    ys, mss = [], []
    for p, r in zip(parts, rparts):
        y, ms = instance_norm.instance_norm_apply(p, r, stats, relu)
        want, want_ms = instance_norm.instance_norm_apply_plain(p, r, stats, relu)
        assert y.shape == p.shape and _ulp_close(y, want)
        assert (ms - want_ms).abs().max().item() <= 1e-5 * want_ms.abs().max().item()
        ys.append(y)
        mss.append(ms)
    assert all(torch.equal(m, mss[0]) for m in mss), "the ranks merged apart"
    ms = mss[0]
    sums = []
    for p, gp in zip(parts, gparts):
        got = instance_norm.instance_norm_bwd_sums(p, gp, ms, relu)
        want = instance_norm.instance_norm_bwd_sums_plain(p, gp, ms, relu)
        if p.shape[1] == 0:
            assert torch.equal(got, torch.zeros_like(got))
        assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
        sums.append(got)
    sums = torch.stack(sums)
    count = float(rows * width)
    dxs = []
    for p, gp in zip(parts, gparts):
        dx = instance_norm.instance_norm_bwd_dx(p, gp, ms, sums, count, relu)
        assert dx.shape == p.shape
        assert _ulp_close(dx, instance_norm.instance_norm_bwd_dx_plain(p, gp, ms, sums, count,
                                                                       relu))
        dxs.append(dx)
    torch.cuda.synchronize()
    assert {n: getattr(instance_norm, n).launches - before[n] for n in names} == \
        {n: size for n in names}
    assert _ulp_close(torch.cat(ys, 1), instance_norm.fused_instance_norm_plain(x, res, relu))
    assert _ulp_close(torch.cat(dxs, 1),
                      instance_norm.fused_instance_norm_bwd_plain(x, g, relu, stats=ms))


# the spatial step's rank slabs at spatial 2: each norm level's rows halved,
# batch 2 in fp32 (the training step) and batch 1 in bf16 (serving)
STEP_LEVELS = [(512, 1024, 64), (256, 512, 128), (128, 256, 256), (64, 128, 512), (32, 64, 1024)]
STEP_SLABS = ([((2, h // 2, w, c), torch.float32) for h, w, c in STEP_LEVELS]
              + [((1, h // 2, w, c), torch.bfloat16) for h, w, c in STEP_LEVELS])


def _tickets_clean(x):
    """The stats and sums launches' counters on x's device and stream, all
    back at 0."""
    key = (x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    return bool((instance_norm._TICKETS[key] == 0).all())


@pytest.mark.parametrize("shape,dtype", STEP_SLABS)
def test_partial_stats_and_sums_at_the_step_rank_slabs(cuda, shape, dtype):
    """The stats and sums launches at a rank's slab of the spatial step
    against their plain versions (the count exact, mean and M2 within 1e-5
    relative; the sums within 1e-5 of their max-abs); two launches in a row
    bit-equal; the counters left at 0."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    g = _input(shape, seed=1).to(cuda, dtype)
    got = instance_norm.instance_norm_stats(x)
    again = instance_norm.instance_norm_stats(x)
    want = instance_norm.instance_norm_stats_plain(x)
    assert torch.equal(got, again) and torch.equal(got[..., 0], want[..., 0])
    assert ((got[..., 1:] - want[..., 1:]).abs()
            <= 1e-5 * want[..., 1:].abs().clamp_min(1.0)).all()
    _, ms = instance_norm.instance_norm_apply(x, None, torch.stack([got, got]), True)
    for relu in (True, False):
        sums = instance_norm.instance_norm_bwd_sums(x, g, ms, relu)
        assert torch.equal(sums, instance_norm.instance_norm_bwd_sums(x, g, ms, relu))
        want = instance_norm.instance_norm_bwd_sums_plain(x, g, ms, relu)
        assert (sums - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    torch.cuda.synchronize()
    assert _tickets_clean(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_launch_after_another_shape_equals_a_fresh_one(cuda, dtype):
    """A stats and a sums launch, then launches at shapes of other
    partitions (many chunks, several channel tiles, an empty
    slab), then the first two again: bit-equal, so every launch left its
    counters as it found them."""
    shape = (2, 21, 64, 1024)
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    g = _input(shape, seed=1).to(cuda, dtype)
    st = instance_norm.instance_norm_stats(x)
    _, ms = instance_norm.instance_norm_apply(x, None, st[None], True)
    sums = instance_norm.instance_norm_bwd_sums(x, g, ms, True)
    for other in [(1, 256, 1024, 64), (2, 32, 128, 512), (1, 0, 64, 1024), (2, 7, 12, 6)]:
        y = (_input(other, seed=2) * 3 + 1).to(cuda, dtype)
        sy = instance_norm.instance_norm_stats(y)
        _, my = instance_norm.instance_norm_apply(y, None, sy[None], True)
        instance_norm.instance_norm_bwd_sums(y, y, my, True)
    assert torch.equal(instance_norm.instance_norm_stats(x), st)
    assert torch.equal(instance_norm.instance_norm_bwd_sums(x, g, ms, True), sums)
    torch.cuda.synchronize()
    assert _tickets_clean(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 0, 64, 1024), (2, 0, 8, 6), (2, 0, 16, 64)])
def test_partial_empty_slab_parts_are_zero(cuda, shape, dtype):
    """A rank's slab of no rows: one stats and one sums launch, each giving
    exactly 0 (the count too)."""
    x = torch.empty(shape, device=cuda, dtype=dtype)
    b, c = shape[0], shape[3]
    ms = torch.randn((b, c, 2), device=cuda)
    before = (instance_norm.instance_norm_stats.launches,
              instance_norm.instance_norm_bwd_sums.launches)
    st = instance_norm.instance_norm_stats(x)
    sums = instance_norm.instance_norm_bwd_sums(x, x, ms, True)
    torch.cuda.synchronize()
    assert (instance_norm.instance_norm_stats.launches,
            instance_norm.instance_norm_bwd_sums.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(st, torch.zeros((b, c, 3), device=cuda))
    assert torch.equal(sums, torch.zeros((b, c, 2), device=cuda))


# slabs that meet the apply and dx launches' partition at its edges (csrc/part_plan.h):
# fewer rows than a CTA's step, one row, one-word channels (vec 1), more than one
# channel tile (bf16 and fp32), a slab of many chunks
APPLY_PLAN_SHAPES = [(1, 1, 8, 64), (2, 1, 1, 64), (2, 5, 7, 6), (1, 9, 16, 1024),
                     (2, 3, 5, 2048), (1, 40, 64, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,has_res", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("size", [1, 2, 4])
@pytest.mark.parametrize("shape", APPLY_PLAN_SHAPES)
def test_partial_apply_and_dx_under_the_apply_plan(cuda, shape, size, relu, has_res, dtype):
    """The apply and dx launches on each of ``size`` rank slabs (ranks of
    none where the rows are fewer): each against its plain version on the
    same statistics and sums (fp32 within 1e-5, bf16 within one ulp beyond
    it; the apply's mean and rstd within 1e-5 of their max-abs), two
    launches bit-equal, every rank's mean and rstd bit-equal, an empty
    slab's mean and rstd written for every (b, c) (its buffer was last a
    tensor of NaN), one launch a call, and all ranks together against the
    one-launch plain forms of the whole slab."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    res = _input(shape, seed=1).to(cuda, dtype) if has_res else None
    g = _input(shape, seed=2).to(cuda, dtype)
    parts, gparts = _split(x, size), _split(g, size)
    rparts = _split(res, size) if has_res else [None] * size
    stats = torch.stack([instance_norm.instance_norm_stats(p) for p in parts])
    before = (instance_norm.instance_norm_apply.launches,
              instance_norm.instance_norm_bwd_dx.launches)
    ys, mss = [], []
    for p, r in zip(parts, rparts):
        if p.shape[1] == 0:  # the block the wrapper's mean and rstd will take, filled with NaN
            nan = torch.full((shape[0], shape[3], 2), float("nan"), device=cuda)
            del nan
        y, ms = instance_norm.instance_norm_apply(p, r, stats, relu)
        again, ms_again = instance_norm.instance_norm_apply(p, r, stats, relu)
        want, want_ms = instance_norm.instance_norm_apply_plain(p, r, stats, relu)
        assert torch.equal(y, again) and torch.equal(ms, ms_again)
        assert y.shape == p.shape and _ulp_close(y, want)
        assert (ms - want_ms).abs().max().item() <= 1e-5 * want_ms.abs().max().item()
        ys.append(y)
        mss.append(ms)
    assert all(torch.equal(m, mss[0]) for m in mss), "the ranks merged apart"
    ms = mss[0]
    sums = torch.stack([instance_norm.instance_norm_bwd_sums(p, gp, ms, relu)
                        for p, gp in zip(parts, gparts)])
    count = float(shape[1] * shape[2])
    dxs = []
    for p, gp in zip(parts, gparts):
        dx = instance_norm.instance_norm_bwd_dx(p, gp, ms, sums, count, relu)
        assert torch.equal(dx, instance_norm.instance_norm_bwd_dx(p, gp, ms, sums, count, relu))
        assert dx.shape == p.shape
        assert _ulp_close(dx, instance_norm.instance_norm_bwd_dx_plain(p, gp, ms, sums, count,
                                                                       relu))
        dxs.append(dx)
    torch.cuda.synchronize()
    assert (instance_norm.instance_norm_apply.launches,
            instance_norm.instance_norm_bwd_dx.launches) == (before[0] + 2 * size,
                                                              before[1] + 2 * size)
    assert _ulp_close(torch.cat(ys, 1), instance_norm.fused_instance_norm_plain(x, res, relu))
    assert _ulp_close(torch.cat(dxs, 1),
                      instance_norm.fused_instance_norm_bwd_plain(x, g, relu, stats=ms))


@pytest.mark.parametrize("shape,dtype", STEP_SLABS)
def test_partial_apply_and_dx_at_the_step_rank_slabs(cuda, shape, dtype):
    """The apply (ReLU, and the residual) and dx launches at a rank's slab of
    the spatial step against their plain versions on two ranks' statistics
    and sums (fp32 within 1e-5, bf16 within one ulp beyond it), two
    launches in a row bit-equal."""
    x = (_input(shape) * 3 + 1).to(cuda, dtype)
    g = _input(shape, seed=1).to(cuda, dtype)
    res = _input(shape, seed=2).to(cuda, dtype)
    st = instance_norm.instance_norm_stats(x)
    stats = torch.stack([st, instance_norm.instance_norm_stats(g)])
    for r, relu in ((None, True), (res, False)):
        y, ms = instance_norm.instance_norm_apply(x, r, stats, relu)
        assert torch.equal(y, instance_norm.instance_norm_apply(x, r, stats, relu)[0])
        want, want_ms = instance_norm.instance_norm_apply_plain(x, r, stats, relu)
        assert _ulp_close(y, want)
        assert (ms - want_ms).abs().max().item() <= 1e-5 * want_ms.abs().max().item()
    sums = torch.stack([instance_norm.instance_norm_bwd_sums(x, g, ms, True)] * 2)
    count = float(2 * shape[1] * shape[2])
    dx = instance_norm.instance_norm_bwd_dx(x, g, ms, sums, count, True)
    assert torch.equal(dx, instance_norm.instance_norm_bwd_dx(x, g, ms, sums, count, True))
    assert _ulp_close(dx, instance_norm.instance_norm_bwd_dx_plain(x, g, ms, sums, count, True))
    torch.cuda.synchronize()


def test_partial_kernels_reject_what_they_cannot_take(cuda):
    x = torch.zeros((1, 4, 4, 8), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="unsupported dtype"):
        instance_norm.instance_norm_stats(x)
    x = torch.zeros((1, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError, match="statistics of shape"):
        instance_norm.instance_norm_apply(x, None, torch.zeros((2, 1, 4, 3), device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_discriminator_pyramid_gradient_on_card_matches_cpu(cuda, dtype, monkeypatch):
    """The gradient through ``avg_pool_3s2`` and the multiscale
    discriminator on the card against the CPU's (F.avg_pool2d's backward of a
    channels-last input is wrong on the card; the pool takes NCHW): within
    1e-4 (fp32, TF32 off) or 1e-12 (float64) of its max-abs."""
    from jpdse_tpu_torch.models.discriminator import MultiscaleDiscriminator
    from jpdse_tpu_torch.models.layers import avg_pool_3s2

    torch.manual_seed(4)
    disc = MultiscaleDiscriminator(4, ndf=8, n_layers=3, num_D=2).to(dtype)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 64, 128, 4))).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for fn in (avg_pool_3s2, lambda t: [f for s in disc.to(t.device)(t) for f in s]):
        grads = []
        for dev in ("cpu", cuda):
            xi = x.to(dev).requires_grad_()
            out = fn(xi)
            outs = out if isinstance(out, list) else [out]
            torch.manual_seed(1)
            proj = [torch.randn(t.shape, dtype=dtype).to(dev) for t in outs]
            grads.append(torch.autograd.grad(sum((t * p).sum() for t, p in zip(outs, proj)),
                                             xi)[0].cpu())
        assert (grads[1] - grads[0]).abs().max() <= tol * grads[0].abs().max()


def test_batch_norm_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One GAN step of the tiny flagship with ``model.norm`` 'batch' (block
    remat, VGG), float64, deterministic binarization, on the card against
    the same step on the CPU from the same weights: the running statistics
    after the step within 1e-9 in relative L2, the metrics (handed over in
    fp32) within 2 of their ulps, every gradient within 1e-6 in relative L2
    (a bias a norm follows within 1e-9 absolute). The losses reduce in fp32
    in both packages (``train/losses.py``), so a float64 step's gradients
    carry one fp32 rounding of each loss's mean, which the card and the CPU
    round apart (about 2^-24 relative, the same with the instance norm);
    the forward, and with it the statistics, is float64 throughout."""
    from jpdse_tpu_torch.models.discriminator import build_discriminator
    from jpdse_tpu_torch.models.vgg import init_vgg19
    from jpdse_tpu_torch.ops import quantizers
    from jpdse_tpu_torch.train import step
    from jpdse_tpu_torch.train.state import create_train_state

    monkeypatch.setattr(quantizers, "stochastic_sign_ste",
                        lambda x, gen: quantizers.deterministic_sign_ste(x))
    cfg = flagship_config(tiny=True)
    cfg.model.compute_dtype, cfg.model.fast_inference, cfg.model.ndf = "float32", False, 8
    cfg.model.norm, cfg.optim.remat = "batch", True
    rng = np.random.default_rng(8)
    batch = {"label": torch.from_numpy(rng.integers(0, 35, (2, 64, 128)).astype(np.float32)),
             "instance": torch.from_numpy(rng.integers(0, 1000, (2, 64, 128)).astype(np.int32)),
             "image": torch.from_numpy(rng.normal(size=(2, 64, 128, 3)))}
    out = []
    for dev in ("cpu", cuda):
        codec = SemanticCodec(cfg, device="cpu", seed=12).double()
        codec.dtype = torch.float64
        disc = build_discriminator(cfg, "cpu", torch.Generator().manual_seed(3)).double()
        vgg = init_vgg19("cpu", torch.Generator().manual_seed(0)).double()
        state = create_train_state(cfg, codec.to(dev), disc.to(dev), vgg.to(dev))
        metrics, grads = step.loss_and_grads(
            state, {k: v.to(dev) for k, v in batch.items()}, torch.Generator(device=dev))
        named = [dict(zip([n for n, _ in m.named_parameters()], (g.cpu() for g in gs)))
                 for m, gs in zip((codec, disc), grads)]
        stats = {f"{i}.{k}": v.cpu() for i, m in enumerate((codec, disc))
                 for k, v in m.state_dict().items() if k.endswith(("BatchNorm_0.mean",
                                                                   "BatchNorm_0.var"))}
        out.append(({k: v.item() for k, v in metrics.items()}, named, stats))
    (want_m, want_g, want_s), (got_m, got_g, got_s) = out
    for k in step.METRICS:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=2 * 2.0**-23, atol=0, err_msg=k)
    normed_bias = re.compile(r"(^|\.)(head|down\.\d+|up(\.\d+)?|res\.\d+|layer[1-9])\."
                             r"(?!.*BatchNorm_0).*bias$")
    for g_net, w_net in zip(got_g, want_g):
        for n, w in w_net.items():
            if normed_bias.search(n):
                assert (g_net[n] - w).abs().max().item() <= 1e-9, n
            else:
                err = (g_net[n] - w).norm().item() / w.norm().item()
                assert err <= 1e-6, f"{n}: {err:.2e}"
    assert want_s and got_s.keys() == want_s.keys()
    for k, w in want_s.items():
        assert (got_s[k] - w).norm().item() <= 1e-9 * w.norm().item(), k


# -- the measurement entry points --------------------------------------------------------
def test_sem_wise_distortion_on_card_matches_cpu(cuda):
    """The per-class distortion on the card against the CPU: within 1e-6
    relative, absent classes exactly 0."""
    from jpdse_tpu_torch.ops.semantics import sem_wise_distortion

    rng = np.random.default_rng(21)
    present = np.array([0, 2, 3, 7, 9])
    ids = present[rng.integers(0, len(present), (2, 32, 48))]
    label = torch.from_numpy(np.eye(10, dtype=np.float32)[ids])
    real, fake = (torch.from_numpy(rng.normal(size=(2, 32, 48, 3)).astype(np.float32))
                  for _ in range(2))
    want = sem_wise_distortion(label, real, fake)
    got = sem_wise_distortion(label.to(cuda), real.to(cuda), fake.to(cuda)).cpu()
    absent = [c for c in range(10) if c not in present]
    assert (got[absent] == 0).all() and (want[absent] == 0).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


def test_seg_vgg_step_on_card_matches_cpu(cuda):
    """One seg-VGG step (train/seg_vgg.py) on the card against the CPU from
    the same weights and crops, TF32 off: the card's fp32 loss within 1e-4
    relative and each gradient within 1e-4 of its max-abs of the CPU's
    float64 step (the CPU's own fp32 conv backward misses its float64 by
    up to 2.8e-3 there: tests/test_torch_port_seg_vgg.py); the card's
    float64 step within 1e-9; the crops gathered on the card equal the
    CPU's, drawn from the same generator state."""
    from jpdse_tpu_torch.train import seg_vgg

    rng = np.random.default_rng(22)
    imgs = torch.from_numpy(rng.random((3, 96, 128, 3), np.float32) - 0.5)
    labs = torch.from_numpy(np.kron(rng.integers(0, 7, (3, 6, 8)),
                                    np.ones((1, 16, 16), np.int64)).astype(np.int32))
    draws = seg_vgg.draw_crops(torch.Generator(device=cuda).manual_seed(4), 3, 96, 128, 64, 2)
    xb_card, yb_card = seg_vgg.gather_crops(imgs.to(cuda), labs.to(cuda), *draws, 64)
    xb, yb = seg_vgg.gather_crops(imgs, labs, *(d.cpu() for d in draws), 64)
    assert torch.equal(xb_card.cpu(), xb) and torch.equal(yb_card.cpu(), yb)
    state = seg_vgg.init_seg_vgg(7, "cpu", torch.Generator().manual_seed(5)).state_dict()

    def step(dev, dtype):
        model = seg_vgg.SegVgg(7)
        model.load_state_dict(state)
        model = model.to(dev, dtype)
        loss = seg_vgg.loss_and_grads(model, xb.to(dev, dtype), yb.to(dev))
        return loss.item(), {k: p.grad.cpu().double() for k, p in model.named_parameters()}

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want_loss, want = step("cpu", torch.float64)
        for dtype, tol in ((torch.float32, 1e-4), (torch.float64, 1e-9)):
            loss, grads = step(cuda, dtype)
            assert abs(loss - want_loss) <= tol * abs(want_loss), (dtype, loss, want_loss)
            for k, w in want.items():
                assert (grads[k] - w).abs().max().item() <= tol * w.abs().max().item(), (dtype, k)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _rd_tree(root, n=2, crop=64):
    from PIL import Image

    rng = np.random.default_rng(23)
    for i in range(n):
        name = f"munster_{i:06d}_000019"
        d, g = root / "leftImg8bit/val/munster", root / "gtFine/val/munster"
        d.mkdir(parents=True, exist_ok=True)
        g.mkdir(parents=True, exist_ok=True)
        small = Image.fromarray(rng.integers(0, 256, (8, 16, 3), dtype=np.uint8))
        small.resize((2 * crop, crop), Image.BICUBIC).save(d / f"{name}_leftImg8bit.png")
        blocks = rng.integers(0, 34, (crop // 8, crop // 4))
        label = np.kron(blocks, np.ones((4, 4), np.int64))
        Image.fromarray(label.astype(np.uint8)).save(g / f"{name}_gtFine_labelIds.png")
        Image.fromarray((label * 10).astype(np.uint16)).save(
            g / f"{name}_gtFine_instanceIds.png")


@pytest.mark.parametrize("fast", [False, True], ids=["standard", "fast"])
def test_rd_tool_on_card_matches_cpu(cuda, tmp_path, fast):
    """eval/rd.py at tiny widths with device='cuda' against its CPU run on
    the same images: the bpp equal, the verdicts equal (and OK), each
    stack's PSNR within 0.01 dB and MS-SSIM within 1e-4 of the CPU's; the
    base mode's bytes equal and its PSNR within 1e-6 relative."""
    from jpdse_tpu_torch.eval import rd

    _rd_tree(tmp_path / "data")
    argv = ["parity", "--root", str(tmp_path / "data"), "--ext", "jpg", "--qualities", "50,90",
            "--n-images", "2", "--crop", "64", "--ngf", "8", "--n-down", "2", "--n-blocks", "2",
            "--out", str(tmp_path / "rd.json")] + (["--fast"] if fast else [])
    want, got = rd.main(argv, device="cpu"), rd.main(argv, device="cuda")
    assert got["ok"] and want["ok"]
    for p, w in zip(got["points"], want["points"]):
        assert p["bpp"] == w["bpp"] and p["verdict"] == w["verdict"] == "OK"
        for tag in ("port", "torch"):
            assert abs(p[f"psnr_{tag}"] - w[f"psnr_{tag}"]) <= 0.01
            assert abs(p[f"msssim_{tag}"] - w[f"msssim_{tag}"]) <= 1e-4
    if fast:
        base = ["base", "--root", str(tmp_path / "data"), "--ext", "jpg", "--qualities", "50",
                "--width", "64", "--height", "32", "--out", str(tmp_path / "base.json")]
        w, g = rd.main(base, device="cpu")["rows"][0], rd.main(base, device="cuda")["rows"][0]
        assert g["bpp"] == w["bpp"] and abs(g["psnr"] - w["psnr"]) <= 1e-6 * w["psnr"]
