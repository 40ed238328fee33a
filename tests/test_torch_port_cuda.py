"""Tests of the PyTorch port that need an NVIDIA GPU: the CUDA kernels
against their plain versions on the card, and the s2d serving path on the
card against the same path on the CPU. They skip without a card.

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
from jpdse_tpu_torch.ops import realign

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


def test_realign_kernel_rejects_what_it_cannot_take(cuda):
    y = _input((1, 8, 8, 16)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        realign.s2d_realign_pad3(y.transpose(1, 2))
    with pytest.raises(TypeError):
        realign.s2d_realign_pad3(y.to(torch.int32))
    with pytest.raises(ValueError, match="extra_rows"):
        realign.s2d_realign_pad3(y, extra_rows=20)


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
