"""Two GAN steps of the base-codec recipe
(``artifacts/flagship_r3_compressed``: raw one-hot semantics and the base
codec's decoded image into netG, no encoder, so no code) in the PyTorch
port against the JAX package's ``make_train_step``, at the tiny widths,
batch 2, fp32 on the CPU: phase A (the GAN with VGG, feature matching and
L1) and phase B (distortion only, D stepped on zero gradients), in the
default configuration and with K3 at every norm site. The batch carries
``compressed`` as the data pipeline makes it; the machinery and the
tolerances are ``test_torch_port_train_step.py``'s (a file of its own, so
the test runner's per-file distribution puts these steps on another
worker than that file's)."""

import pytest

from test_torch_port_train_step import run_steps
from test_torch_port_threads import port_test_threads  # noqa: F401


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused_instance_norm"])
@pytest.mark.parametrize("recipe", ["phaseA", "phaseB"])
def test_two_base_codec_train_steps_match_jax(recipe, fused, monkeypatch):
    metrics, state = run_steps(recipe, fused, 2, monkeypatch)
    codec = state.codec
    assert codec.netE is None and codec.netE4label is None
    assert codec.netG.head.conv.conv.weight.shape[1] == 39  # 35 labels, the edge map, RGB
    if recipe == "phaseB":
        assert all(float(metrics[k]) == 0.0 for k in ("G_GAN", "G_GAN_Feat", "G_VGG",
                                                        "D_real", "D_fake", "loss_D"))
    assert float(metrics["G_Distortion"]) > 0.0
