"""The port's reference-checkpoint import (``convert/torch_import.py``) and
its copy of the reference-architecture stack (``convert/torch_ref.py``).

* The import of each network is bit-equal to the JAX package's
  ``convert/torch_import.py`` followed by the weight bridge
  (``from_jax_params``): the generator with its bottleneck binarizer before
  and after the res blocks and without one, both encoders, the multiscale
  discriminator, and ``import_reference_checkpoint`` on a directory of
  ``net_*.pth``.
* The port's ``torch_ref`` builds the JAX package's copy's keys, weights
  and outputs.
* After the import, the port's decode (``Trainer.load`` on a directory of
  ``net_*.pth``, the standard path in fp32) matches ``RefLearnedCodec``
  within 2e-4, and the evaluation entry point reads such a directory too;
  a training Trainer imports it, ``net_D.pth`` included, with fresh Adams
  from epoch 1.

The weights are synthetic (``reference_weights_init`` from a seed): no
reference checkpoint is in the repository.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from jpdse_tpu.convert import torch_import as jax_import
from jpdse_tpu.convert import torch_ref as jax_ref
from jpdse_tpu_torch.config import Config, flagship_config
from jpdse_tpu_torch.convert import from_jax_params, torch_import, torch_ref
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import build_discriminator
from jpdse_tpu_torch.trainer import Trainer
from test_torch_port_threads import port_test_threads  # noqa: F401

NGF, N_DOWN, N_BLOCKS, BITS, LABEL_OUT = 8, 2, 2, 16, 8
H, W = 64, 128


def _equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def _bridged(tree: dict) -> dict:
    return from_jax_params(tree)


@pytest.mark.parametrize("binarizer", ["none", "after_res", "before_res"])
def test_generator_import_equals_jax_import_and_bridge(binarizer):
    torch.manual_seed(3)
    bits = None if binarizer == "none" else BITS
    g = torch_ref.RefGlobalGenerator(11, 3, NGF, N_DOWN, N_BLOCKS, bits,
                                     binarizer == "before_res")
    g.apply(torch_ref.reference_weights_init)
    kw = dict(binarize=bits is not None, bin_before_res=binarizer == "before_res")
    got = torch_import.convert_global_generator(g.state_dict(), N_DOWN, N_BLOCKS, **kw)
    _equal(got, _bridged(jax_import.convert_global_generator(g.state_dict(), N_DOWN, N_BLOCKS,
                                                             **kw)))
    # the names are the port's GlobalGenerator's, and it decodes as the reference does
    cfg = _codec_config(g_binarizer=binarizer)
    codec = SemanticCodec(cfg, device="cpu", seed=None)
    assert sorted(got) == sorted(k[5:] for k in codec.state_dict() if k.startswith("netG."))
    codec.netG.load_state_dict(got)
    x = torch.randn(1, H, W, 11)
    with torch.no_grad():
        want = g(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(codec.netG(x).numpy(), want.numpy(), rtol=0, atol=2e-4)


@pytest.mark.parametrize("binarize", [True, False], ids=["binarized", "unbinarized"])
def test_encoder_import_equals_jax_import_and_bridge(binarize):
    torch.manual_seed(4)
    e = torch_ref.RefEncoder(36, LABEL_OUT, NGF, N_DOWN, BITS)
    e.apply(torch_ref.reference_weights_init)
    sd = e.state_dict()
    if not binarize:  # the reference's unbinarized encoder: no Binarizer, the rest one index up
        cut = 1 + 3 * (N_DOWN + 1)  # after the pad, the head's three and the downs' three each
        sd = {_shift(k, cut): v for k, v in sd.items() if not k.startswith(f"model.{cut}.")}
    got = torch_import.convert_encoder(sd, N_DOWN, binarize=binarize)
    _equal(got, _bridged(jax_import.convert_encoder(sd, N_DOWN, binarize=binarize)))


def _shift(key: str, cut: int) -> str:
    i = int(key.split(".")[1])
    return f"model.{i - 1 if i > cut else i}." + key.split(".", 2)[2]


def _reference_d(d, cfg) -> dict:
    """The reference's getIntermFeat layout of the port's discriminator:
    ``scale{i}_layer{j}.0`` for ``scale{i}.layer{j}`` and ``scale{i}.pred``."""
    ref = {}
    for k, v in d.state_dict().items():
        scale, layer = k.split(".")[:2]
        j = cfg.model.n_layers_D + 1 if layer == "pred" else int(layer[5:])
        ref[f"{scale}_layer{j}.0.{k.split('.')[-1]}"] = v.clone()
    return ref


def test_discriminator_import_equals_jax_import_and_bridge():
    cfg = _codec_config()
    d = build_discriminator(cfg, "cpu", torch.Generator().manual_seed(5))
    ref = _reference_d(d, cfg)
    got = torch_import.convert_multiscale_discriminator(ref, cfg.model.num_D, cfg.model.n_layers_D)
    _equal(got, _bridged(jax_import.convert_multiscale_discriminator(
        ref, cfg.model.num_D, cfg.model.n_layers_D)))
    _equal(got, {k: v.float() for k, v in d.state_dict().items()})


def _codec_config(g_binarizer: str = "none") -> Config:
    """The tiny flagship (netE4label and netE binarized, 16 bits each) in
    fp32 on the standard path; or its generator binarized instead."""
    cfg = flagship_config(tiny=True)
    m = cfg.model
    m.compute_dtype, m.fast_inference = "float32", False
    if g_binarizer != "none":
        m.no_generator_binarization = False
        m.no_encoder_binarization = m.no_label_encoder_binarization = True
        m.generator_binarizer_out_channels = BITS
        m.bin_generator_before_res = g_binarizer == "before_res"
    cfg.validate()
    return cfg


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """A reference checkpoint directory of RefLearnedCodec's networks at the
    tiny flagship's widths, weights from reference_weights_init (seed 0),
    and a net_D.pth."""
    ckpt = tmp_path_factory.mktemp("reference")
    golden = torch_ref.RefLearnedCodec(semantic_nc=35, label_out=LABEL_OUT, feat_num=3,
                                       ngf=NGF, nef=NGF, ne4lf=NGF, n_down=N_DOWN,
                                       enc_bits=BITS, lab_bits=BITS, n_blocks=N_BLOCKS, seed=0)
    for name in ("netG", "netE", "netE4label"):
        torch.save(getattr(golden, name).state_dict(), ckpt / f"{name.replace('net', 'net_')}.pth")
    cfg = _codec_config()
    d = build_discriminator(cfg, "cpu", torch.Generator().manual_seed(6))
    torch.save(_reference_d(d, cfg), ckpt / "net_D.pth")
    return ckpt, golden, d


def test_checkpoint_dir_import_equals_jax(reference_dir):
    ckpt, _, _ = reference_dir
    cfg = _codec_config()
    from jpdse_tpu.config import Config as JaxConfig

    got = torch_import.import_reference_checkpoint(str(ckpt), cfg, {})
    want = jax_import.import_reference_checkpoint(str(ckpt), JaxConfig.from_dict(cfg.to_dict()),
                                                  {})
    _equal(got, _bridged(want))


def test_port_torch_ref_is_the_jax_copy():
    kw = dict(semantic_nc=35, label_out=LABEL_OUT, feat_num=3, ngf=NGF, nef=NGF, ne4lf=NGF,
              n_down=N_DOWN, enc_bits=BITS, lab_bits=BITS, n_blocks=N_BLOCKS, seed=0)
    ours, theirs = torch_ref.RefLearnedCodec(**kw), jax_ref.RefLearnedCodec(**kw)
    _equal(ours.state_dict(), theirs.state_dict())
    rng = np.random.default_rng(8)
    label, inst = rng.integers(0, 35, (H, W)), rng.integers(0, 6, (H, W))
    img = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    a = torch_ref.phase2_generator_input(label, inst, img)
    assert np.array_equal(a, jax_ref.phase2_generator_input(label, inst, img))
    x = torch.from_numpy(a[..., :36].transpose(2, 0, 1)[None].copy())
    y = torch.from_numpy(img.transpose(2, 0, 1)[None].copy())
    with torch.no_grad():
        assert torch.equal(ours(x, y), theirs(x, y))
    g = jax_ref.build_phase2_generator(ngf=NGF, n_downsampling=N_DOWN, n_blocks=N_BLOCKS)
    _equal(torch_ref.build_phase2_generator(ngf=NGF, n_downsampling=N_DOWN,
                                            n_blocks=N_BLOCKS).state_dict(), g.state_dict())
    assert np.array_equal(torch_ref.torch_decode(torch_ref.build_phase2_generator(
        ngf=NGF, n_downsampling=N_DOWN, n_blocks=N_BLOCKS), a), jax_ref.torch_decode(g, a))


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"label": rng.integers(0, 35, (1, H, W)).astype(np.float32),
            "instance": rng.integers(0, 6, (1, H, W)).astype(np.int32),
            "image": rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)}


def _golden(golden, batch: dict) -> np.ndarray:
    oh = torch_ref.phase2_generator_input(batch["label"][0], batch["instance"][0],
                                          np.zeros_like(batch["image"][0]))[..., :36]
    with torch.no_grad():
        out = golden(torch.from_numpy(oh.transpose(2, 0, 1)[None].copy()),
                     torch.from_numpy(batch["image"][0].transpose(2, 0, 1)[None].copy()))
    return out.numpy().transpose(0, 2, 3, 1)


def test_imported_decode_matches_the_reference_stack(reference_dir):
    """Trainer.load on the directory (no params_g.pt) imports the networks;
    the decode matches RefLearnedCodec within 2e-4 in fp32."""
    ckpt, golden, _ = reference_dir
    cfg = _codec_config()
    cfg.checkpoints_dir = str(ckpt)
    with redirect_stdout(io.StringIO()) as log:
        trainer = Trainer(cfg, mode="test", device="cpu")
        trainer.load()
    assert "imported the reference checkpoint" in log.getvalue()
    for seed in (9, 10):
        batch = _batch(seed)
        np.testing.assert_allclose(trainer.get_img(batch).numpy(), _golden(golden, batch),
                                   rtol=0, atol=2e-4)


def test_training_trainer_imports_the_reference_with_its_discriminator(reference_dir):
    ckpt, golden, d = reference_dir
    cfg = _codec_config()
    cfg.checkpoints_dir = str(ckpt)
    cfg.loss.no_vgg_loss = True
    with redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, mode="train", device="cpu")
        trainer.load()
    assert trainer.start_epoch == 0 and trainer.steps_taken == 0
    assert not trainer.gan.opt_g.state  # fresh Adams
    _equal(trainer.gan.disc.state_dict(), {k: v.float() for k, v in d.state_dict().items()})
    want = torch_import.convert_global_generator(golden.netG.state_dict(), N_DOWN, N_BLOCKS)
    assert all(torch.equal(trainer.gan.codec.netG.state_dict()[k], v) for k, v in want.items())


def test_evaluation_entry_point_reads_a_reference_dir(reference_dir, tmp_path):
    """test.main with --checkpoints_dir on the directory: the reconstruction
    it scores is the reference stack's."""
    from jpdse_tpu_torch import test as test_entry
    from test_torch_port_train_e2e import write_tree

    ckpt, golden, _ = reference_dir
    root = tmp_path / "cityscapes"
    write_tree(root, n=1)
    argv = ["--dataset", "cityscapes", "--root_dir", str(root), "--mode", "val",
            "--checkpoints_dir", str(ckpt), "--save_dir", str(tmp_path / "eval"),
            "--ngf", "8", "--nef", "8", "--ne4lf", "8", "--n_downsample_global", "2",
            "--n_blocks_global", "2", "--n_downsample_E", "2", "--n_downsample_E4label", "2",
            "--encoder_binarizer_out_channels", "16",
            "--label_encoder_binarizer_out_channels", "16", "--label_encoder_out_channels", "8",
            "--no_generator_binarization", "--fast_inference", "0", "--compute_dtype", "float32",
            "--test_preprocess_mode", "fixed", "--test_load_size", str(W), "--test_crop_size",
            str(W), "--val_preprocess_mode", "fixed", "--val_load_size", str(W),
            "--val_crop_size", str(W)]
    with redirect_stdout(io.StringIO()) as log:
        metrics = test_entry.main(argv, device="cpu")
    assert "imported the reference checkpoint" in log.getvalue()
    assert metrics["n_images"] == 1 and np.isfinite(metrics["PSNR"])
