"""The ``Trainer``, the port of ``jpdse_tpu/trainer.py``.

In evaluation (``mode`` 'test' or 'val'): ``load`` (:551), ``get_img``
(:316), ``get_code`` (:323), ``get_code_and_contexts`` (:333),
``get_eval_rate`` (:485), ``compress`` (:359) and ``decompress`` (:458),
over ``serve.CodecServer``.

In training (``mode='train'``): the GAN step (``train/step.py``) over one
``train/state.py::GANTrainState`` (``self.gan``): ``step`` /
``step_async`` / ``fetch_metrics`` (:300-320, the eight metrics as one
stacked host fetch), ``get_eval_loss``, ``get_img`` (the standard path, as
JAX's training Trainer has no fast path), ``scheduler_step``, ``save``,
``save_latest``, ``load`` (resuming from ``save_dir/latest`` when it is
newer, :551-579), ``current_lr``, ``best_val_loss`` and ``steps_taken``.
The code, rate and stream methods raise in training: they serve saved
weights through a test-mode Trainer. They take any number of codes (one per
binarized module); the code methods raise without one.
The binarizers' and the pool's draws come from one ``torch.Generator``
seeded by ``optim.seed``; the discriminator's weights from seed 3 and
VGG's (without a weights file) from 0, the numbers of the JAX Trainer's
keys (the draws differ).

The fast path is chosen by ``cfg.model.fast_inference`` as the JAX
package's ``Trainer._fast`` chooses it (:188-228): built once, on the loaded
weights, with a printed fallback to the standard path for a configuration
the fast codec rejects with ``ValueError`` / ``KeyError``. That is a choice
by configuration only: a kernel that fails to build or launch raises. The
rate, as in the JAX package, comes from the standard path's codes.

Batches are the loader's numpy dicts or dicts of tensors already on the
device (:meth:`place`); outputs of the device path stay tensors on the
device, and codes for the host's range coder are numpy.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.config import Config, check_ported, check_train_ported
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.models.discriminator import build_discriminator
from jpdse_tpu_torch.models.vgg import init_vgg19
from jpdse_tpu_torch.ops.metrics import bernoulli_shannon_bpp
from jpdse_tpu_torch.platform import resolve_device
from jpdse_tpu_torch.serve import CodecServer
from jpdse_tpu_torch.train import step as train_step
from jpdse_tpu_torch.train.checkpoint import (
    meta_epoch,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from jpdse_tpu_torch.train.schedule import ReduceLROnPlateau
from jpdse_tpu_torch.train.state import GANTrainState, create_train_state, get_lr, set_lr

DEVICE_KEYS = ("label", "instance", "image")


def train_image_hw(cfg: Config) -> Tuple[int, int]:
    """(H, W) of a training batch under the config's preprocessing, as the
    JAX Trainer's synthetic sample batch has it."""
    pp = cfg.data.preprocess
    if pp.preprocess_mode == "fixed":
        return round(pp.crop_size / pp.aspect_ratio), pp.crop_size
    return pp.crop_size, pp.crop_size


class Trainer:
    def __init__(self, cfg: Config, mode: str = "test", device="cuda"):
        if cfg.optim.fp16 and cfg.model.compute_dtype == "float32":
            cfg.model.compute_dtype = "bfloat16"  # the fp16 flag selects bf16 compute
        cfg.validate()
        (check_train_ported if mode == "train" else check_ported)(cfg)
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.start_epoch = 0
        if mode == "train":
            self._init_train()
            return
        std_cfg = copy.deepcopy(cfg)
        std_cfg.model.fast_inference = False
        # random weights from the seed until load(); the standard path's
        # module holds them
        init = SemanticCodec(std_cfg, device=self.device, seed=cfg.optim.seed or 0)
        self._std = CodecServer(std_cfg, init.state_dict(), device=self.device)
        del init
        self._fast_built = False
        self._fast_server: Optional[CodecServer] = None

    def _init_train(self):
        cfg, dev = self.cfg, self.device
        seed = cfg.optim.seed or 0
        codec = SemanticCodec(cfg, device=dev, seed=seed)
        disc = build_discriminator(cfg, dev, torch.Generator(device=dev).manual_seed(3))
        vgg = None
        if not cfg.loss.no_vgg_loss:
            vgg = init_vgg19(dev, torch.Generator(device=dev).manual_seed(0),
                             cfg.loss.vgg_weights_path)
        h, w = train_image_hw(cfg)
        self.gan: GANTrainState = create_train_state(cfg, codec, disc, vgg,
                                                     (h, w, cfg.netD_input_nc))
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.sched: Optional[ReduceLROnPlateau] = None
        if cfg.optim.schedule_lr:
            self.sched = ReduceLROnPlateau(lr=cfg.optim.lr, factor=cfg.optim.lr_decay_factor,
                                           patience=cfg.optim.lr_decay_patience)

    def _need_train(self):
        if self.mode != "train":
            raise RuntimeError(f"Trainer(mode={self.mode!r}) does not train: build it with "
                               "mode='train'")

    def _need_eval(self):
        if self.mode == "train":
            raise RuntimeError("Trainer(mode='train') does not serve codes or streams: build "
                               "one with mode='test' or 'val' on the saved weights")

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The codec's state dict (the port's ``params_g``)."""
        if self.mode == "train":
            return self.gan.codec.state_dict()
        return self._std.codec.state_dict()

    @property
    def _fast(self) -> Optional[CodecServer]:
        """The s2d fast path's server when ``model.fast_inference`` is set and
        the fast codec accepts the config, else None; built lazily, once, on
        the current weights."""
        if self._fast_built:
            return self._fast_server
        self._fast_built = True
        if not self.cfg.model.fast_inference:
            return None
        try:
            self._fast_server = CodecServer(self.cfg, self.state, device=self.device)
            print("fast inference path enabled (space-to-depth codec)")
        except (ValueError, KeyError) as e:
            print(f"fast_inference unavailable for this config "
                  f"({type(e).__name__}: {e}); using the standard path")
        return self._fast_server

    @property
    def _server(self) -> CodecServer:
        self._need_eval()
        return self._fast or self._std

    def place(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The device fields of a batch on the trainer's device: numpy arrays
        through pinned memory with a non-blocking copy, tensors already there
        passed through."""
        out = {}
        for k in DEVICE_KEYS:
            if k not in batch:
                continue
            v = batch[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
                if self.device.type == "cuda":
                    v = v.pin_memory()
            out[k] = v.to(self.device, non_blocking=True)
        return out

    # -- evaluation protocol -------------------------------------------------
    def get_img(self, batch: Dict) -> torch.Tensor:
        """Reconstruction (B, H, W, 3), float32, on the device."""
        if self.mode == "train":
            with torch.inference_mode():
                codec = self.gan.codec
                return codec.decode(codec.prepare(self.place(batch)))[0].float()
        return self._server.decode(self.place(batch))

    def _shaped_codes(self, batch: Dict) -> List[torch.Tensor]:
        """One code per binarized module; raises where there is none."""
        codes = self._server.compress_codes(self.place(batch))
        if not codes:
            raise ValueError("no binarized module in this configuration")
        return codes

    def get_code(self, batch: Dict) -> np.ndarray:
        """Concatenated flat binary codes (B, n_bits), uint8 in {0, 1}."""
        codes = self._shaped_codes(batch)
        return torch.cat([c.reshape(c.shape[0], -1) for c in codes], dim=-1).cpu().numpy()

    def get_code_and_contexts(
        self, batch: Dict
    ) -> Tuple[np.ndarray, np.ndarray, List[Tuple[int, int, int]]]:
        """(codes, contexts, shapes): the concatenated flat codes (B, n_bits),
        the per-bit context ids of the per-channel coder, and each code's
        (h, w, c) for the spatial coder; both context schemes follow from
        the shapes alone."""
        shaped = [c.cpu().numpy() for c in self._shaped_codes(batch)]
        flats = [c.reshape(c.shape[0], -1) for c in shaped]
        shapes = [tuple(c.shape[1:]) for c in shaped]
        return np.concatenate(flats, axis=-1), codec_io.contexts_for_shapes(shapes), shapes

    @torch.inference_mode()
    def get_eval_rate(self, batch: Dict) -> Tuple[float, float]:
        """(shannon_bpp, actual_bpp) averaged over the batch and summed over
        the codes (0 without a code), computed on the device from the
        standard path's codes; one host fetch of the two scalars."""
        self._need_eval()
        b = self.place(batch)
        codec = self._std.codec
        codes = codec.get_codes_shaped(codec.prepare(b))
        num_pixels = b["image"].shape[1] * b["image"].shape[2]
        shannon = torch.zeros((), device=self.device)
        actual = torch.zeros((), device=self.device)
        for code in codes:
            s, a = zip(*(bernoulli_shannon_bpp(c, num_pixels) for c in code))
            shannon = shannon + torch.stack(s).mean()
            actual = actual + torch.stack(a).mean()
        s_v, a_v = torch.stack([shannon, actual]).cpu().tolist()
        return s_v, a_v

    def compress(self, batch: Dict) -> List[bytes]:
        """One ``.jpds`` stream per image of the batch; a configuration
        whose streams need side info raises (``CodecServer.compress``)."""
        return self._server.compress(batch)

    def decompress(self, data: bytes) -> np.ndarray:
        """One ``.jpds`` stream -> its image (H, W, 3), float32, from the
        stream and the weights alone."""
        return self._server.decompress(data)

    def load(self):
        """Restore the weights from ``checkpoints_dir`` (else ``save_dir``);
        in training the whole state, from ``save_dir/latest`` when that is
        the same directory's newer save."""
        ckpt_dir = self.cfg.checkpoints_dir or self.cfg.save_dir
        if self.mode == "train":
            self._load_train(ckpt_dir)
            return
        merged, _meta = restore_params(ckpt_dir, self.state)
        self._std.codec.load_state_dict(merged)
        # the fast path is rebuilt on the loaded weights
        self._fast_built = False
        self._fast_server = None
        print(f"checkpoint loaded; starting from epoch {self.start_epoch + 1}")

    # -- training protocol ---------------------------------------------------
    def step_async(self, batch: Dict):
        """One G and D update, without waiting for the metrics: returns a
        handle for :meth:`fetch_metrics`, the eight metrics stacked on the
        device in sorted order."""
        self._need_train()
        metrics, grads = train_step.loss_and_grads(self.gan, self.place(batch), self.generator)
        del batch
        train_step.apply(self.gan, grads)
        del grads
        return train_step.METRICS, torch.stack([metrics[k] for k in train_step.METRICS])

    @staticmethod
    def fetch_metrics(handle) -> Dict[str, float]:
        """The metrics of a :meth:`step_async` handle, in one host fetch."""
        keys, stacked = handle
        return dict(zip(keys, stacked.cpu().tolist()))

    def step(self, batch: Dict) -> Dict[str, float]:
        """One G and D update; returns the eight metrics."""
        return self.fetch_metrics(self.step_async(batch))

    def get_eval_loss(self, batch: Dict) -> float:
        self._need_train()
        return float(train_step.eval_loss(self.gan, self.place(batch)))

    def scheduler_step(self, val_loss: float):
        if self.sched is not None:
            set_lr(self.gan, self.sched.step(val_loss))

    def _meta(self, **extra) -> Dict:
        if self.sched is not None:
            extra["scheduler"] = self.sched.state_dict()
        return extra

    def save(self, epoch: int, val_loss: float):
        """The best-val checkpoint in ``save_dir``."""
        self._need_train()
        self.gan.best_val_loss = float(np.float32(val_loss))
        save_checkpoint(self.cfg.save_dir, self.gan, epoch, self._meta())
        print(f"\ncheckpoint saved to {self.cfg.save_dir}\n")

    def save_latest(self, epoch: int):
        """The exact current state in ``save_dir/latest``: a resume point
        beside the best-val checkpoint, which model selection reads."""
        self._need_train()
        latest = os.path.join(self.cfg.save_dir, "latest")
        save_checkpoint(latest, self.gan, epoch, self._meta(latest=True))
        print(f"\nlatest-state checkpoint saved to {latest}\n")

    def _load_train(self, ckpt_dir: str):
        cfg = self.cfg
        if cfg.save_dir and os.path.abspath(ckpt_dir) == os.path.abspath(cfg.save_dir):
            latest = os.path.join(ckpt_dir, "latest")
            if meta_epoch(latest) > meta_epoch(ckpt_dir):
                print("resuming from latest-state checkpoint (newer than best-val)")
                ckpt_dir = latest
        meta = restore_checkpoint(ckpt_dir, self.gan, restore_opt=True)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        if self.sched is not None and "scheduler" in meta:
            self.sched.load_state_dict(meta["scheduler"])
            set_lr(self.gan, self.sched.lr)
        print(f"checkpoint loaded; starting from epoch {self.start_epoch + 1} with "
              f"{self.steps_taken} steps taken")

    @property
    def current_lr(self) -> float:
        return get_lr(self.gan)

    @property
    def best_val_loss(self) -> float:
        return self.gan.best_val_loss

    @property
    def steps_taken(self) -> int:
        return self.gan.steps_taken
