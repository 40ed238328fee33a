"""The test-mode ``Trainer``, the port of the evaluation half of
``jpdse_tpu/trainer.py``: ``load`` (:551), ``get_img`` (:316), ``get_code``
(:323), ``get_code_and_contexts`` (:333), ``get_eval_rate`` (:485),
``compress`` (:359) and ``decompress`` (:458), over ``serve.CodecServer``.

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
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from jpdse_tpu_torch import codec_io
from jpdse_tpu_torch.config import Config, check_ported
from jpdse_tpu_torch.models.codec import SemanticCodec
from jpdse_tpu_torch.ops.metrics import bernoulli_shannon_bpp
from jpdse_tpu_torch.platform import resolve_device
from jpdse_tpu_torch.serve import CodecServer
from jpdse_tpu_torch.train.checkpoint import restore_params

DEVICE_KEYS = ("label", "instance", "image")


class Trainer:
    def __init__(self, cfg: Config, mode: str = "test", device="cuda"):
        if mode == "train":
            raise NotImplementedError("Trainer(mode='train') (the GAN step, optimizers and "
                                      "save_checkpoint) is ROADMAP Queue 1 item 7")
        if cfg.optim.fp16 and cfg.model.compute_dtype == "float32":
            cfg.model.compute_dtype = "bfloat16"  # the fp16 flag selects bf16 compute
        cfg.validate()
        check_ported(cfg)
        self.cfg = cfg
        self.mode = mode
        self.device = resolve_device(device)
        self.start_epoch = 0
        std_cfg = copy.deepcopy(cfg)
        std_cfg.model.fast_inference = False
        # random weights from the seed until load(); the standard path's
        # module holds them
        init = SemanticCodec(std_cfg, device=self.device, seed=cfg.optim.seed or 0)
        self._std = CodecServer(std_cfg, init.state_dict(), device=self.device)
        del init
        self._fast_built = False
        self._fast_server: Optional[CodecServer] = None

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The codec's state dict (the port's ``params_g``)."""
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
        return self._server.decode(self.place(batch))

    def _shaped_codes(self, batch: Dict) -> List[torch.Tensor]:
        return self._server.compress_codes(self.place(batch))

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
        the codes, computed on the device from the standard path's codes;
        one host fetch of the two scalars."""
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
        """One ``.jpds`` stream per image of the batch."""
        return self._server.compress(batch)

    def decompress(self, data: bytes) -> np.ndarray:
        """One ``.jpds`` stream -> its image (H, W, 3), float32, from the
        stream and the weights alone."""
        return self._server.decompress(data)

    def load(self):
        """Restore the weights from ``checkpoints_dir`` (else ``save_dir``)."""
        ckpt_dir = self.cfg.checkpoints_dir or self.cfg.save_dir
        merged, _meta = restore_params(ckpt_dir, self.state)
        self._std.codec.load_state_dict(merged)
        # the fast path is rebuilt on the loaded weights
        self._fast_built = False
        self._fast_server = None
        print(f"checkpoint loaded; starting from epoch {self.start_epoch + 1}")
