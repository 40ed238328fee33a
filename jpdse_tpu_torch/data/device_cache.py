"""Device-resident dataset cache, the port of
``jpdse_tpu/data/device_cache.py``: the training set is uploaded to the
card once and each batch is assembled there (gather, flip, decompression),
so a training step copies two small integer vectors to the card instead of
its pixels.

Exactness: the cached samples come from the dataset's own ``__getitem__``
with the flip off (decode, resize, normalize and ``postprocess`` run as on
the host path); the only work on the card is the flip, a reversal along W,
the gather and a lookup that restores the stored values exactly, so a
batch equals the host path's bit for bit. The loader's meta mode
(``DataLoader.meta_only``) makes the host path's seeded draws, so the
(index, flip) sequence is the host path's.

It applies where ``cache_images`` is active (deterministic 'fixed' or
'none' preprocessing), the dataset replays its draws (``meta_only``), the
samples stack, and the set fits the budget: 2.0 GB for training, 1.0 GB for
validation, the JAX package's numbers, so one config gets one decision in
both packages. Under ``use_compressed`` both flip variants of the base
codec's decoded image are cached (the codec's round trip is not
flip-equivariant) and picked by index. Anything else declines with the JAX
package's printed reason and the host batches are used: a run over a
process group among them (a mesh, or more than one process), whose
batches are per-rank shards.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

from jpdse_tpu_torch.data.prefetch import to_device
from jpdse_tpu_torch.parallel import distributed

# per-modality stacked arrays cached on the device; everything else stays on the host
CACHE_KEYS = ("image", "label", "instance")


def _compact_modality(v: np.ndarray):
    """A stacked modality in its narrowest exact storage: a float image as
    uint8 and a per-channel 256-entry lookup table (each channel's sorted
    distinct values; kept only if the round trip is exact, which images
    normalized from uint8 always are), a float id map with integral values
    in [0, 255] as uint8, an int32 id map within uint16's range as uint16;
    else as it is. Returns (stored array, table or None, dtype to restore
    or None)."""
    if v.dtype == np.float32 and v.ndim == 4:
        c = v.shape[-1]
        flat = v.reshape(-1, c)
        lut = np.zeros((256, c), np.float32)
        u8 = np.zeros(flat.shape, np.uint8)
        for ch in range(c):
            vals = np.unique(flat[:, ch])
            if vals.size > 256:
                return v, None, None
            lut[: vals.size, ch] = vals
            lut[vals.size:, ch] = vals[-1] if vals.size else 0.0
            u8[:, ch] = np.searchsorted(vals, flat[:, ch]).astype(np.uint8)
        if np.array_equal(lut[u8, np.arange(c)[None, :]], flat):
            return u8.reshape(v.shape), lut, None
        return v, None, None
    if v.dtype == np.float32 and v.ndim == 3:
        if np.array_equal(v, np.round(v)) and v.min() >= 0 and v.max() <= 255:
            return v.astype(np.uint8), None, torch.float32
        return v, None, None
    if v.dtype == np.int32:
        if v.min() >= 0 and v.max() <= np.iinfo(np.uint16).max:
            return v.astype(np.uint16), None, torch.int32
        return v, None, None
    return v, None, None


def _assemble(ds: Dict[str, torch.Tensor], idx: torch.Tensor, flip: torch.Tensor,
              luts: Dict[str, torch.Tensor], out_dtypes: Dict[str, torch.dtype]
              ) -> Dict[str, torch.Tensor]:
    """Gather samples ``idx`` of the resident arrays, flip the ones ``flip``
    selects along W, restore compact storage; ``compressed`` is stored in
    both flip variants ((2N, H, W, C), index * 2 + flip) and picked."""
    out = {}
    for k, v in ds.items():
        if k == "compressed":
            g = v.index_select(0, idx * 2 + flip.long())
        else:
            g = v.index_select(0, idx)  # (B, H, W[, C])
            cond = flip.view((-1,) + (1,) * (g.ndim - 1))
            g = torch.where(cond, g.flip(2), g)
        if k in luts:
            lut = luts[k]  # (256, C): value row by stored byte, channel column
            c = g.shape[-1]
            g = lut.reshape(-1).take(g.long() * c + torch.arange(c, device=g.device))
        elif g.dtype == torch.int16:  # uint16 storage, held as its bits
            g = g.to(out_dtypes[k]) & 0xFFFF
        elif k in out_dtypes:
            g = g.to(out_dtypes[k])
        out[k] = g
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``; uint16, which few PyTorch ops take, as the int16
    of the same bits."""
    a = np.ascontiguousarray(a)
    return to_device(a.view(np.int16) if a.dtype == np.uint16 else a, device)


class DeviceDatasetCache:
    """The stacked dataset on ``device``, and placed batches assembled from
    the loader's meta batches ({"index", "flip", "path"})."""

    def __init__(self, dataset, cfg, device):
        self.dataset, self.cfg = dataset, cfg
        self.device = device = torch.device(device)
        n = len(dataset)
        # the host __getitem__ with the flip forced off; the flip runs on the device
        no_flip_prev = cfg.data.no_flip
        cfg.data.no_flip = True
        try:
            samples = [dataset.__getitem__(i, rng=np.random.default_rng(0)) for i in range(n)]
        finally:
            cfg.data.no_flip = no_flip_prev
        host = {k: np.stack([s[k] for s in samples]) for k in CACHE_KEYS if k in samples[0]}
        del samples
        if cfg.codec.use_compressed:
            # both flip variants, interleaved (i * 2 + flip); the dataset memoizes them
            host["compressed"] = np.stack([dataset._compressed_arrays(i, f)[0]
                                           for i in range(n) for f in (False, True)])
        self.luts: Dict[str, torch.Tensor] = {}
        self.out_dtypes: Dict[str, torch.dtype] = {}
        self.nbytes = 0
        self.ds: Dict[str, torch.Tensor] = {}
        for k, v in host.items():
            stored, lut, out_dtype = _compact_modality(v)
            self.nbytes += stored.nbytes
            self.ds[k] = _to_device(stored, device)
            if lut is not None:
                self.luts[k] = _to_device(lut, device)
            elif out_dtype is not None:
                self.out_dtypes[k] = out_dtype

    def place(self, meta_batch: Dict) -> Dict:
        """The batch of ``meta_batch``'s (index, flip) on the device, with its
        paths."""
        idx = _to_device(np.asarray(meta_batch["index"], np.int64), self.device)
        flip = _to_device(np.asarray(meta_batch["flip"], bool), self.device)
        out = _assemble(self.ds, idx, flip, self.luts, self.out_dtypes)
        out["path"] = meta_batch.get("path")
        return out


class CachedValBatches:
    """The validation loader's batches placed on the device once (its array
    fields; host fields such as paths as they are) and replayed on every
    later validation and reconstruction dump. Evaluation never flips and
    the gate requires the deterministic cached preprocessing, so every pass
    would have made these arrays anyway."""

    def __init__(self, val_loader, device, cap: Optional[int] = None):
        device = torch.device(device)
        self.batches = []
        self.nbytes = 0
        for i, batch in enumerate(val_loader):
            if cap is not None and i >= cap:
                break
            placed = {}
            for k, v in batch.items():
                if isinstance(v, np.ndarray) and v.dtype != object:
                    self.nbytes += v.nbytes
                    placed[k] = _to_device(v, device)
                else:
                    placed[k] = v
            self.batches.append(placed)

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _multi_device(mesh) -> Optional[str]:
    """Why a run on several devices declines the cache (JAX's words,
    ``jpdse_tpu/data/device_cache.py:257-260``), else None."""
    if mesh is not None:
        return "mesh sharding places batches per-shard"
    if distributed.world() > 1:
        return "multi-host feeds per-rank shards"
    return None


def maybe_val_cache(val_loader, cfg, device, cap: Optional[int] = None,
                    max_gb: float = 1.0, mesh=None) -> Optional[CachedValBatches]:
    """A CachedValBatches when the config allows it, else None (with the
    reason printed where the user asked for cache_images): the flag, the
    dataset's deterministic cached preprocessing, and the budget estimated
    from the first batch, which the cache then keeps (built once)."""
    if not getattr(cfg.data, "device_cache", False):
        return None

    def decline(reason: str):
        if cfg.data.cache_images:
            print(f"val device_cache unavailable: {reason}; using host batches")
        return None

    if not getattr(val_loader.dataset, "_cache_enabled", False):
        return decline("requires cache_images with deterministic preprocessing")
    if _multi_device(mesh):
        return decline(_multi_device(mesh))
    it = iter(val_loader)
    try:
        first = next(it)
    except StopIteration:
        return decline("empty val set")
    per_batch = sum(v.nbytes for v in first.values()
                    if isinstance(v, np.ndarray) and v.dtype != object)
    n = len(val_loader) if cap is None else min(len(val_loader), cap)
    if per_batch * n > max_gb * 1024**3:
        return decline(f"val set ~{per_batch * n / 1024**3:.2f}GB exceeds the "
                       f"{max_gb}GB HBM budget")
    cache = CachedValBatches(itertools.chain([first], it), device, cap=cap)
    print(f"val device_cache: {len(cache)} batches ({cache.nbytes / 1024**2:.0f}MB) resident "
          f"on device; validation H2D eliminated")
    return cache


def maybe_device_cache(loader, cfg, device, max_gb: float = 2.0, mesh=None
                       ) -> Optional[DeviceDatasetCache]:
    """A DeviceDatasetCache when the config allows it, else None (with the
    reason printed where the user asked for cache_images)."""
    if not getattr(cfg.data, "device_cache", False):
        return None

    def decline(reason: str):
        if cfg.data.cache_images:
            print(f"device_cache unavailable: {reason}; using host batches")
        return None

    dataset = loader.dataset
    if not getattr(dataset, "_cache_enabled", False):
        return decline("requires cache_images with deterministic preprocessing")
    if cfg.codec.use_compressed and not hasattr(dataset, "_compressed_arrays"):
        return decline("dataset cannot memoize base-codec round trips")
    if _multi_device(mesh):
        return decline(_multi_device(mesh))
    n = len(dataset)
    try:
        dataset.__getitem__(0, rng=np.random.default_rng(0), meta_only=True)
    except TypeError:
        # a dataset whose __getitem__ has no meta replay (ADE20K's override)
        return decline(f"{type(dataset).__name__} does not support meta replay")
    probe = dataset.__getitem__(0, rng=np.random.default_rng(0))
    est = n * sum(np.asarray(probe[k]).nbytes for k in CACHE_KEYS if k in probe)
    if "compressed" in probe:
        est += 2 * n * np.asarray(probe["compressed"]).nbytes
    if est > max_gb * 1024**3:
        return decline(f"dataset ~{est / 1024**3:.2f}GB exceeds the {max_gb}GB HBM budget")
    try:
        cache = DeviceDatasetCache(dataset, cfg, device)
    except ValueError as e:
        # preprocess_mode 'none' over images of several sizes does not stack
        return decline(f"samples are not stackable ({e})")
    print(f"device_cache: {n} samples ({cache.nbytes / 1024**2:.0f}MB) resident on device; "
          f"per-step H2D reduced to (index, flip)")
    return cache
