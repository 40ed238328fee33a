"""Threaded, seeded data loader, the port of ``jpdse_tpu/data/loader.py``:
a thread pool decodes (PIL releases the GIL) and a bounded queue prefetches
batches while the card computes. Shuffle and drop_last only in training;
the order and each sample's augmentation draws come from numpy generators
seeded by (seed, epoch), so the batches equal the JAX package's in order
and content. Batches are numpy; the trainer moves them to the device.
With ``meta_only`` set the loader yields {"index", "flip", "path"} batches:
the same seeded draws as the host path, without the pixels, for the
device-resident cache (``data/device_cache.py``). With ``world`` > 1 (a
multi-process run) every rank draws the same permutation, pads it by
wrapping to a multiple of the world size and keeps its rank-strided slice,
in JAX's order (``jpdse_tpu/data/loader.py:83-98``): disjoint shards of
equal length, so every rank takes as many steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

PREFETCH = 2  # batches the producer may run ahead of the consumer


def collate(samples: List[Dict]) -> Dict:
    """Stacked arrays; the paths and the base codec's streams and their
    codec stay host lists, and its bytes one int64 per image."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if key in ("path", "base_codec_streams", "base_codec_ext"):
            out[key] = vals
        elif key == "base_codec_bytes":
            out[key] = np.asarray(vals, np.int64)
        else:
            out[key] = np.stack(vals)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        seed: Optional[int] = None,
        rank: int = 0,
        world: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed if seed is not None else 0
        self.epoch = 0
        self.rank = rank
        self.world = max(1, world)
        # yield {"index", "flip", "path"} batches (the device cache's replay)
        self.meta_only = False

    def _n_local(self) -> int:
        """The samples of this rank's shard: all of them in one process,
        else ceil(n / world)."""
        n = len(self.dataset)
        return -(-n // self.world) if self.world > 1 else n

    def __len__(self) -> int:
        n = self._n_local()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        if self.world > 1:
            # pad by wrapping before striding, so every rank runs as many steps
            # (the gradient all-reduce waits for all of them)
            pad = (-len(idx)) % self.world
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.rank::self.world]
        batches = [list(idx[i:i + self.batch_size]) for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        base_rng = np.random.default_rng((self.seed, self.epoch, 7))
        # one child seed per sample: augmentation does not depend on which
        # worker loads the sample
        sample_seeds = base_rng.integers(0, 2**63 - 1, size=len(self.dataset))

        def load_one(i: int) -> Dict:
            kwargs = {"meta_only": True} if self.meta_only else {}
            return self.dataset.__getitem__(i, rng=np.random.default_rng(int(sample_seeds[i])),
                                            **kwargs)

        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                try:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        q.put(collate(list(pool.map(load_one, batch_idx))))
                except BaseException as e:  # handed to the consumer, which raises it
                    q.put(e)
                finally:
                    q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer's pending put returns and it sees stop
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
        self.epoch += 1
