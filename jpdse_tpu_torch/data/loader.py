"""Threaded, seeded data loader, the port of ``jpdse_tpu/data/loader.py``:
a thread pool decodes (PIL releases the GIL) and a bounded queue prefetches
batches while the card computes. Shuffle and drop_last only in training;
the order and each sample's augmentation draws come from numpy generators
seeded by (seed, epoch), so the batches equal the JAX package's in order
and content. Batches are numpy; the trainer moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

PREFETCH = 2  # batches the producer may run ahead of the consumer


def collate(samples: List[Dict]) -> Dict:
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = vals if key == "path" else np.stack(vals)
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
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed if seed is not None else 0
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
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
            return self.dataset.__getitem__(i, rng=np.random.default_rng(int(sample_seeds[i])))

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
