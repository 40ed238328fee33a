"""Device prefetch, the port of ``jpdse_tpu/data/prefetch.py``: place the
next batches on the device while the current one is consumed.

On a CUDA device each batch is placed on a side stream (numpy fields from
pinned host memory by ``non_blocking`` copies, or whatever ``place_fn``
launches there, such as the device cache's assembly); an event recorded
after it is waited for by the consumer's stream before the batch is handed
over, and each of the batch's tensors is recorded on the consumer's stream,
so the caching allocator does not reuse its memory while that stream may
still read it. On the CPU batches are placed in order, with nothing to
overlap.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

DEVICE_KEYS = ("label", "instance", "image", "compressed")  # a batch's fields the card reads


def to_device(v, device: torch.device) -> torch.Tensor:
    """``v`` (a numpy array or a tensor) on ``device``: an array through
    pinned memory and a non-blocking copy on a card, a tensor already there
    as it is."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            v = v.pin_memory()
    return v.to(device, non_blocking=True)


def _put(batch: Dict, device: torch.device) -> Dict:
    """The batch with its DEVICE_KEYS fields on ``device``, every other
    field as it was."""
    return dict(batch, **{k: to_device(batch[k], device) for k in DEVICE_KEYS if k in batch})


def _tensors(batch: Dict):
    return [v for v in batch.values() if isinstance(v, torch.Tensor) and v.device.type == "cuda"]


def prefetch_to_device(iterable: Iterable[Dict], size: int = 2, device=None,
                       place_fn=None) -> Iterator[Dict]:
    """Yield the batches of ``iterable`` placed, with up to ``size`` placed
    ahead. ``place_fn(batch) -> batch`` overrides the default placement
    (``_put`` on ``device``, default the current CUDA device, else the
    CPU)."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    place = place_fn if place_fn is not None else (lambda b: _put(b, device))
    side = None
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        # what the consumer's stream queued so far (a resident dataset's upload)
        side.wait_stream(torch.cuda.current_stream(device))

    def placed(batch):
        if side is None:
            return place(batch), None
        with torch.cuda.stream(side):
            out = place(batch)
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def hand_over(item):
        out, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in _tensors(out):
                t.record_stream(consumer)
        return out

    queue = []
    it = iter(iterable)
    for batch in it:
        queue.append(placed(batch))
        if len(queue) >= size:
            break
    while queue:
        nxt: Optional[tuple] = None
        try:
            nxt = placed(next(it))
        except StopIteration:
            pass
        yield hand_over(queue.pop(0))
        if nxt is not None:
            queue.append(nxt)
