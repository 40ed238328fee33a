"""Profiling hooks, the port of ``jpdse_tpu/utils/profiling.py``: a
``torch.profiler`` trace of a block of work written as a Chrome trace
(``trace``, as ``jax.profiler`` writes one there), a step timer with the
megapixels-per-second account (``StepTimer``, as is), and the FLOPs of a
function (``compiled_cost``: XLA's cost analysis there, PyTorch's
``FlopCounterMode`` here, counted as ``tools/torch_port_train_flops.py``
counts them).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

TRACE_SUFFIX = ".pt.trace.json"  # the name TensorBoard's PyTorch profiler plugin reads


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (the host's ops and, where a
    card is present, its kernels and copies) into one Chrome trace under
    ``log_dir`` (open it in Perfetto or chrome://tracing); a no-op without a
    log dir."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}{TRACE_SUFFIX}"
    prof.export_chrome_trace(os.path.join(log_dir, name))


class StepTimer:
    """Throughput accounting in megapixels/sec (the BASELINE.md metric)."""

    def __init__(self, pixels_per_step: int, warmup: int = 2):
        self.pixels_per_step = pixels_per_step
        self.warmup = warmup
        self.steps = 0
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.steps += 1
        if self.steps > self.warmup:
            self.elapsed += dt

    @property
    def mps(self) -> float:
        counted = max(self.steps - self.warmup, 0)
        if counted == 0 or self.elapsed == 0:
            return 0.0
        return counted * self.pixels_per_step / 1e6 / self.elapsed


def compiled_cost(fn, *args) -> Dict[str, float]:
    """{"flops": ...} of ``fn(*args)`` by ``FlopCounterMode`` (2 per
    multiply-add of the convolutions and matmuls, a backward run inside
    ``fn`` included; element-wise work is not counted). Run it on the meta
    device to count without memory."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops())}
