"""Multi-process runs, the port of ``jpdse_tpu/parallel/distributed.py``
(``initialize`` :38-66) on ``torch.distributed``.

One port process is one JAX host with one local device: a run of N
processes is JAX's multi-host run of N hosts with one device each. So, as
JAX's multi-host contract has it (``jpdse_tpu/config.py:428-441``),
``data.batch_size`` is per process, the training loaders feed disjoint
rank-strided shards, and ``parallel.data_axis`` (which subdivides a host's
local devices) is -1 or 1 (``parallel/mesh.py``).

:func:`initialize` reads JAX's environment (``JPDSE_COORDINATOR``
host:port, ``JPDSE_NUM_PROCESSES``, ``JPDSE_PROCESS_ID``) or ``torchrun``'s
(``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) and initializes the default process group over TCP: NCCL
for a CUDA device, gloo for the CPU. Each process takes
``cuda:LOCAL_RANK`` (without ``LOCAL_RANK``, its rank modulo the visible
devices: one host). Unlike the JAX package, whose
``jpdse_tpu/platform.py:48-64`` warns and carries on single-process when
initialization fails, a failed initialization raises: N processes that
each trained alone would do so without a word.

The collectives the training step needs (``train/step.py``) are here too:
a mean all-reduce over flat buckets, a broadcast, and an all-gather of a
batch's rows written as an all-reduce, so that gloo runs it on CUDA
tensors as well.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 32 * 2**20  # the most a flat all-reduce bucket holds
INIT_TIMEOUT_S = 300.0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def _coordinator() -> Optional[str]:
    if os.environ.get("JPDSE_COORDINATOR"):
        return os.environ["JPDSE_COORDINATOR"]
    if os.environ.get("MASTER_ADDR"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return None


def local_rank() -> int:
    """This process's device index on its host."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank() % max(1, n)


def initialize(device="cuda", coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               timeout_s: float = INIT_TIMEOUT_S, backend: Optional[str] = None) -> bool:
    """Initialize the default process group (idempotent). Returns True for a
    run of more than one process, False for the common single-process case
    (no coordinator and at most one process asked for), where nothing is
    initialized. ``device`` picks the backend (unless ``backend`` names
    one): NCCL for CUDA, gloo for the CPU. A request that cannot be met, or
    a rendezvous that fails, raises."""
    coordinator_address = coordinator_address or _coordinator()
    if num_processes is None:
        num_processes = _env_int("JPDSE_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JPDSE_PROCESS_ID", "RANK")
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "jpdse_tpu_torch: a multi-process run needs a coordinator (JPDSE_COORDINATOR or "
            "MASTER_ADDR/MASTER_PORT), the number of processes (JPDSE_NUM_PROCESSES or "
            "WORLD_SIZE) and this process's id (JPDSE_PROCESS_ID or RANK); got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dev = torch.device(device)
    kwargs = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("jpdse_tpu_torch: CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        lr = _env_int("LOCAL_RANK")
        index = lr if lr is not None else process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    except Exception as e:  # noqa: BLE001 - re-raised with the request named
        raise RuntimeError(
            f"jpdse_tpu_torch: initializing the {backend} process group failed (process "
            f"{process_id} of {num_processes}, coordinator {coordinator_address}): "
            f"{type(e).__name__}: {e}") from e
    return num_processes > 1


def active() -> bool:
    """Whether a process group is initialized (of any size, one included)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def is_main() -> bool:
    """Rank 0, or the only process: the one that writes files."""
    return rank() == 0


def barrier() -> None:
    if active():
        dist.barrier()


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[torch.Tensor]]:
    """The tensors in order, in runs of one dtype and device of at most
    ``bucket_bytes`` (a larger tensor alone)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        last = out[-1] if out else None
        if (last is None or last[0].dtype != t.dtype or last[0].device != t.device
                or size + nbytes > bucket_bytes):
            out.append([t])
            size = nbytes
        else:
            last.append(t)
            size += nbytes
    return out


def all_reduce_mean_(tensors: Sequence[torch.Tensor], bucket_bytes: int = BUCKET_BYTES) -> None:
    """Replace each tensor by its mean over the ranks, in its own dtype,
    through flat buckets: one all-reduce (a sum) per bucket, then a division
    by the world size. Every rank ends with the same bytes."""
    n = world()
    for bucket in _buckets([t for t in tensors if t.numel()], bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view_as(t))


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0,
               bucket_bytes: int = BUCKET_BYTES) -> None:
    """Overwrite each tensor with rank ``src``'s, through flat buckets."""
    for bucket in _buckets([t for t in tensors if t.numel()], bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.broadcast(flat, src)
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view_as(t))


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank: each rank writes its rows into zeros and one
    all-reduce sums them, which adds only zeros to each value."""
    n, b = world(), x.shape[0]
    full = torch.zeros((n * b,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    full[rank() * b:(rank() + 1) * b] = x
    dist.all_reduce(full)
    return full
