"""The data axis over a process group, the port of what
``jpdse_tpu/parallel/mesh.py`` decides (``mesh_from_config`` :52-74,
``warn_replicated_once`` :77, ``shard_batch_flexible`` :89) in
process-group form.

One port process drives one device (``parallel/distributed.py``), so the
port's mesh is JAX's multi-host mesh with one local device per host:
``dcn`` = the world size, ``data`` = 1 and ``spatial`` = 1 per process.

* A training batch is the process's shard: the loader rank-strides the
  sampler (``data/loader.py``), and the global batch is the ranks' shards
  concatenated in rank order, as ``make_global_batch_flexible`` with
  ``local_is_shard=True`` (``jpdse_tpu/parallel/distributed.py:92``).
* An evaluation batch is the same on every rank (the unsharded eval
  loaders, ``local_is_shard=False``): replicated, every rank computes the
  whole of it, and rank 0 writes.
* Parameters replicate: rank 0's are broadcast at the start and the
  gradients all-reduced as a mean in each step (``train/step.py``).
* Random draws (the stochastic binarizers, dropout, the replay pool) are
  made for the global batch on every rank from the same generator state,
  each rank keeping its own rows (:func:`draw_rows`): what JAX's jitted
  step does with its replicated key on a sharded batch.

The spatial axis (H-sharded convolutions with halo exchange) is ROADMAP
Queue 1 item 12's remainder; ``spatial_axis > 1`` raises ``NotPorted``.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from jpdse_tpu_torch.config import NotPorted, SPATIAL_NOT_PORTED
from jpdse_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class DataMesh:
    """The data axis of a run of ``world`` processes, seen from ``rank``."""

    rank: int
    world: int

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b`` per rank."""
        return slice(self.rank * b, (self.rank + 1) * b)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of the ranks' ``x``, on every rank."""
        return distributed.all_gather_rows(x) if self.world > 1 else x


def mesh_from_config(parallel_cfg) -> Optional[DataMesh]:
    """The mesh of this run, or None for the single-process path. Under a
    process group (any size) a :class:`DataMesh` over it, with
    ``data_axis`` -1 (or 0) or 1: the per-process data axis subdivides one
    local device. Without one, ``data_axis`` N > 1 asks for N devices in
    one process, which PyTorch has no single-process form of: it raises
    with JAX's wording and names the equivalent run. ``spatial_axis > 1``
    raises :class:`NotPorted`."""
    if parallel_cfg.spatial_axis > 1:
        raise NotPorted(SPATIAL_NOT_PORTED)
    n_data = parallel_cfg.data_axis
    if not distributed.active():
        if n_data > 1:
            raise ValueError(
                f"parallel config requests a {n_data}x1 (data x spatial) mesh but only 1 "
                f"devices are visible: a port process drives one device, so run {n_data} "
                f"processes (torchrun --nproc_per_node {n_data}, or JPDSE_COORDINATOR / "
                f"JPDSE_NUM_PROCESSES={n_data} / JPDSE_PROCESS_ID), each with batch_size / "
                f"{n_data} and data_axis -1")
        return None
    if n_data > 1:
        raise ValueError(
            f"per-host mesh {n_data}x1 != 1 local devices: each of the {distributed.world()} "
            f"processes drives one device, so data_axis is -1 or 1 (the data axis spans "
            f"the processes; batch_size is per process)")
    return DataMesh(distributed.rank(), distributed.world())


_warned_replicated: set = set()


def warn_replicated_once(key: str, axis: str, msg: str) -> None:
    """One warning per (key, axis) for a batch field that replicates where
    it would shard: every rank then computes the whole of it."""
    if (key, axis) in _warned_replicated:
        return
    _warned_replicated.add((key, axis))
    warnings.warn(msg)


def note_replicated(mesh: Optional[DataMesh], what: str) -> None:
    """An evaluation batch under more than one rank: the same on every rank
    (the unsharded eval loaders), so replicated, every rank computing the
    whole of it; said once per ``what``."""
    if mesh is not None and mesh.world > 1:
        warn_replicated_once(what, "dcn",
                             f"{what}: the same batch on each of {mesh.world} processes "
                             f"(evaluation is not sharded); replicating, rank 0 writes")


# -- the draws of a data-parallel step ----------------------------------------------
_ACTIVE: Optional[DataMesh] = None


@contextlib.contextmanager
def drawing(mesh: Optional[DataMesh]):
    """While active, :func:`draw_rows` draws for the global batch of
    ``mesh`` and keeps this rank's rows (a no-op for None or one rank)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, (mesh if mesh is not None and mesh.world > 1 else None)
    try:
        yield
    finally:
        _ACTIVE = saved


def draw_rows(shape: Tuple[int, ...], draw: Callable[[Tuple[int, ...]], torch.Tensor]
              ) -> torch.Tensor:
    """``draw(shape)``, whose dim 0 is the batch; inside :func:`drawing` of
    a mesh of N ranks, ``draw`` of the global shape (dim 0 times N), of
    which this rank keeps its rows: every rank advances the generator alike
    and the draws equal one process's on the global batch."""
    mesh = _ACTIVE
    if mesh is None:
        return draw(tuple(shape))
    b = shape[0]
    return draw((b * mesh.world,) + tuple(shape[1:]))[mesh.rows(b)]
