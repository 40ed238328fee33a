"""The data and spatial axes over a process group, the port of what
``jpdse_tpu/parallel/mesh.py`` decides (``make_mesh`` :33,
``mesh_from_config`` :52-74, ``warn_replicated_once`` :77,
``shard_batch_flexible`` :89) in process-group form.

One port process drives one device (``parallel/distributed.py``), so the
port's mesh is JAX's multi-host mesh with one local device per host, and
``parallel.spatial_axis`` S groups S consecutive ranks into one spatial
group: rank r has data index ``r // S`` and spatial index ``r % S``, as
JAX's ``(n_data, n_spatial)`` reshape makes the spatial index the fast
one. (In JAX the spatial axis subdivides a host's local devices; here it
spans processes, ROADMAP Queue 3.) The mesh prints as ``dcn`` = the number
of spatial groups x ``data`` = 1 x ``spatial`` = S.

* A training batch is the spatial group's shard: the loader strides the
  sampler by data index (``data/loader.py``), and the global batch is the
  groups' shards concatenated in data order, as ``make_global_batch_flexible``
  with ``local_is_shard=True`` (``jpdse_tpu/parallel/distributed.py:92``).
  ``data.batch_size`` is per spatial group (per process for S = 1).
* The S ranks of a group load the same batch and keep their rows of H
  (:meth:`DataMesh.shard`, ``parallel/spatial.py``); an H that S does not
  divide stays unsharded with JAX's one-shot warning, every rank of the
  group computing the whole of it.
* An evaluation batch is the same on every rank (the unsharded eval
  loaders, ``local_is_shard=False``): replicated over the data axis, and
  H-sharded over a spatial group, whose ranks gather the outputs.
* Parameters replicate: rank 0's are broadcast at the start, and each
  step's gradients are summed over the spatial group and averaged over the
  data axis (``train/step.py``).
* Random draws (the stochastic binarizers, dropout, the replay pool) are
  made for the global batch at the global height on every rank from the
  same generator state, each rank keeping its own batch rows and H rows
  (:func:`draw_rows`): what JAX's jitted step does with its replicated key
  on a sharded batch.
"""

from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import torch

from jpdse_tpu_torch.parallel import distributed, spatial
from jpdse_tpu_torch.parallel.spatial import SpatialShard


@dataclass(frozen=True)
class DataMesh:
    """The (data, spatial) mesh of a run of ``world`` processes, seen from
    ``rank``: ``world // spatial`` spatial groups of ``spatial`` consecutive
    ranks. ``groups`` holds this rank's spatial group and data group (the
    ranks of its spatial index) where ``spatial`` > 1."""

    rank: int
    world: int
    spatial: int = 1
    groups: Tuple = field(default=(None, None), compare=False, repr=False)

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def n_data(self) -> int:
        return self.world // self.spatial

    def rows(self, b: int) -> slice:
        """This rank's rows of a global batch of ``b`` per spatial group."""
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def h_rows(self, h: int) -> slice:
        """This rank's global rows of an H of ``h`` sharded over its group."""
        lo, hi = spatial.bounds(h, self.spatial)[self.spatial_index:self.spatial_index + 2]
        return slice(lo, hi)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of the data axis's ``x`` (those of this rank's
        spatial index), on every rank."""
        if self.n_data == 1:
            return x
        return distributed.all_gather_rows(x, self.groups[1], self.data_index, self.n_data)

    def shard(self, h: int, what: str = "batch") -> Optional[SpatialShard]:
        """This rank's spatial shard for a batch of height ``h``, or None:
        no spatial axis, or an H that it does not divide (then said once,
        in JAX's words, and every rank of the group computes all of H)."""
        if self.spatial == 1:
            return None
        if h % self.spatial:
            warn_replicated_once(what, "spatial",
                                 f"batch field {what!r}: dim 1 ({h}) not divisible by spatial "
                                 f"axis ({self.spatial}); H stays unsharded")
            return None
        return SpatialShard(self.spatial_index, self.spatial, self.groups[0])


def mesh_from_config(parallel_cfg) -> Optional[DataMesh]:
    """The mesh of this run, or None for the single-process path. Under a
    process group (any size) a :class:`DataMesh` over it, with
    ``data_axis`` -1 (or 0) or 1: the per-process data axis subdivides one
    local device. Without one, ``data_axis`` N > 1 asks for N devices in
    one process, which PyTorch has no single-process form of: it raises
    with JAX's wording and names the equivalent run; so does
    ``spatial_axis`` > 1. ``spatial_axis`` S > 1 groups S consecutive
    ranks (a world that S does not divide raises, in JAX's words), and
    every rank makes every group, in one order."""
    n_data, n_spatial = parallel_cfg.data_axis, max(1, parallel_cfg.spatial_axis)
    if not distributed.active():
        if n_data > 1 or n_spatial > 1:
            n = max(1, n_data) * n_spatial
            raise ValueError(
                f"parallel config requests a {max(1, n_data)}x{n_spatial} (data x spatial) mesh "
                f"but only 1 devices are visible: a port process drives one device, so run {n} "
                f"processes (torchrun --nproc_per_node {n}, or JPDSE_COORDINATOR / "
                f"JPDSE_NUM_PROCESSES={n} / JPDSE_PROCESS_ID), each with batch_size / "
                f"{max(1, n_data)} and data_axis -1")
        return None
    if n_data > 1:
        raise ValueError(
            f"per-host mesh {n_data}x1 != 1 local devices: each of the {distributed.world()} "
            f"processes drives one device, so data_axis is -1 or 1 (the data axis spans "
            f"the processes; batch_size is per process)")
    world, rank = distributed.world(), distributed.rank()
    if n_spatial == 1:
        return DataMesh(rank, world)
    if world % n_spatial:
        raise ValueError(f"{world} devices not divisible by spatial={n_spatial}")
    groups_s = distributed.new_groups(
        [range(d * n_spatial, (d + 1) * n_spatial) for d in range(world // n_spatial)])
    groups_d = distributed.new_groups([range(s, world, n_spatial) for s in range(n_spatial)])
    return DataMesh(rank, world, n_spatial,
                    (groups_s[rank // n_spatial], groups_d[rank % n_spatial]))


_warned_replicated: set = set()


def warn_replicated_once(key: str, axis: str, msg: str) -> None:
    """One warning per (key, axis) for a batch field that replicates where
    it would shard: every rank then computes the whole of it."""
    if (key, axis) in _warned_replicated:
        return
    _warned_replicated.add((key, axis))
    warnings.warn(msg)


def note_replicated(mesh: Optional[DataMesh], what: str) -> None:
    """An evaluation batch under more than one spatial group: the same on
    every rank (the unsharded eval loaders), so replicated over the data
    axis, every group computing the whole of it; said once per ``what``."""
    if mesh is not None and mesh.n_data > 1:
        warn_replicated_once(what, "dcn",
                             f"{what}: the same batch on each of {mesh.n_data} spatial groups "
                             f"(evaluation is not sharded over the data axis); replicating, "
                             f"rank 0 writes")


# -- the draws of a data-parallel step ----------------------------------------------
_ACTIVE: Optional[DataMesh] = None


@contextlib.contextmanager
def drawing(mesh: Optional[DataMesh]):
    """While active, :func:`draw_rows` draws for the global batch of
    ``mesh`` and keeps this rank's rows (a no-op for None or one rank)."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, (mesh if mesh is not None and mesh.n_data > 1 else None)
    try:
        yield
    finally:
        _ACTIVE = saved


def draw_rows(shape: Tuple[int, ...], draw: Callable[[Tuple[int, ...]], torch.Tensor],
              hg: Optional[int] = None) -> torch.Tensor:
    """``draw(shape)``, whose dim 0 is the batch and dim 1 H; inside
    :func:`drawing` of a mesh of N spatial groups, ``draw`` of the global
    shape (dim 0 times N and, under ``parallel/spatial.py``'s sharding, dim
    1 the tensor's global height ``hg``, which a sharded draw must be
    given: ``spatial.global_h`` of the tensor it is drawn for), of which
    this rank keeps its batch rows and its H rows: every rank advances the
    generator alike and the draws equal one process's on the global
    batch."""
    mesh, shard = _ACTIVE, spatial.current()
    if mesh is None and shard is None:
        return draw(tuple(shape))
    shape = tuple(shape)
    b, n = shape[0], 1 if mesh is None else mesh.n_data
    if shard is not None and hg is None:
        raise spatial.UnknownHeight(f"a draw of shape {shape} under a spatial shard needs the "
                                    f"tensor's global height")
    u = draw((b * n, shape[1] if shard is None else hg) + shape[2:])
    if mesh is not None:
        u = u[mesh.rows(b)]
    return u if shard is None else shard.rows(u)
