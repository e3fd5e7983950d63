"""Ranks and the statistics' collectives, in PyTorch's idiom.

Counterpart of ``mcintegration_tpu/parallel/mesh.py``, which shards the
block axis over a JAX device mesh.  Here a run of ``R`` ranks is ``R``
processes (``torchrun``, or any launcher that gives each process its rank):
rank ``r`` runs its share of the blocks on its own device, and after every
iteration the per-block rows are gathered and the additive statistics summed
across the ranks, after which every rank computes the same reweighting and
training (the reference's ``MPIreduceConfig!`` and ``MPIbcastConfig!``,
src/utility/parallel.jl, configuration.jl:264-321).

The statistics are float64 numpy of KB size: they travel through a gloo
group on the host, whatever device the computation runs on, so two ranks
can share one card and a CPU run needs no NCCL.  :func:`ordered_sum` sums
the ranks' parts in rank order on the host, so every rank computes the same
bits whatever the layout (the reference's ``ordered_psum``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch.distributed as dist

_GROUPS: dict = {}


class Mesh:
    """The first ``len(ranks)`` ranks of the world and the gloo group that
    carries their statistics."""

    def __init__(self, ranks, group):
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's place in the mesh; raises for a rank outside it."""
        r = dist.get_rank()
        if r not in self.ranks:
            raise ValueError(f"rank {r} is not in this mesh of ranks {self.ranks}; every "
                             "rank that passes it must be one of make_mesh(n)'s first n")
        return self.ranks.index(r)

    def __repr__(self):
        return f"Mesh(ranks={self.ranks})"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None):
    """Join the process group, once per process, before any work.

    ``coordinator`` is rank 0's ``host:port``, with ``num_processes`` and
    ``process_id``; without it the environment that ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) is read.  A
    process with neither runs alone.  A failure raises.
    """
    if dist.is_initialized():
        return
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed(coordinator=...) needs num_processes and "
                             "process_id")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        dist.init_process_group("gloo", init_method="env://")


def _group(ranks: tuple):
    """The gloo group of ``ranks``, made once: every rank of the world must
    ask for the same groups in the same order."""
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(ranks=list(ranks), backend="gloo")
    return _GROUPS[ranks]


def make_mesh(n: Optional[int] = None) -> Mesh:
    """The first ``n`` ranks of the world (all of them when ``n`` is None).
    Every rank of the world calls it alike."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n}): the world has {world} ranks")
    ranks = tuple(range(n))
    return Mesh(ranks, _group(ranks))


def default_mesh() -> Optional[Mesh]:
    """Every rank of the world when a process group of more than one rank
    is up; None otherwise."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh()
    return None


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.size


def allgather(obj, mesh: Optional[Mesh]) -> list:
    """Every mesh rank's ``obj``, in rank order; a failure raises."""
    if mesh is None or mesh.size == 1:
        return [obj]
    mesh.rank                              # raises for a rank outside the mesh
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def sum_in_order(parts: list):
    """``parts[0] + parts[1] + ...``, added left to right."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def ordered_sum(x, mesh: Optional[Mesh]) -> np.ndarray:
    """The ranks' float64 ``x`` summed in rank order, the same bits on every
    rank (the counterpart of ``ordered_psum``)."""
    return sum_in_order([np.asarray(p, np.float64)
                         for p in allgather(np.asarray(x, np.float64), mesh)])


def gather_rows(x, mesh: Optional[Mesh]) -> np.ndarray:
    """The ranks' per-block rows ``x [b, ...]`` concatenated in rank order."""
    return np.concatenate(allgather(np.asarray(x), mesh), axis=0)
