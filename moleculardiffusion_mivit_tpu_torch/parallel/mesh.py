"""A data × model mesh of ranks, and the placement of model grids on it.

Port of ``moleculardiffusion_mivit_tpu/parallel/mesh.py`` on
``torch.distributed``. JAX is single-controller: one process sees every
device and shards arrays over a ``Mesh``. Here every rank is a process of
its own (``torchrun``, or ``initialize_distributed`` with explicit
arguments), and every rank runs the same program on its own part:

- ``model`` axis: a grid's ``M`` members split contiguously over the
  ``model`` ranks (``grid_sharding``, ``shard_grid``); each rank keeps its
  members' parameters and AdamW state, so this axis has no collective in
  training;
- ``data`` axis: a grid member's minibatch splits over the ``data`` ranks of
  its column, whose gradients are summed over that column's group; a
  single-model arm's minibatch splits over every rank, its parameters
  replicated and its gradients summed over the world
  (``parallel.collectives.BatchSplit``).

A cycle's data is generated in parts (``GenerationPart``): each rank makes
its block of the cycle's units (D classes, or a grid's members) and the
ranks that need the whole gather it (``parallel.collectives.gather_part``).

Rank ``r`` sits at ``(r // model, r % model)``, the row-major order of the
JAX package's device array.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import itertools
from typing import Any, Optional

import torch
import torch.distributed as dist


def initialize_distributed(
    backend: str,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> None:
    """Join this process to the world of ranks; call once per process before
    ``make_mesh``. ``backend`` is ``"nccl"`` (one card a rank) or ``"gloo"``
    (CPU tensors, or several ranks on one card); it is never chosen here.
    Under ``torchrun`` the address, world size and rank come from its
    environment; otherwise pass ``init_method`` (``"tcp://localhost:PORT"``),
    ``world_size`` and ``rank``. ``timeout_s`` bounds how long a collective
    waits for the other ranks. Idempotent: a second call, once joined,
    does nothing."""
    if dist.is_initialized():
        return
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size if world_size
                            is not None else -1, rank=rank if rank is not None else -1, **kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ``data × model`` mesh (``make_mesh``):
    ``data_group`` holds the ranks of its model column (the ranks that
    split one grid member's minibatch), ``model_group`` those of its data
    row (the ranks over which a grid's members split)."""

    data: int
    model: int
    rank: int
    backend: str
    data_group: Any
    model_group: Any

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def world_group(self):
        return dist.group.WORLD


def make_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The ``data × model`` mesh of the world's ranks. Raises without a
    process group (``initialize_distributed``), and unless the world has
    exactly ``data · model`` ranks: a mesh never runs on fewer ranks than
    it names. Every rank must call it (the groups are made collectively).
    Under NCCL each group makes one all-reduce at once, so its
    communicator exists before a CUDA graph captures a collective of it."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call parallel.initialize_distributed first")
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got data={data}, model={model}")
    n, have = data * model, dist.get_world_size()
    if have < n:
        raise ValueError(f"need {n} ranks, have {have}")
    if have > n:
        raise ValueError(f"a {data} × {model} mesh takes {n} ranks; the world has {have}")
    rank = dist.get_rank()
    data_groups = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    mesh = Mesh(data, model, rank, dist.get_backend(), data_groups[rank % model], model_groups[rank // model])
    if mesh.backend == "nccl":
        one = torch.zeros(1, device=torch.device("cuda", torch.cuda.current_device()))
        for group in (mesh.world_group, mesh.data_group, mesh.model_group):
            dist.all_reduce(one, group=group)
        torch.cuda.synchronize()
    return mesh


@dataclasses.dataclass(frozen=True)
class GenerationPart:
    """Which units of a cycle this rank generates, the counterpart of the
    JAX package's data born sharded: its block of any count of units
    (``units``: D classes, or an ensemble's members), and of a grid whose
    arms' data is member-specific, the members of its ``model`` block
    (``members``; ``None``: every member). The ranks of ``group`` (``size``
    of them, this one at ``index``) generate disjoint blocks and together
    the whole: ``parallel.collectives.gather_part`` joins them. A grid's
    part with ``members`` returns those members' data alone; without, a
    sharded grid keeps its block of every member's (``member_block``)."""

    index: int
    size: int
    group: Any
    members: Optional[slice] = None

    def units(self, n: int) -> range:
        """This rank's contiguous block of ``range(n)``: ``n`` split over the
        ``size`` ranks, the first ``n % size`` blocks one longer; empty on a
        rank past ``n``."""
        q, r = divmod(n, self.size)
        lo = self.index * q + min(self.index, r)
        return range(lo, lo + q + (self.index < r))


def generation_part(mesh: Mesh, members: Optional[slice] = None) -> GenerationPart:
    """This rank's ``GenerationPart`` on ``mesh``. Without ``members`` the
    units split over every rank and the whole cycle is gathered over the
    world (a single-model arm's minibatch reads any row); with a grid's
    ``members`` (``grid_sharding``) they split over the ``data`` ranks of
    this rank's column, which hold those members and gather over the
    column."""
    if members is None:
        return GenerationPart(mesh.rank, mesh.size, mesh.world_group)
    return GenerationPart(mesh.data_index, mesh.data, mesh.data_group, members)


def part_units(part: Optional[GenerationPart], n: int) -> range:
    """The units of ``n`` that ``part`` generates: all of them without a
    part (an unsharded cycle)."""
    return range(n) if part is None else part.units(n)


def member_block(members: slice, *arrays):
    """Member-major ``arrays`` holding every member's data (``None``
    passes), cut to a sharded grid's block ``members``: what its rank
    trains on when the data was not generated member by member."""
    return tuple(None if a is None else a[members] for a in arrays)


def grid_sharding(mesh: Mesh, n_members: int) -> slice:
    """This rank's members of a grid of ``n_members``: a contiguous block of
    ``n_members / model``. Like ``jax.device_put`` with ``P('model')``, a
    member count the ``model`` axis does not divide raises."""
    if n_members % mesh.model:
        raise ValueError(f"a grid of {n_members} members does not split over {mesh.model} model ranks")
    per = n_members // mesh.model
    return slice(mesh.model_index * per, (mesh.model_index + 1) * per)


def shard_grid(state, mesh: Mesh):
    """This rank's part of a grid's ``TrainState`` (a ``train.grid.GridModule``
    of every member and its AdamW): a copy whose parameters, buffers and
    optimizer moments hold only the members of ``grid_sharding``."""
    local = copy.deepcopy(state)  # the optimizer keeps the copied parameters
    members = grid_sharding(mesh, next(local.model.parameters()).shape[0])
    for t in itertools.chain(local.model.parameters(), local.model.buffers()):
        t.data = t.data[members].clone()
    for moments in local.optimizer.state.values():
        for k, v in moments.items():
            if torch.is_tensor(v) and v.ndim:  # not the 0-d step counts
                moments[k] = v[members].clone()
    return local
