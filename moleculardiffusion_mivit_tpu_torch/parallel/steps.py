"""Sharded grid training and evaluation over a data × model mesh of ranks.

Port of ``moleculardiffusion_mivit_tpu/parallel/steps.py``. Where the JAX
package partitions one compiled program by sharding annotations, every rank
here runs the same program on its part (``parallel.mesh``):

- a grid's members split over the ``model`` ranks (``grid_sharding``);
- each member's minibatch splits over the ``data`` ranks of its column
  (``grid_batch_constraint``), a single-model arm's over every rank
  (``dp_batch_constraint``), and the gradients and losses are summed over
  that group in the step (``parallel.collectives.BatchSplit``);
- generation is partitioned, as the JAX package's cycle is born sharded:
  each rank generates its part of the cycle (``parallel.mesh.
  GenerationPart``: its block of the D classes, and of a grid its
  ``model`` block of members), the render (K1), noise, features and RL-TV
  of that part alone, from the part's own streams; the ranks that need the
  whole gather it once a cycle (``parallel.collectives.gather_part``: a
  grid's ``data`` column, the world for single-model arms), bitwise the
  cycle an unsharded run generates. Every rank draws every member's
  permutation from the same streams, so a sharded run is the unsharded
  run up to the order of the sums.

The training closures are ``train.grid.make_grid_impls``'s, given the split
and the members (``make_sharded_grid_impls``, which ``Experiment`` trains a
grid arm with); the functions here add what crosses ranks: losses and
predictions gathered (``gather_blocks``: ``all_gather_into_tensor`` under
NCCL), so every rank ends with every member's. The signatures are the JAX
package's with a generator for a key.
"""

from __future__ import annotations

from typing import Optional

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.parallel.collectives import BatchSplit, gather_blocks, gather_part
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import Mesh, generation_part, grid_sharding, member_block
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in


def grid_batch_constraint(mesh: Mesh) -> BatchSplit:
    """``constrain_batch`` for a grid's step: each member's minibatch split
    over the ``data`` ranks of its column (``P('model', 'data')``)."""
    return BatchSplit(mesh.data_group, mesh.data_index, mesh.data)


def dp_batch_constraint(mesh: Mesh) -> BatchSplit:
    """``constrain_batch`` for a single-model arm: the minibatch split over
    every rank, the parameters replicated. An activation-pair stack's
    members step one after the other, each with this split (the JAX
    package's ``stacked`` flag, for a leading member axis, has nothing to
    do here)."""
    return BatchSplit(mesh.world_group, mesh.rank, mesh.size)


def evaluate_rows(evaluate, mesh: Mesh, videos, features=None, chunk: Optional[int] = None,
                  members: Optional[slice] = None, n_members: int = 0):
    """Every prediction of ``evaluate`` on every rank: the set's ``N`` rows
    (axis 0, or axis 1 of a grid's member-major arrays) zero-padded to a
    multiple of the ranks that split them, each rank predicting its block
    (``chunk`` rows at a time), the blocks gathered over the world
    (``gather_blocks``), the padding sliced off. A grid (``members``, the
    rank's block of ``n_members``) splits its rows over the ``data`` ranks,
    its members' rows in their block; a single-model arm splits its rows
    over every rank."""
    axis = 0 if members is None else 1
    index, size = (mesh.rank, mesh.size) if members is None else (mesh.data_index, mesh.data)
    n = videos.shape[axis]
    per = -(-n // size)

    lo = min(index * per, n)
    rows = min(per, n - lo)

    def block(t):
        if t is None:
            return None
        t = (t if members is None else t[members]).narrow(axis, lo, rows)
        if rows < per:  # the set's end: zero rows up to the block's size
            t = torch.cat([t, t.new_zeros(t.shape[:axis] + (per - rows,) + t.shape[axis + 1:])], dim=axis)
        return t

    v, f = block(videos), block(features)
    step = chunk or per
    parts = [evaluate(v.narrow(axis, s, min(step, per - s)),
                      None if f is None else f.narrow(axis, s, min(step, per - s)))
             for s in range(0, per, step)]
    preds = gather_blocks(torch.cat(parts, dim=axis), mesh.world_group)
    if members is not None:  # rank d·model + m's block of members × rows: to (members, rows)
        rest = tuple(preds.shape[2:])
        preds = (preds.reshape((mesh.data, mesh.model, n_members // mesh.model, per) + rest)
                 .permute((1, 2, 0, 3) + tuple(range(4, 4 + len(rest)))).reshape((n_members, mesh.data * per) + rest))
    return preds.narrow(axis, 0, n)


def gather_members(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A member-major tensor of this rank's members (its ``grid_sharding``
    block) among every member's, gathered over the rank's ``model``
    group."""
    return gather_blocks(t, mesh.model_group)


def make_sharded_grid_impls(model, train_cfg, mesh: Mesh, n_members: int, with_features: bool = False,
                            device=None, eval_chunk: Optional[int] = None):
    """``train.grid.make_grid_impls``' closures for this rank's block of a
    grid of ``n_members`` on ``mesh``, as ``Experiment`` trains a grid arm
    and ``make_sharded_grid_fns`` wraps them: ``init_grid`` makes this
    rank's members; ``train_step`` and ``train_cycle`` train them, each
    minibatch split over the column's ``data`` ranks, and return their
    losses (``gather_members`` places them among every member's);
    ``evaluate`` returns every member's predictions on every rank
    (``evaluate_rows``, ``eval_chunk`` rows at a time)."""
    from moleculardiffusion_mivit_tpu_torch.train.grid import make_grid_impls

    members = grid_sharding(mesh, n_members)
    impls = make_grid_impls(model, train_cfg, device, with_features, constrain_batch=grid_batch_constraint(mesh),
                            members=members)

    def evaluate(state, videos, features=None):
        return evaluate_rows(lambda v, f: impls.evaluate(state, v, f), mesh, videos, features, eval_chunk,
                             members, n_members)

    return impls._replace(evaluate=evaluate)


def make_sharded_grid_fns(model, train_cfg, mesh: Mesh, with_features: bool = False, device=None,
                          eval_chunk: Optional[int] = None):
    """Sharded ``(init_grid, train_cycle, evaluate)`` for a model grid, the
    member count taken from the arguments (``make_sharded_grid_impls``).

    - ``init_grid(generators, capturable=False)``: every member's CPU
      generator; this rank's members on the device, with their AdamW.
    - ``train_cycle(grid, videos, labels, features, generator, lr,
      batch_size) -> (grid, losses)``: every member's data ``(M, N, ...)``
      (the same on every rank); one epoch of this rank's members, each
      minibatch split over the column's ``data`` ranks; ``losses (M,)``
      every member's mean, on every rank.
    - ``evaluate(grid, videos, features=None)``: every member's
      predictions ``(M, N, ...)`` on every rank.
    """
    impls = {}  # by the grid's member count

    def get_impls(n):
        if n not in impls:
            impls[n] = make_sharded_grid_impls(model, train_cfg, mesh, n, with_features, device, eval_chunk)
        return impls[n]

    def init_grid(generators, capturable: bool = False):
        return get_impls(len(generators)).init_grid(generators, capturable)

    def train_cycle(grid, videos, labels, features, generator, lr, batch_size: int):
        m = videos.shape[0]
        videos, labels, features = member_block(grid_sharding(mesh, m), videos, labels, features)
        losses = get_impls(m).train_cycle(grid, videos, labels, generator, float(lr), batch_size, features)
        return grid, gather_members(losses, mesh)

    def evaluate(grid, videos, features=None):
        return get_impls(videos.shape[0]).evaluate(grid, videos, features)

    return init_grid, train_cycle, evaluate


def make_sharded_cycle_program(model, train_cfg, mesh: Mesh, data_fn, with_features: bool = False, device=None):
    """One cycle of generation and training: ``cycle(grid, generator, lr,
    batch_size) -> (grid, losses)``, generation partitioned over the mesh.
    ``data_fn(generator, part) -> (videos (M_p, N_p, ...), labels (M_p,
    N_p, k), features (M_p, N_p, 25) or None)`` gets this rank's
    ``GenerationPart`` (its ``data`` block of the rows' units, the members
    of its ``model`` block) and returns that part alone, from
    ``fold_in(generator, 0)``; the column's ranks gather the rows
    (``gather_part``) and train their members on them; the epoch draws
    from ``fold_in(generator, 1)``."""
    dev = resolve_device(device)
    impls = {}  # by the grid's member count

    def cycle(grid, generator, lr, batch_size: int):
        m = next(grid.model.parameters()).shape[0] * mesh.model
        part = generation_part(mesh, grid_sharding(mesh, m))
        videos, labels, features = gather_part(data_fn(fold_in(generator, 0), part), part.group, dev, dim=1)
        if m not in impls:
            impls[m] = make_sharded_grid_impls(model, train_cfg, mesh, m, with_features, device)
        losses = impls[m].train_cycle(grid, videos, labels, fold_in(generator, 1), float(lr), batch_size,
                                      features if with_features else None)
        return grid, gather_members(losses, mesh)

    return cycle


def make_sharded_grid_step(model, train_cfg, mesh: Mesh, with_features: bool = False, device=None):
    """One full-batch AdamW step of every member: ``step(grid, videos,
    labels, lr, features=None, generator=None) -> (grid, losses)``, the
    whole set one minibatch of ``make_sharded_grid_fns``' epoch."""
    _, train_cycle, _ = make_sharded_grid_fns(model, train_cfg, mesh, with_features, device)

    def step(grid, videos, labels, lr, features=None, generator=None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return train_cycle(grid, videos, labels, features, generator, lr, videos.shape[1])

    return step
