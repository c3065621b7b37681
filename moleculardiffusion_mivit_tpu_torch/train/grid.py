"""Model grids: many small models of one architecture trained as one program.

Port of ``moleculardiffusion_mivit_tpu/train/grid.py``. The reference trains
its experiment grids one model after the other (60 models for PSFNoise: 5
PSF × 6 noise × {transformer, ResNet}); here a grid of ``M`` models is one
``GridModule`` whose parameters and buffers carry a leading member axis
(``torch.func.stack_module_state``), and a step runs every member at once:
``torch.vmap`` over ``torch.func.functional_call`` of one template module.

- Forward: each member's minibatch is gathered from its own data slice
  (``videos (M, N, ...)``, ``idx (M, B)``); the deep-ResNet embedding's
  kernels K2/K3 see the member axis through their vmap rule
  (``ops.fused_embedding``) and launch once a step for all members; the
  other layers run as batched PyTorch operators (a convolution with
  stacked weights becomes a grouped one, f32 and deterministic under
  ``f32_convolutions``).
- Backward: one ``backward`` of the *sum* of the per-member losses, which
  gives each member exactly the gradient of its own loss (a mean over
  members would scale it by 1/M).
- BatchNorm: each member's running statistics move by its own batch
  statistics, in place on the stacked buffers.
- Optimizer: one AdamW over the stacked leaves; AdamW is elementwise, so
  each member's update is its own.

Nothing here loops over members, and ``train_step`` makes no host
synchronisation and draws no random number, so ``train.capture`` captures
it in a CUDA graph like a single model's step.

Random streams: member ``m``'s initial weights come from the ``m``-th CPU
generator given to ``init_grid``; its epoch permutation from
``fold_in(generator, m)`` (``make_perms``) and its dropout key from the same
generator (``make_drop_keys``: ``utils.rng.dropout_key``), so member ``m``
draws what a model alone draws from ``train.loop``'s ``train_cycle`` given
``fold_in(generator, m)``. Under ``torch.vmap`` each member hashes its own
key (``models.dropout``), so its masks do not depend on the grid's member
count or on its position in the grid.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call, stack_module_state

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import init_model
from moleculardiffusion_mivit_tpu_torch.models.dropout import key_tensor, keyed_dropout, step_key, uses_dropout
from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import f32_convolutions
from moleculardiffusion_mivit_tpu_torch.parallel.collectives import BatchSplit, loss_share, sharded_rows
from moleculardiffusion_mivit_tpu_torch.train.loop import (
    TrainState,
    _cast_for_compute,
    _check_supported,
    _loss,
    _set_lr,
    epoch_permutation,
    make_optimizer,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import dropout_key, fold_in


def _key(name: str) -> str:
    return name.replace(".", "__")


class GridModule(nn.Module):
    """``M`` copies of ``template``'s architecture as stacked parameters and
    buffers, registered under the template's names with ``.`` → ``__`` (so
    ``state_dict`` and an optimizer see ``M``-stacked leaves). The template
    is not a submodule: only its structure is used, by ``functional_call``.
    ``members`` are initialised modules of the template's architecture."""

    def __init__(self, template: nn.Module, members: Sequence[nn.Module]):
        super().__init__()
        params, buffers = stack_module_state(list(members))
        self.__dict__["template"] = template
        self.param_names = list(params)
        self.buffer_names = list(buffers)
        for name, p in params.items():
            self.register_parameter(_key(name), nn.Parameter(p.detach().clone()))
        for name, b in buffers.items():
            self.register_buffer(_key(name), b.detach().clone())

    def stacked(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The template's parameters and buffers by name, each ``(M, ...)``."""
        return ({n: getattr(self, _key(n)) for n in self.param_names},
                {n: getattr(self, _key(n)) for n in self.buffer_names})

    def vmapped(self, fn: Callable, *args, params: Optional[Dict[str, torch.Tensor]] = None,
                keys=None) -> torch.Tensor:
        """``torch.vmap`` over the members of ``fn(model, *member_args)``,
        ``model(*inputs)`` running the template on one member's parameters
        and buffers, in this module's train or eval mode; every ``args``
        tensor has the member axis first. ``params`` (stacked, by template
        name) stand in for the module's own, e.g. their bf16 casts.
        ``keys``: the members' dropout step keys (``models.dropout.step_key``
        of ``(M,)`` keys), each member's forward inside its own."""
        self.template.train(self.training)
        own, buffers = self.stacked()
        params = own if params is None else params
        template = self.template

        def one(p, b, k, *a):
            with keyed_dropout(k):
                return fn(lambda *inputs: functional_call(template, (p, b), inputs), *a)

        return torch.vmap(one, in_dims=(0, 0, None if keys is None else 0) + (0,) * len(args))(
            params, buffers, keys, *args)

    def _apply(self, fn, recurse=True):
        self.template._apply(fn, recurse)
        return super()._apply(fn, recurse)


class GridImpls(NamedTuple):
    """The grid's closures (see ``make_grid_impls``)."""

    init_grid: Callable
    train_cycle: Callable
    evaluate: Callable
    train_step: Callable
    make_perms: Callable


def make_perms(generator: torch.Generator, m: int, n: int, batch_size: int, device, first: int = 0) -> torch.Tensor:
    """Each member's epoch permutation, ``(M, n // batch_size, batch_size)``:
    member ``i`` (of ``first … first + M - 1``) draws ``epoch_permutation``
    from ``fold_in(generator, i)``."""
    return torch.stack([epoch_permutation(fold_in(generator, i), n, batch_size, device)
                        for i in range(first, first + m)])


def make_drop_keys(generator: torch.Generator, m: int, device, first: int = 0) -> torch.Tensor:
    """Each member's dropout key ``(M,)``: member ``i`` (of ``first … first
    + M - 1``) takes ``utils.rng.dropout_key`` of ``fold_in(generator, i)``,
    the generator of its permutation (``make_perms``)."""
    return key_tensor([dropout_key(fold_in(generator, i, device="cpu")) for i in range(first, first + m)], device)


def make_grid_impls(
    model: nn.Module, train_cfg: TrainConfig, device=None, with_features: bool = False,
    constrain_batch: Optional[BatchSplit] = None, members: Optional[slice] = None,
) -> GridImpls:
    """``(init_grid, train_cycle, evaluate, train_step, make_perms)`` for a
    grid of ``model``'s architecture. Data are member-major: ``videos (M,
    N, ...)``, ``labels (M, N, k)`` (shared labels tiled over ``M``), with
    ``with_features`` also ``features (M, N, F)``; member ``m`` trains on
    its own slice, as the reference feeds grid cell (psf, noise) to model
    ``tr_{psf}_{noise}``.

    - ``init_grid(generators, capturable=False)``: a ``TrainState`` of a
      ``GridModule`` with one member per CPU generator (``init_model``
      from each), on the device, and its AdamW.
    - ``train_step(state, videos, labels, idx, act_slope=None,
      features=None, drop_key=None)``: one minibatch of every member, ``idx
      (M, B)``, in ``compute_dtype`` (the parameters and inputs cast inside
      the step, as ``train.loop``'s; ``drop_key (M,)``, the members'
      dropout keys, each folded with its ``idx[m, 0]``); returns the
      per-member losses ``(M,)`` (not synchronised).
    - ``train_cycle(state, videos, labels, generator, lr, batch_size,
      features=None)``: one epoch in ``make_perms`` order with
      ``make_drop_keys``' keys; returns the per-member mean losses ``(M,)``.
    - ``evaluate(state, videos, features=None)``: eval-mode predictions
      ``(M, N, ...)`` × ``d_max_normalization``.

    On a mesh (``parallel.steps``): ``members`` is this rank's block of the
    grid's members (``parallel.grid_sharding``): ``init_grid`` takes every
    member's generator and makes only these, and ``train_cycle`` takes these
    members' data alone (``parallel.mesh.member_block``) and trains them,
    member ``m`` on its permutation and dropout key from its global stream. ``constrain_batch`` splits each
    member's minibatch over the ``data`` ranks of its column as
    ``train.loop``'s step splits a single model's: ``idx (M, B)`` is global,
    the rank keeps columns ``lo:hi`` of it, and the gradients and losses are
    summed over the column's group.
    """
    _check_supported(train_cfg)
    dev = resolve_device(device)
    split = constrain_batch
    dropout = uses_dropout(model)
    first = 0 if members is None else members.start

    def init_grid(generators: Sequence[torch.Generator], capturable: bool = False) -> TrainState:
        gens = generators if members is None else generators[members]
        grid = GridModule(model, [init_model(copy.deepcopy(model), g) for g in gens]).to(dev).train()
        return TrainState(grid, make_optimizer(grid, train_cfg, capturable))

    def member_loss(run, bv, by, *bf, share=(1, 1)):
        out = run(bv, *bf).float()
        if by.ndim == 2 and out.ndim == 3:
            by = by[..., None]
        return loss_share(lambda o: _loss(o, by, train_cfg.loss), out, *share)

    def train_step(state: TrainState, videos, labels, idx, act_slope=None, features=None,
                   drop_key=None) -> torch.Tensor:
        if act_slope is not None:
            raise ValueError("a grid has no activation-slope stacks")
        if with_features and features is None:
            raise ValueError("this grid's models take features: pass features=")
        total = idx.shape[1]
        keys = None if drop_key is None else step_key(drop_key, idx[:, 0])
        lo, hi = (0, total) if split is None else split.bounds(total)
        idx = idx[:, lo:hi]
        member = torch.arange(idx.shape[0], device=idx.device)[:, None]
        grid = state.model
        params, bv, bf = _cast_for_compute(train_cfg, grid.stacked()[0], videos[member, idx],
                                           features[member, idx] if with_features else None)
        batch = (bv, labels[member, idx]) + ((bf,) if with_features else ())
        loss = functools.partial(member_loss, share=(hi - lo, total))
        with f32_convolutions(), sharded_rows(None if split is None else split.rows(total)):
            losses = grid.vmapped(loss, *batch, params=params, keys=keys)
            state.optimizer.zero_grad(set_to_none=True)
            losses.sum().backward()
        if split is not None:
            losses = split.reduce(grid.parameters(), losses)
        state.optimizer.step()
        return losses.detach()

    def train_cycle(state: TrainState, videos, labels, generator, lr: float, batch_size: int, features=None):
        perms = make_perms(generator, videos.shape[0], videos.shape[1], batch_size, videos.device, first)
        keys = make_drop_keys(generator, videos.shape[0], videos.device, first) if dropout else None
        _set_lr(state.optimizer, lr)
        state.model.train()
        losses = [train_step(state, videos, labels, perms[:, s], features=features, drop_key=keys)
                  for s in range(perms.shape[1])]
        return torch.stack(losses).mean(dim=0)

    @torch.no_grad()
    def evaluate(state: TrainState, videos, features: Optional[torch.Tensor] = None):
        grid = state.model
        grid.eval()
        try:
            args = (videos, features) if with_features else (videos,)
            return grid.vmapped(lambda run, *a: run(*a), *args) * train_cfg.d_max_normalization
        finally:
            grid.train()

    return GridImpls(init_grid, train_cycle, evaluate, train_step, make_perms)
