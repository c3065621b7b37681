"""Fused multi-model cycle: one generated dataset per cycle, every model of a
dict trained on it.

Port of ``moleculardiffusion_mivit_tpu/train/multi.py``. Where the JAX
package compiles the whole cycle into one program, the port generates and
validates eagerly and runs the training epochs through
``train.capture.EpochEngine``: on the card each model's step (or a stack's,
or, with ``merge_scans``, every model's) is a captured CUDA graph replayed
once a step; on CPU tensors the same steps run eagerly.

Per-model random streams are derived from each model's index in the dict
(``utils.rng.fold_in``, the counterpart of ``fold_in(k_train, i)``; the
permutation and the dropout key from the same generator, as the JAX package
splits ``k_perm`` and ``k_drop``), so
``stack_pairs`` and ``merge_scans`` change the execution layout and never
the update sequence. The port has no stacked leaves: a stack's members keep
their own parameters and step one after the other inside the stack's graph,
each called with its FF slope from ``SLOPE_BY_ACTIVATION`` as a 0-d tensor,
as the JAX package's stacked step passes it. With ``with_features`` every
model takes the cycle's 25 global trajectory features beside the videos,
and nothing is stacked. On a mesh (``Experiment.use_mesh``) a stack's
members keep their parameters on every rank and each steps with its own
``train_step``, which splits the shared minibatch over the ranks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, init_model
from moleculardiffusion_mivit_tpu_torch.models.dropout import key_tensor, uses_dropout
from moleculardiffusion_mivit_tpu_torch.train.capture import EpochEngine, Member, units_by_layout
from moleculardiffusion_mivit_tpu_torch.train.loop import (
    TrainState,
    _set_lr,
    epoch_permutation,
    generate_cycle_data,
    make_optimizer,
    make_train_impls,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import dropout_key, fold_in

# FF activations expressible as a leaky-relu slope: relu is slope 0 (the
# gradient differs only at inputs of exactly 0), the reference's leaky_relu
# is 0.01.
SLOPE_BY_ACTIVATION = {"relu": 0.0, "leaky_relu": 0.01}

# Batch sizes below this stack activation pairs in ``Experiment`` (at this
# size and above every model trains on its own); the JAX package's value,
# kept for the same branch.
STACK_BELOW_BATCH = 32

def detect_activation_stacks(models: Dict[str, Any]):
    """Group the GeneralTransformers without global features that are
    identical up to the FF activation slope (the baseline's three
    relu/leaky_relu pairs).

    Returns ``[(member_names, base_model, slopes), ...]`` for every group of
    two or more, in insertion order."""
    groups: Dict[tuple, list] = {}
    for name, m in models.items():
        if (
            type(m) is GeneralTransformer
            and not m.use_global_features
            and m.config.activation in SLOPE_BY_ACTIVATION
        ):
            sig = (
                type(m.embedding),
                m.fusion_type,
                m.global_feature_dim,
                m.mlp_head.fc1.out_features,
                m.config.replace(activation="relu"),
            )
            groups.setdefault(sig, []).append(name)
    return [
        (g, models[g[0]], tuple(SLOPE_BY_ACTIVATION[models[n].config.activation] for n in g))
        for g in groups.values()
        if len(g) >= 2
    ]


def _stack_key(member_names: Sequence[str]) -> str:
    return "stack:" + "+".join(member_names)


def make_multi_cycle(
    models: Dict[str, torch.nn.Module],
    train_cfg: TrainConfig,
    optics: OpticsConfig,
    with_features: bool = False,
    merge_scans: bool = False,
    stack_pairs: bool = False,
    device=None,
):
    """``(init_states, cycle)`` for a dict of models sharing one generated
    dataset per cycle, on ``device`` (CUDA unless told otherwise).

    - ``init_states(generator)`` initialises model ``i`` from
      ``fold_in(generator, i)`` and returns the dict of ``TrainState``s; with
      ``stack_pairs`` a stack's entry is keyed ``"stack:<a>+<b>"`` and holds
      its members' states in member order.
    - ``cycle(states, generator, lr, batch_size, val_videos=None,
      val_targets=None, val_features=None)`` generates the data from
      ``fold_in(generator, 0)``, trains every model one epoch (model ``i``'s
      permutation and dropout key from ``fold_in(fold_in(generator, 1),
      i)``) and, given
      validation videos and targets, scores each model: ``val_mse[name] =
      mean((pred - val_targets)²)`` in physical D units. Returns ``(states,
      losses, val_mse)`` keyed by model name; states update in place.

    ``with_features``: every model is called as ``model(videos, features)``
    with the cycle's features (``generate_cycle_data(with_features=True)``),
    and validation with ``val_features``. ``merge_scans``: one unit (one
    graph on the card) steps every model; ``stack_pairs`` (ignored under
    ``merge_scans`` and ``with_features``): each group of
    ``detect_activation_stacks`` is one unit. Otherwise each model is its
    own unit.
    """
    dev = resolve_device(device)
    names = list(models)
    stack = stack_pairs and not with_features and not merge_scans
    stacks = detect_activation_stacks(models) if stack else []
    impls = {name: make_train_impls(m, train_cfg, dev, with_features) for name, m in models.items()}
    slopes = {
        n: torch.tensor(s, dtype=torch.float32, device=dev)
        for members, _, sl in stacks for n, s in zip(members, sl)
    }
    layout = units_by_layout(names, [g for g, _, _ in stacks], merge_scans)
    engine = EpochEngine(dev)

    def init_states(generator: torch.Generator) -> Dict[str, Any]:
        per = {}
        for i, (name, m) in enumerate(models.items()):
            init_model(m, fold_in(generator, i, device="cpu"))
            m.to(dev).train()
            per[name] = TrainState(m, make_optimizer(m, train_cfg, capturable=dev.type == "cuda"))
        engine.release()
        states = {n: per[n] for n in names if n not in slopes}
        for members, _, _ in stacks:
            states[_stack_key(members)] = tuple(per[n] for n in members)
        return states

    def cycle(states, generator, lr: float, batch_size: int, val_videos=None, val_targets=None,
              val_features=None):
        per = _per_model(states, stacks)
        data = generate_cycle_data(fold_in(generator, 0), train_cfg, optics, with_features)
        videos, labels = data[:2]
        feats = data[2] if with_features else None
        k_train = fold_in(generator, 1)
        members = {}
        for i, name in enumerate(names):
            g = fold_in(k_train, i)
            perm = epoch_permutation(g, videos.shape[0], batch_size, dev)
            key = key_tensor(dropout_key(g), dev) if uses_dropout(models[name]) else None
            members[name] = Member(name, per[name], impls[name].train_step, videos, labels, perm, slopes.get(name),
                                   feats, key)
        for name in names:
            _set_lr(per[name].optimizer, lr)
        losses = engine.run([[members[n] for n in unit] for unit in layout], batch_size)
        val_mse = {}
        if val_videos is not None:
            for name in names:
                preds = impls[name].evaluate(per[name], val_videos, val_features)
                val_mse[name] = torch.mean((preds - val_targets) ** 2)
        return states, {n: losses[n] for n in names}, val_mse

    cycle.engine = engine
    return init_states, cycle


def make_scanned_multi_cycle(
    models: Dict[str, torch.nn.Module],
    train_cfg: TrainConfig,
    optics: OpticsConfig,
    with_features: bool = False,
    merge_scans: bool = False,
    stack_pairs: bool = False,
    device=None,
):
    """``make_multi_cycle`` with K cycles per call: ``cycles(states,
    generators (K), lrs (K), batch_size, val_videos=None, val_targets=None,
    val_features=None)``
    runs one cycle per (generator, lr) and returns ``(states, losses,
    val_mse)`` with a leading (K,) axis on each model's entries. (The JAX
    package scans the K cycles inside one program; here they are K calls of
    the same captured graphs.)"""
    init_states, cycle = make_multi_cycle(
        models, train_cfg, optics, with_features, merge_scans, stack_pairs, device
    )

    def cycles(states, generators, lrs, batch_size: int, val_videos=None, val_targets=None, val_features=None):
        losses: List[Dict[str, torch.Tensor]] = []
        vals: List[Dict[str, torch.Tensor]] = []
        for g, lr in zip(generators, lrs, strict=True):
            states, loss, val = cycle(states, g, float(lr), batch_size, val_videos, val_targets, val_features)
            losses.append(loss)
            vals.append(val)
        stack = lambda rows: {k: torch.stack([r[k] for r in rows]) for k in (rows[0] if rows else {})}  # noqa: E731
        return states, stack(losses), stack(vals)

    cycles.engine = cycle.engine
    return init_states, cycles


def _per_model(states: Dict[str, Any], stacks) -> Dict[str, TrainState]:
    per = {k: v for k, v in states.items() if not k.startswith("stack:")}
    for members, _, _ in stacks:
        per.update(zip(members, states[_stack_key(members)]))
    return per
