"""Cycle-based training loop.

Port of ``moleculardiffusion_mivit_tpu/train/loop.py`` for one model:
``num_cycles`` dataset-refresh cycles; each generates fresh sequences for
every D class on the device, trains one AdamW epoch over them in a shuffled
order (remainder dropped), steps the staircase learning rate, and scores the
frozen validation videos with predictions rescaled by
``d_max_normalization``. PyTorch runs the epoch as a Python loop of steps,
where the JAX package compiles it into one scan. The model is any of the
baseline experiment's seven: BatchNorm runs through K2/K3 (the deep-ResNet
embedding) or through torch operators (``MultiImageResNet``), and either way
its running statistics move in the training forward and are applied in
``evaluate``. On a CUDA device every convolution of a step, forward and
backward, runs in full f32 with deterministic algorithms
(``ops.fused_embedding.f32_convolutions``), so a seed gives the same bits on
every run.

The losses are mse and l1; in sequence mode ``mix_trajectories`` swaps
trajectory tails across D classes after generation
(``mix_trajectory_tails``). With ``with_features`` a model also takes the
25 global trajectory features of each sequence (``features``), gathered
with the same minibatch indices.

``compute_dtype="bfloat16"`` runs each step's forward and backward in bf16,
as the JAX package's ``_cast_for_compute``: the f32 parameters and the
minibatch (videos, features) are cast to bf16 inside the step
(``torch.func.functional_call`` on bf16 copies, not ``torch.autocast``),
the gradients flow back through the cast into the f32 masters, and AdamW
with its state, the BatchNorm running statistics and ``evaluate`` stay f32.
The loss is taken in f32. The deep-ResNet embedding then runs K2-bf16/K3-bf16
(``ops.fused_embedding``).

Dropout is keyed as the JAX package keys it (``models.dropout``): each
cycle's ``train_cycle`` takes the model's dropout key from its generator
(``utils.rng.dropout_key``, beside the permutation it draws), and each step
folds in its minibatch's first index ``idx[0]``. A run with dropout is then
a function of its seed, on any layout of the cycle: eager or captured, a
model alone or a grid member, unsharded or its minibatch split over ranks.

On the card a model's optimizer may be *capturable* (``make_optimizer(...,
capturable=True)``): its learning rate is then a 0-d device tensor that
``_set_lr`` fills in place, so a CUDA graph that holds the AdamW step
(``train.capture``) reads each cycle's rate without being captured again.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.features import compute_features_for_multiple_trajectories
from moleculardiffusion_mivit_tpu_torch.models import init_model
from moleculardiffusion_mivit_tpu_torch.models.dropout import key_tensor, keyed_dropout, step_key, uses_dropout
from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import f32_convolutions
from moleculardiffusion_mivit_tpu_torch.parallel.collectives import BatchSplit, loss_share, sharded_rows
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import GenerationPart, part_units
from moleculardiffusion_mivit_tpu_torch.sim import (
    average_trajectories_frames,
    render_videos,
    single_state,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import dropout_key, fold_in, seeded_generator


class TrainState(NamedTuple):
    """The model (parameters and BN running statistics) and its AdamW
    optimizer (moments and step counts). Both update in place."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


class TrainImpls(NamedTuple):
    init_state: Callable
    train_cycle: Callable
    evaluate: Callable
    train_step: Callable


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig, capturable: bool = False) -> torch.optim.AdamW:
    """AdamW on every parameter, as optax's unmasked ``adamw``: b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, decoupled weight decay.

    ``capturable`` (parameters on the card): the update runs without host
    synchronisation, so a CUDA graph can hold it, and the learning rate is a
    0-d tensor beside the parameters that ``_set_lr`` fills."""
    lr = cfg.lr
    if capturable:
        lr = torch.tensor(cfg.lr, dtype=torch.float32, device=next(model.parameters()).device)
    return torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay,
        capturable=capturable,
    )


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's learning rate: in place where it is a tensor (a
    captured graph reads that tensor), by assignment where it is a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_supported(cfg: TrainConfig) -> None:
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; expected one of {list(COMPUTE_DTYPES)}")
    if cfg.loss not in ("mse", "l1"):
        raise ValueError(f"unknown loss {cfg.loss!r}; expected 'mse' or 'l1'")


def _cast_for_compute(cfg: TrainConfig, params: Dict[str, torch.Tensor], bv, bf):
    """``(params, videos, features)`` in the step's compute dtype: at bf16
    every f32 tensor cast (a differentiable cast, so gradients reach the f32
    masters), anything else as it is. At float32 every tensor is returned
    as it is."""
    dtype = COMPUTE_DTYPES[cfg.compute_dtype]
    cast = lambda v: v.to(dtype) if v.dtype == torch.float32 else v  # noqa: E731
    return {n: cast(p) for n, p in params.items()}, cast(bv), None if bf is None else cast(bf)


def _loss(pred: torch.Tensor, y: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "l1":
        return torch.mean(torch.abs(pred - y))
    return torch.mean((pred - y) ** 2)


def swap_tails(arrays, ia, ib, splits) -> Tuple[torch.Tensor, ...]:
    """Swap the frames at and after ``splits[k]`` of sequence ``ia[k]`` with
    those of ``ib[k]`` in every frame-major array of ``arrays`` (``(N, F,
    ...)``: videos, per-frame labels, tokens, trajectories), at the same
    splits. Returns new tensors."""
    frame = torch.arange(arrays[0].shape[1], device=arrays[0].device)
    tail = frame[None, :] >= splits[:, None]
    out = []
    for arr in arrays:
        mask = tail.reshape(tail.shape + (1,) * (arr.ndim - 2))
        a, b = arr[ia], arr[ib]
        out.append(arr.index_copy(0, ia, torch.where(mask, b, a)).index_copy(0, ib, torch.where(mask, a, b)))
    return tuple(out)


def _tail_splits(generator: torch.Generator, count: int, n_frames: int) -> torch.Tensor:
    """``count`` split frames uniform in ``[n_frames/2 - 5, n_frames/2 + 5)``."""
    return torch.randint(
        n_frames // 2 - 5, n_frames // 2 + 5, (count,), generator=generator, device=generator.device
    )


# (class a, class b, first sequence within the class in quarters) of the
# four tail swaps of ``mix_trajectory_tails``
_TAIL_PAIRS = ((0, 3, 0), (0, 2, 1), (1, 3, 1), (1, 2, 0))


def mix_trajectory_tails(
    generator: torch.Generator, videos, labels, n_classes: int, n_frames: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-mode tail-swap augmentation, as the JAX package's: for the
    first half of each of the first four classes (two quarter-blocks against
    two partner classes: 0↔3 and 1↔2 on the first quarter, 0↔2 and 1↔3 on
    the second), swap video and label tails at a split drawn per pair from
    ``generator`` (one draw of ``quarter`` splits per pair, in this order)."""
    return mix_tails_multi(generator, (videos, labels), n_classes, n_frames)


def mix_tails_multi(generator: torch.Generator, arrays, n_classes: int, n_frames: int) -> Tuple[torch.Tensor, ...]:
    """``mix_trajectory_tails``'s pairs and split draws applied to any number
    of frame-major arrays ``(N, F, ...)`` at the same splits (videos,
    labels, per-frame tokens, frame-averaged trajectories), as the JAX
    example ``sequence_changepoint_modular.py``'s ``mix_tails_multi``."""
    arrays = tuple(arrays)
    n_per = arrays[0].shape[0] // n_classes
    quarter = n_per // 4
    if quarter == 0 or n_classes < 4:
        return arrays
    ar = torch.arange(quarter, device=arrays[0].device)
    for ca, cb, start in _TAIL_PAIRS:
        splits = _tail_splits(generator, quarter, n_frames).to(arrays[0].device)
        first = start * quarter + ar
        arrays = swap_tails(arrays, ca * n_per + first, cb * n_per + first, splits)
    return arrays


def mix_tails_uniform(
    generator: torch.Generator, arrays, n_frames: int, fraction: float = 0.5
) -> Tuple[torch.Tensor, ...]:
    """Continuous-curriculum tail swap, as the JAX package's, applied to any
    number of frame-major arrays ``(N, F, ...)`` at the same splits: sequence
    ``i`` pairs with ``n-1-i`` for the first ``int(n·fraction) // 2`` of
    them, at splits drawn from ``generator`` in the same window."""
    arrays = tuple(arrays)
    n = arrays[0].shape[0]
    half = int(n * fraction) // 2
    if half == 0:
        return arrays
    ia = torch.arange(half, device=arrays[0].device)
    splits = _tail_splits(generator, half, n_frames).to(arrays[0].device)
    return swap_tails(arrays, ia, (n - 1) - ia, splits)


def epoch_permutation(generator: torch.Generator, n: int, batch_size: int, device) -> torch.Tensor:
    """One epoch's minibatch indices ``(n // batch_size, batch_size)``: a
    permutation of ``range(n)`` from ``generator``, remainder dropped."""
    steps = n // batch_size
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm[: steps * batch_size].reshape(steps, batch_size).to(device)


def generate_cycle_data(
    generator: torch.Generator, train_cfg: TrainConfig, optics: OpticsConfig, with_features: bool = False,
    part: Optional[GenerationPart] = None,
):
    """One cycle's fresh dataset on the generator's device: per D class,
    ``single_state`` trajectories divided by ``traj_div_factor``, rendered
    with per-frame centering, normalised against ``(bg_mean, bg_sigma,
    part_mean + bg_mean)``; labels divided by ``d_max_normalization``.
    Class ``i`` simulates from ``fold_in(generator, i, 0)`` and renders from
    ``fold_in(generator, i, 1)``.

    Returns ``(videos (N, F, S, S), labels (N, 1) or (N, F))``, and with
    ``with_features`` also the 25 features ``(N, 25)`` of the frame-averaged
    trajectories (``features.compute_features_for_multiple_trajectories``).
    With ``part`` (``parallel.mesh.GenerationPart``) only the classes of its
    block, their rows bitwise the whole call's; ``None`` for a part with no
    class.
    """
    p = train_cfg.n_pos_per_frame
    t = train_cfg.n_frames * p
    classes = part_units(part, len(train_cfg.training_ds))
    if not classes:
        return None

    all_videos, all_labels, all_trajs = [], [], []
    for i in classes:
        trajs, labels = single_state(fold_in(generator, i, 0), train_cfg.sequences_per_d, t,
                                     Ds=tuple(train_cfg.training_ds[i]))
        trajs = trajs / train_cfg.traj_div_factor
        videos = render_videos(fold_in(generator, i, 1), trajs, train_cfg, optics)
        all_videos.append(videos)
        all_labels.append(labels)
        all_trajs.append(trajs)

    videos = torch.cat(all_videos, dim=0)
    d_per_step = torch.cat(all_labels, dim=0)[:, :, 1]
    if train_cfg.sequence_mode:
        y = d_per_step.reshape(d_per_step.shape[0], train_cfg.n_frames, p).mean(dim=2)
    else:
        y = d_per_step[:, :1]
    y = y / train_cfg.d_max_normalization
    if with_features:
        avg = average_trajectories_frames(torch.cat(all_trajs, dim=0), p)
        return videos, y, compute_features_for_multiple_trajectories(avg, dt=1.0)
    return videos, y


def make_train_impls(
    model: torch.nn.Module, train_cfg: TrainConfig, device=None, with_features: bool = False,
    constrain_batch: Optional[BatchSplit] = None,
) -> TrainImpls:
    """``(init_state, train_cycle, evaluate, train_step)`` for one model;
    with ``with_features`` the model is called as ``model(videos,
    features)``.

    - ``init_state(generator)`` initialises the model from a CPU generator,
      moves it to the device and makes its optimizer.
    - ``train_step(state, videos, labels, idx, act_slope=None,
      features=None, drop_key=None)`` is one minibatch forward/backward/AdamW
      update at the optimizer's current LR, in ``compute_dtype``
      (``act_slope``: see ``models.layers.FeedForward``; ``features`` are
      indexed by ``idx`` like the videos; ``drop_key``, a 0-d int64 tensor
      on the device, the cycle's dropout key, needed by a model with
      dropout > 0, folded with ``idx[0]``); returns the loss (on the device,
      not synchronised). It makes no host synchronisation, so
      ``train.capture`` captures it in a CUDA graph.
    - ``train_cycle(state, videos, labels, generator, lr, batch_size,
      features=None)`` runs one epoch in a permuted order drawn from
      ``generator``, with the dropout key ``utils.rng.dropout_key(generator)``;
      returns the mean loss.
    - ``evaluate(state, videos, features=None)`` returns eval-mode
      predictions × ``d_max_normalization``.

    ``constrain_batch`` (a ``parallel.collectives.BatchSplit``, the
    counterpart of the JAX package's hook of that name): the step's
    minibatch ``idx`` is the global one, the same on every rank of the
    split; the rank keeps its rows of it, runs the forward inside
    ``sharded_rows`` (BatchNorm and K2/K3 take global statistics),
    back-propagates its share of the minibatch mean and sums the gradients
    and the loss over the split's group before AdamW, so the parameters
    stay the same on every rank and the returned loss is the minibatch's.
    Dropout folds the global ``idx[0]`` and takes the rank's global rows, so
    a rank's mask is its rows of the minibatch's mask.
    """
    _check_supported(train_cfg)
    dev = resolve_device(device)
    split = constrain_batch
    dropout = uses_dropout(model)

    def init_state(generator: torch.Generator) -> TrainState:
        init_model(model, generator)
        model.to(dev).train()
        return TrainState(model, make_optimizer(model, train_cfg))

    def inputs(videos, features):
        if not with_features:
            return (videos,)
        if features is None:
            raise ValueError("this model takes features: pass features=")
        return videos, features

    def train_step(state: TrainState, videos, labels, idx, act_slope=None, features=None,
                   drop_key=None) -> torch.Tensor:
        total = idx.shape[0]
        keys = None if drop_key is None else step_key(drop_key, idx[0])
        lo, hi = (0, total) if split is None else split.bounds(total)
        idx = idx[lo:hi]
        bv, by = videos.index_select(0, idx), labels.index_select(0, idx)
        bf = None if features is None else features.index_select(0, idx)
        kwargs = {} if act_slope is None else {"act_slope": act_slope}
        rows = None if split is None else split.rows(total)
        # autograd's convolutions read the setting when they run
        with f32_convolutions(), sharded_rows(rows), keyed_dropout(keys):
            params, bv, bf = _cast_for_compute(train_cfg, dict(state.model.named_parameters()), bv, bf)
            out = functional_call(state.model, params, inputs(bv, bf), kwargs)
            if by.ndim == 2 and out.ndim == 3:
                by = by[..., None]
            loss = loss_share(lambda o: _loss(o, by, train_cfg.loss), out.float(), hi - lo, total)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if split is not None:
            loss = split.reduce(state.model.parameters(), loss)
        state.optimizer.step()
        return loss.detach()

    def train_cycle(state: TrainState, videos, labels, generator, lr: float, batch_size: int, features=None):
        perm = epoch_permutation(generator, videos.shape[0], batch_size, videos.device)
        key = key_tensor(dropout_key(generator), videos.device) if dropout else None
        _set_lr(state.optimizer, lr)
        state.model.train()
        losses = [train_step(state, videos, labels, idx, features=features, drop_key=key) for idx in perm]
        return torch.stack(losses).mean()

    @torch.no_grad()
    def evaluate(state: TrainState, videos, features=None):
        state.model.eval()
        try:
            return state.model(*inputs(videos, features)) * train_cfg.d_max_normalization
        finally:
            state.model.train()

    return TrainImpls(init_state, train_cycle, evaluate, train_step)


def run_training(
    model: torch.nn.Module,
    train_cfg: TrainConfig,
    optics: OpticsConfig,
    val_videos: Dict[float, torch.Tensor],
    num_cycles: Optional[int] = None,
    callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
    device=None,
):
    """End-to-end cycle runner for a single model on ``device`` (CUDA
    unless the caller passes another; raises without a card).

    ``val_videos`` maps true D → frozen rendered validation videos. Returns
    ``(state, history)`` with history ``{"val_<D>": [...], "val_avg": [...],
    "train_loss": [...]}``, one entry per cycle. The validation MSEs do not
    depend on the caller's ``torch.backends.cudnn.allow_tf32``: the
    embedding's eval-mode convolutions run in full f32 on the card
    (``models.embeddings``), as its training kernels do.
    """
    dev = resolve_device(device)
    num_cycles = num_cycles or train_cfg.num_cycles
    init_state, train_cycle, evaluate, _ = make_train_impls(model, train_cfg, dev)
    state = init_state(seeded_generator("cpu", train_cfg.seed, 0))

    history = {f"val_{d:g}": [] for d in val_videos}
    history["val_avg"] = []
    history["train_loss"] = []
    val_on_dev = {d: v.to(dev) for d, v in val_videos.items()}

    for cycle in range(num_cycles):
        videos, labels = generate_cycle_data(
            seeded_generator(dev, train_cfg.seed, 1, cycle), train_cfg, optics
        )
        if train_cfg.mix_trajectories:
            videos, labels = mix_trajectory_tails(
                seeded_generator(dev, train_cfg.seed, 3, cycle), videos, labels,
                len(train_cfg.training_ds), train_cfg.n_frames,
            )
        loss = train_cycle(
            state, videos, labels, seeded_generator(dev, train_cfg.seed, 2, cycle),
            train_cfg.lr_for_cycle(cycle), train_cfg.batch_size_for_cycle(cycle),
        )
        history["train_loss"].append(float(loss))

        per_d = []
        for d, vv in val_on_dev.items():
            preds = evaluate(state, vv)
            err = preds[..., 0] if preds.ndim == 3 else preds[:, 0]
            mse = float(torch.mean((err - d) ** 2))
            history[f"val_{d:g}"].append(mse)
            per_d.append(mse)
        avg = sum(per_d) / len(per_d)
        history["val_avg"].append(avg)
        if callback:
            callback(cycle, {"train_loss": float(loss), "val_avg": avg})
    return state, history
