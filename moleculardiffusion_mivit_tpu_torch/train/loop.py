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
backward, runs in full f32 (``ops.fused_embedding.f32_convolutions``).

Not ported yet, and raising ``NotImplementedError``: the bf16
``compute_dtype``, ``mix_trajectories``, the l1 loss and features
(ROADMAP.md, queue 1, items 5 and 8).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import init_model
from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import f32_convolutions
from moleculardiffusion_mivit_tpu_torch.sim import (
    normalize_images,
    single_state,
    trajectories_to_video,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator


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


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW on every parameter, as optax's unmasked ``adamw``: b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, decoupled weight decay."""
    return torch.optim.AdamW(
        model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay
    )


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _check_supported(cfg: TrainConfig) -> None:
    later = "is not ported yet (ROADMAP.md, queue 1, item 5)"
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(f"compute_dtype={cfg.compute_dtype!r} {later}")
    if cfg.loss != "mse":
        raise NotImplementedError(f"loss={cfg.loss!r} {later}")
    if cfg.mix_trajectories:
        raise NotImplementedError(f"mix_trajectories {later}")


def generate_cycle_data(generator: torch.Generator, train_cfg: TrainConfig, optics: OpticsConfig):
    """One cycle's fresh dataset on the generator's device: per D class,
    ``single_state`` trajectories divided by ``traj_div_factor``, rendered
    with per-frame centering, normalised against ``(bg_mean, bg_sigma,
    part_mean + bg_mean)``; labels divided by ``d_max_normalization``.

    Returns ``(videos (N, F, S, S), labels (N, 1) or (N, F))``.
    """
    p = train_cfg.n_pos_per_frame
    t = train_cfg.n_frames * p
    bg_mean, bg_sigma = optics.background_intensity
    part_mean = optics.particle_intensity[0]

    all_videos, all_labels = [], []
    for ds in train_cfg.training_ds:
        trajs, labels = single_state(generator, train_cfg.sequences_per_d, t, Ds=tuple(ds))
        trajs = trajs / train_cfg.traj_div_factor
        videos = trajectories_to_video(generator, trajs, p, train_cfg.center, optics)
        videos, _ = normalize_images(videos, bg_mean, bg_sigma, part_mean + bg_mean)
        all_videos.append(videos)
        all_labels.append(labels)

    videos = torch.cat(all_videos, dim=0)
    d_per_step = torch.cat(all_labels, dim=0)[:, :, 1]
    if train_cfg.sequence_mode:
        y = d_per_step.reshape(d_per_step.shape[0], train_cfg.n_frames, p).mean(dim=2)
    else:
        y = d_per_step[:, :1]
    return videos, y / train_cfg.d_max_normalization


def make_train_impls(model: torch.nn.Module, train_cfg: TrainConfig, device=None) -> TrainImpls:
    """``(init_state, train_cycle, evaluate, train_step)`` for one model.

    - ``init_state(generator)`` initialises the model from a CPU generator,
      moves it to the device and makes its optimizer.
    - ``train_step(state, videos, labels, idx)`` is one minibatch
      forward/backward/AdamW update at the optimizer's current LR; returns
      the loss (on the device, not synchronised).
    - ``train_cycle(state, videos, labels, generator, lr, batch_size)`` runs
      one epoch in a permuted order drawn from ``generator``; returns the
      mean loss.
    - ``evaluate(state, videos)`` returns eval-mode predictions ×
      ``d_max_normalization``.
    """
    _check_supported(train_cfg)
    dev = resolve_device(device)

    def init_state(generator: torch.Generator) -> TrainState:
        init_model(model, generator)
        model.to(dev).train()
        return TrainState(model, make_optimizer(model, train_cfg))

    def train_step(state: TrainState, videos, labels, idx) -> torch.Tensor:
        bv, by = videos[idx], labels[idx]
        with f32_convolutions():  # autograd's convolutions read the setting when they run
            out = state.model(bv)
            if by.ndim == 2 and out.ndim == 3:
                by = by[..., None]
            loss = torch.mean((out.float() - by) ** 2)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.optimizer.step()
        return loss.detach()

    def train_cycle(state: TrainState, videos, labels, generator, lr: float, batch_size: int):
        n = videos.shape[0]
        steps = n // batch_size
        perm = torch.randperm(n, generator=generator, device=generator.device)
        perm = perm[: steps * batch_size].reshape(steps, batch_size).to(videos.device)
        _set_lr(state.optimizer, lr)
        state.model.train()
        losses = [train_step(state, videos, labels, idx) for idx in perm]
        return torch.stack(losses).mean()

    @torch.no_grad()
    def evaluate(state: TrainState, videos):
        state.model.eval()
        try:
            return state.model(videos) * train_cfg.d_max_normalization
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
