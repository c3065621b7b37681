"""Denoising experiment: seven input settings, a transformer and a ResNet each.

Port of ``moleculardiffusion_mivit_tpu/experiments/denoising.py`` (the
reference's Experiments/Denoising/). Seven settings, ``SETTINGS``: the
noise-free frames, the frames with background, with shot noise, the
shot-noise frames Gaussian-filtered, and RL-TV-deconvolved after 2, 5 and
10 iterations (``denoise.trajs_to_vid_norm_rl``, one ``(N, 7, F, 9, 9)``
stack a cycle). A deep-ResNet ``GeneralTransformer`` with a learned
positional embedding and a ``MultiImageResNet`` per setting: 14 models,
trained with **L1 loss** on D classes 1, 3, 5, 7 (validation stays MSE).
The 7 transformers form one ``GridArm`` (``trans_grid``) and the 7 ResNets
another (``resnet_grid``); member ``m`` reads setting ``SETTINGS[m]``.

Random streams (``utils.rng``): cycle data from ``generate_fn(g,
part=None)``, class ``i`` simulating from ``fold_in(g, i, 0)`` and rendering
from ``fold_in(g, i, 1)`` (with a mesh's ``part``, its classes alone: their
render, noise and RL-TV); validation at D rendered from ``(seed + 99,
int(D))``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig, OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.denoise import trajs_to_vid_norm_rl
from moleculardiffusion_mivit_tpu_torch.evaluation import load_validation_trajectories
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, GridArm
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import part_units
from moleculardiffusion_mivit_tpu_torch.sim import single_state
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

RL_ITERATIONS: Tuple[int, ...] = (2, 5, 10)
SETTINGS = ("no_noise", "gaussian_noise", "poisson_noise", "gauss_filter", "RL_2", "RL_5", "RL_10")

# The reference's trainSettingsMult.py:58-80: part_mean = 5400 - 1420.
DENOISING_OPTICS = OpticsConfig(
    particle_intensity=(5400.0 - 1420.0, 500.0),
    psf_division_factor=1.3,
    output_size=9,
    background_intensity=(1420.0, 290.0),
    poisson_noise=100.0,
    trajectory_unit=1200.0,
)


def grid_slice(data):
    """``(N, 7, F, S, S)`` → setting-major ``(7, N, F, S, S)`` and the shared
    labels tiled over the settings (a generation part's: over its members'
    settings)."""
    videos_m = data["videos"].transpose(0, 1)
    labels = data["labels"]
    labels_m = None if labels is None else labels[None].expand((videos_m.shape[0],) + tuple(labels.shape))
    return videos_m, None, labels_m


def build(
    seed: int = 0,
    sequences_per_d: int = 64,
    val_length: int = 30,
    val_d_values=(1.0, 3.0, 5.0, 7.0),
    device=None,
) -> Experiment:
    """The denoising ``Experiment`` on ``device`` (CUDA unless told
    otherwise; raises without a card)."""
    dev = resolve_device(device)
    train_cfg = TrainConfig(
        seed=seed,
        num_cycles=10,  # trainModels_different_settings.py:56
        sequences_per_d=sequences_per_d,
        training_ds=((1, 1), (3, 1), (5, 1), (7, 1)),
        n_frames=val_length,
        loss="l1",
    )
    model_cfg = ModelConfig(use_pos_encoding=True)
    optics = DENOISING_OPTICS
    p = train_cfg.n_pos_per_frame
    t = train_cfg.n_frames * p
    arms = {
        "trans_grid": GridArm(model=GeneralTransformer(model_cfg, embedding="deep_resnet"),
                              names=[f"trans_{s}" for s in SETTINGS], slice_fn=grid_slice),
        "resnet_grid": GridArm(model=MultiImageResNet(), names=[f"resnet_{s}" for s in SETTINGS],
                               slice_fn=grid_slice),
    }

    def render(generator, trajs):
        return trajs_to_vid_norm_rl(generator, trajs, p, train_cfg.center, optics, RL_ITERATIONS)

    def generate_fn(generator, part=None):
        classes = part_units(part, len(train_cfg.training_ds))
        if not classes:
            return None
        videos, labels = [], []
        for i in classes:
            trajs, lab = single_state(fold_in(generator, i, 0), sequences_per_d, t, Ds=tuple(train_cfg.training_ds[i]))
            videos.append(render(fold_in(generator, i, 1), trajs / train_cfg.traj_div_factor))
            labels.append(lab[:, :1, 1] / train_cfg.d_max_normalization)
        videos = torch.cat(videos)
        if part is not None and part.members is not None:  # every setting comes of one RL-TV run: keep its members'
            videos = videos[:, part.members]
        return {"videos": videos, "labels": torch.cat(labels)}

    frozen = load_validation_trajectories(length=val_length, device=dev)
    val_data = {}
    for d in val_d_values:
        name = f"val{d:g}"
        if name in frozen:
            tr = torch.as_tensor(frozen[name], dtype=torch.float32, device=dev) / train_cfg.traj_div_factor
            val_data[d] = {"videos": render(seeded_generator(dev, seed + 99, int(d)), tr), "labels": None}

    return Experiment("denoising", train_cfg, optics, arms, generate_fn, val_data, device=dev)
