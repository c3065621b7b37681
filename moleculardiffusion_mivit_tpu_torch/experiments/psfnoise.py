"""PSF × noise experiment: the published 5 PSF × 6 noise grid.

Port of ``moleculardiffusion_mivit_tpu/experiments/psfnoise.py``. Sixty
models, a deep-ResNet ``GeneralTransformer`` (no positional encoding) and a
``MultiImageResNet`` per grid cell, train on 6 D classes (1, 3, 5, 7, 9 ×
``sequences_per_d`` and the half-count 10.2 tail) rendered once a cycle into
one ``(N, 5, 6, F, 9, 9)`` tensor (``sim.trajectories_to_video_psf_noise_grid``,
``PSFNOISE_OPTICS``); model ``tr_{i}_{j}`` / ``res_{i}_{j}`` trains on cell
(PSF ``i``, noise ``j``). The 30 transformers form one ``GridArm``
(``tr_grid``) and the 30 ResNets another (``res_grid``): each half of the
grid steps as one program (``train.grid``), member ``m = 6 i + j``.

Random streams (``utils.rng``): cycle data from ``generate_fn(g,
part=None)``, class ``i`` simulating from ``fold_in(g, i, 0)`` and rendering
from ``fold_in(g, i, 1)`` (each PSF setting's noise from its own streams);
with a mesh's ``part``, its classes and its members' cells alone (videos
``(N_p, 1, M_p, F, S, S)``: K1 renders those cells' PSF settings alone);
validation at D rendered from ``(seed + 99, int(D))``; the in-order suite
from ``fold_in((seed + 99), 777)`` (``evaluation.build_in_order_data``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import PSFNOISE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import (
    IN_ORDER_D_VALUES,
    IN_ORDER_IMFT_D_VALUES,
    build_in_order_data,
    generate_in_order_imft,
    load_validation_trajectories,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, GridArm, class_sequence_counts
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import part_units
from moleculardiffusion_mivit_tpu_torch.sim import single_state, trajectories_to_video_psf_noise_grid
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

PSF_SETTINGS: Tuple[float, ...] = (2.0, 1.75, 1.5, 1.25, 1.0)
NOISE_SETTINGS: Tuple[float, ...] = (0.0, 1 / 50, 1 / 25, 1 / 20, 1 / 10, 1 / 5)


def grid_slice(data):
    """``(N, N_PSF, N_NOISE, F, S, S)`` → model-major ``(M, N, F, S, S)``
    (member ``i · N_NOISE + j`` reads cell (PSF ``i``, noise ``j``)) and the
    shared labels tiled over the members. All members share one set of
    sequences, the half-count D = 10.2 class included. A generation part's
    cells come as one row of the grid, ``(N, 1, M_p, F, S, S)``
    (``generate_fn``), and give its members' ``(M_p, N, F, S, S)``."""
    v = data["videos"]
    n = v.shape[0]
    m = v.shape[1] * v.shape[2]
    videos_m = v.permute(1, 2, 0, 3, 4, 5).reshape((m, n) + tuple(v.shape[3:]))
    labels = data["labels"]
    labels_m = None if labels is None else labels[None].expand((m,) + tuple(labels.shape))
    return videos_m, None, labels_m


def build(
    seed: int = 0,
    sequences_per_d: int = 64,
    psf_settings: Tuple[float, ...] = PSF_SETTINGS,
    noise_settings: Tuple[float, ...] = NOISE_SETTINGS,
    val_length: int = 30,
    val_d_values=(1.0, 3.0, 5.0, 7.0, 9.0),
    with_in_order: bool = False,
    in_order_suite: str = "imft",
    device=None,
) -> Experiment:
    """The psfnoise ``Experiment`` on ``device`` (CUDA unless told
    otherwise; raises without a card). ``in_order_suite``: ``"imft"`` (the
    published protocol, the 100-value D = 0.1..10.0 sweep the reference's
    PSFNoise loader reshapes to ``(100, 10, ...)``) or ``"committed"`` (the
    70-value ``valTrajsInOrder`` set, D ≤ 7.0)."""
    dev = resolve_device(device)
    n_psf, n_noise = len(psf_settings), len(noise_settings)
    train_cfg = TrainConfig(
        seed=seed,
        sequences_per_d=sequences_per_d,
        training_ds=((1, 1), (3, 1), (5, 1), (7, 1), (9, 1), (10.2, 1)),
        n_frames=val_length,
    )
    optics = PSFNOISE_OPTICS
    model_cfg = ModelConfig(use_pos_encoding=False)
    names = {k: [f"{k}_{i}_{j}" for i in range(n_psf) for j in range(n_noise)] for k in ("tr", "res")}
    arms = {
        "tr_grid": GridArm(model=GeneralTransformer(model_cfg, embedding="deep_resnet"), names=names["tr"],
                           slice_fn=grid_slice),
        "res_grid": GridArm(model=MultiImageResNet(), names=names["res"], slice_fn=grid_slice),
    }
    p = train_cfg.n_pos_per_frame
    t = train_cfg.n_frames * p
    counts = class_sequence_counts(train_cfg.training_ds, sequences_per_d)

    def render(generator, trajs, members=None):
        return trajectories_to_video_psf_noise_grid(
            generator, trajs, p, train_cfg.center, optics, psf_settings, noise_settings, members
        )

    def generate_fn(generator, part=None):
        classes = part_units(part, len(counts))
        if not classes:
            return None
        members = None if part is None else part.members
        videos, labels = [], []
        for i in classes:
            trajs, lab = single_state(fold_in(generator, i, 0), counts[i], t, Ds=tuple(train_cfg.training_ds[i]))
            cells = render(fold_in(generator, i, 1), trajs / train_cfg.traj_div_factor, members)
            videos.append(cells if members is None else cells[:, None])  # a part's cells: one row of the grid
            labels.append(lab[:, :1, 1] / train_cfg.d_max_normalization)
        return {"videos": torch.cat(videos), "labels": torch.cat(labels)}

    frozen = load_validation_trajectories(length=val_length, device=dev)
    val_data = {}
    for d in val_d_values:
        name = f"val{d:g}"
        if name in frozen:
            tr = torch.as_tensor(frozen[name], dtype=torch.float32, device=dev) / train_cfg.traj_div_factor
            val_data[d] = {"videos": render(seeded_generator(dev, seed + 99, int(d)), tr), "labels": None}

    in_order = None
    if with_in_order:
        if in_order_suite == "imft":
            arr = generate_in_order_imft(t_steps=t)
            d_values = IN_ORDER_IMFT_D_VALUES
        elif in_order_suite == "committed":
            arr = frozen.get("valTrajsInOrder")
            d_values = IN_ORDER_D_VALUES
        else:
            raise ValueError(
                f"unknown in_order_suite {in_order_suite!r}; expected 'imft' (the 100-value "
                "D=0.1..10.0 protocol) or 'committed' (the 70-value valTrajsInOrder set)"
            )
        if arr is not None:
            in_order = build_in_order_data(
                arr, d_values, seeded_generator(dev, seed + 99), train_cfg, optics,
                lambda g, trajs, _cfg, _optics: {"videos": render(g, trajs)},
            )

    return Experiment("psfnoise", train_cfg, optics, arms, generate_fn, val_data, in_order, device=dev)
