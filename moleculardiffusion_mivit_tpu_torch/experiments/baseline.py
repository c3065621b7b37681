"""Baseline experiment.

Port of ``moleculardiffusion_mivit_tpu/experiments/baseline.py``: seven
models (GeneralTransformer with the linear, cnn and deep_resnet embeddings,
each with relu and leaky_relu, plus MultiImageResNet) trained on 4 D classes
× 64 sequences per cycle with real-data-derived optics (patch 9, 30 frames).
Sequence mode (``sequences=True``) switches to per-frame predictions and
tail-swap trajectory mixing.
"""

from __future__ import annotations

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import (
    IN_ORDER_D_VALUES,
    load_validation_trajectories,
    render_validation_videos,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, ModelEntry
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet
from moleculardiffusion_mivit_tpu_torch.sim import brownian_motion, render_videos
from moleculardiffusion_mivit_tpu_torch.train.loop import (
    generate_cycle_data,
    mix_tails_uniform,
    mix_trajectory_tails,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in


def build(
    seed: int = 0,
    sequences: bool = False,
    try_leaky_relu: bool = True,
    val_length: int = 30,
    val_d_values=(1.0, 3.0, 5.0, 7.0),
    sequences_per_d: int = 64,
    continuous_d=None,
    device=None,
) -> Experiment:
    """The baseline ``Experiment`` on ``device`` (CUDA unless told
    otherwise). ``continuous_d=(lo, hi)`` swaps the 4-class curriculum for
    per-sequence D ~ Uniform(lo, hi) at the same per-cycle budget (4 ×
    sequences_per_d); in sequence mode the tail swap is then
    ``mix_tails_uniform``. ``generate_fn(generator)`` draws the data from
    ``fold_in(generator, 0)`` (and D from ``fold_in(generator, 2)`` in the
    continuous curriculum) and the mixing splits from ``fold_in(generator,
    1)``."""
    dev = resolve_device(device)
    train_cfg = TrainConfig(
        seed=seed,
        sequences_per_d=sequences_per_d,
        training_ds=((1, 1), (3, 1), (5, 1), (7, 1)),
        n_frames=val_length,
        sequence_mode=sequences,
        mix_trajectories=sequences,
    )
    model_cfg = ModelConfig(
        use_pos_encoding=True,
        use_regression_token=not sequences,
        single_prediction=not sequences,
    )
    optics = BASELINE_OPTICS

    def identity_slice(data):
        return data["videos"], None, data["labels"]

    arms = {}
    for act, suffix in [("relu", "_s")] + ([("leaky_relu", "_leaky")] if try_leaky_relu else []):
        for emb_key, emb in [("linear_2layer", "linear"), ("cnn_2layer", "cnn"), ("deepcnn_2layer", "deep_resnet")]:
            arms[emb_key + suffix] = ModelEntry(
                model=GeneralTransformer(model_cfg.replace(activation=act), embedding=emb),
                slice_fn=identity_slice,
            )
    arms["resnet"] = ModelEntry(model=MultiImageResNet(single_prediction=not sequences), slice_fn=identity_slice)

    if continuous_d is not None:
        d_lo, d_hi = continuous_d
        n_total = sequences_per_d * len(train_cfg.training_ds)
        p = train_cfg.n_pos_per_frame

        def generate_fn(generator):
            g = fold_in(generator, 0)
            gd = fold_in(generator, 2)
            d = d_lo + (d_hi - d_lo) * torch.rand(n_total, generator=gd, device=gd.device)
            trajs = brownian_motion(g, n_total, train_cfg.n_frames, p, d, float(p)) / train_cfg.traj_div_factor
            videos = render_videos(g, trajs, train_cfg, optics)
            dn = d / train_cfg.d_max_normalization
            if train_cfg.sequence_mode:
                labels = dn[:, None].expand(n_total, train_cfg.n_frames).contiguous()
            else:
                labels = dn[:, None]
            if train_cfg.mix_trajectories:
                videos, labels = mix_tails_uniform(fold_in(generator, 1), (videos, labels), train_cfg.n_frames)
            return {"videos": videos, "labels": labels}

    else:

        def generate_fn(generator):
            videos, labels = generate_cycle_data(fold_in(generator, 0), train_cfg, optics)
            if train_cfg.mix_trajectories:
                videos, labels = mix_trajectory_tails(
                    fold_in(generator, 1), videos, labels, len(train_cfg.training_ds), train_cfg.n_frames
                )
            return {"videos": videos, "labels": labels}

    trajs = load_validation_trajectories(length=val_length, device=dev)
    rendered = render_validation_videos(trajs, train_cfg, optics, device=dev)
    val_data = {d: {"videos": rendered[f"val{d:g}"], "labels": None} for d in val_d_values if f"val{d:g}" in rendered}
    in_order = None
    if "valTrajsInOrder" in rendered:
        vids = rendered["valTrajsInOrder"]
        n_d, n_p = vids.shape[:2]
        in_order = {
            "videos": vids.reshape((n_d * n_p,) + vids.shape[2:]),
            "labels": None,
            "d_values": IN_ORDER_D_VALUES[:n_d],
        }
    return Experiment("baseline", train_cfg, optics, arms, generate_fn, val_data, in_order, device=dev)
