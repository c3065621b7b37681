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
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import part_units
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
    ``mix_tails_uniform``. ``generate_fn(generator, part=None)`` draws the
    data from ``fold_in(generator, 0)`` (``generate_cycle_data``: class
    ``i`` from its own streams); in the continuous curriculum D from
    ``fold_in(generator, 2)`` and the walks from ``fold_in(generator, 0)``
    for every row, and block ``b`` of ``sequences_per_d`` rows renders from
    ``fold_in(generator, 3, b)``. The mixing splits come from
    ``fold_in(generator, 1)``. With a ``part`` (on a mesh) it returns that
    part's classes or blocks, unmixed: the experiment's ``finish_fn`` mixes
    the gathered cycle."""
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
        n_blocks = len(train_cfg.training_ds)
        n_total = sequences_per_d * n_blocks
        p = train_cfg.n_pos_per_frame

        def mix(generator, data):
            data["videos"], data["labels"] = mix_tails_uniform(fold_in(generator, 1), (data["videos"], data["labels"]),
                                                               train_cfg.n_frames)
            return data

        def generate_part(generator, part):
            blocks = part_units(part, n_blocks)
            if not blocks:
                return None
            gd = fold_in(generator, 2)
            d = d_lo + (d_hi - d_lo) * torch.rand(n_total, generator=gd, device=gd.device)
            trajs = brownian_motion(fold_in(generator, 0), n_total, train_cfg.n_frames, p, d,
                                    float(p)) / train_cfg.traj_div_factor
            rows = slice(blocks.start * sequences_per_d, blocks.stop * sequences_per_d)
            videos = torch.cat([render_videos(fold_in(generator, 3, b),
                                              trajs[b * sequences_per_d:(b + 1) * sequences_per_d], train_cfg, optics)
                                for b in blocks])
            dn = d[rows] / train_cfg.d_max_normalization
            if train_cfg.sequence_mode:
                labels = dn[:, None].expand(dn.shape[0], train_cfg.n_frames).contiguous()
            else:
                labels = dn[:, None]
            return {"videos": videos, "labels": labels}

    else:

        def mix(generator, data):
            data["videos"], data["labels"] = mix_trajectory_tails(
                fold_in(generator, 1), data["videos"], data["labels"], len(train_cfg.training_ds), train_cfg.n_frames
            )
            return data

        def generate_part(generator, part):
            out = generate_cycle_data(fold_in(generator, 0), train_cfg, optics, part=part)
            return None if out is None else {"videos": out[0], "labels": out[1]}

    finish_fn = mix if train_cfg.mix_trajectories else None

    def generate_fn(generator, part=None):
        data = generate_part(generator, part)
        return mix(generator, data) if part is None and finish_fn else data

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
    return Experiment("baseline", train_cfg, optics, arms, generate_fn, val_data, in_order, device=dev,
                      finish_fn=finish_fn)
