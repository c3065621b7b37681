"""ImagesFeatures (hybrid) experiment: the poster's headline comparison.

Port of ``moleculardiffusion_mivit_tpu/experiments/images_features.py``.
Learned arms: the image-only transformer (``im_tr``), the early- and
late-fusion transformers with the 25 trajectory features
(``im_ft_early_tr``, ``im_ft_late_tr``), the image-only CNN
(``im_resnet``), CNN + features (``im_ft_resnet``) and the features-only
MLP (``ft_mlp``). Non-learned MSD arms: ``MSD_Perfect`` = MSD(τ=1) of the
raw sub-position trajectory × 250, ``MSD_Frame`` / ``MSD_Localized`` =
MSD(τ=1) of the frame-averaged trajectory (± localisation noise N(0, 0.01))
× 37.5, each × D_max like a model's output.

Each cycle makes, per D class, trajectories, normalised videos and the
trajectory variants, and the 25 features of the frame-averaged
trajectories (``make_dataset``; ``make_datasets`` renders one set of
trajectories under several generators in one K1 launch). An arm's plain or
rotation-TTA predictions: ``arm_predictions``; the TTA tables of the image
arms: ``tta_error_tables``.

Random streams (``utils.rng``), mirroring the JAX package's ``fold_in``
layout:

- cycle data: ``generate_fn(g, part=None)``, with ``g`` the experiment's
  per-cycle stream; class ``i`` simulates from ``fold_in(g, i, 0)`` and
  makes its dataset from ``fold_in(g, i, 1)``; with a mesh's ``part``, its
  classes alone (their features too);
- ``make_dataset(g, ...)``: the render from ``fold_in(g, 0)``, the
  localisation noise from ``fold_in(g, 1)``;
- validation at D: ``make_dataset`` from ``(seed + 99, int(D))``;
- the in-order sweep: ``make_dataset`` from ``fold_in((seed + 99), 777)``
  (``evaluation.build_in_order_data``); the ``"imft"`` trajectories are
  the JAX package's own array (``evaluation.generate_in_order_imft``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import (
    IN_ORDER_D_VALUES,
    IN_ORDER_IMFT_D_VALUES,
    build_in_order_data,
    error_table,
    generate_in_order_imft,
    load_validation_trajectories,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, ModelEntry, rotate_videos
from moleculardiffusion_mivit_tpu_torch.features import (
    N_FEATURES,
    compute_features_for_multiple_trajectories,
    d_from_msd_tau1,
)
from moleculardiffusion_mivit_tpu_torch.models import (
    GeneralTransformer,
    MLPHead,
    MultiImageFeatureResNet,
    MultiImageResNet,
)
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import part_units
from moleculardiffusion_mivit_tpu_torch.sim import (
    average_trajectories_frames,
    render_videos,
    render_videos_blocks,
    render_videos_many,
    single_state,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

MSD_MULT_FACTOR = 250.0  # raw sub-position trajectories (dt = 1 sub-step)
MSD_MULT_FACTOR_AVG = 37.5  # frame-averaged trajectories
LOCALIZATION_UNCERTAINTY = (0.0, 0.01)


class FeatureMLP(nn.Module):
    """The ``ft_mlp`` arm: an MLP head on the features alone."""

    def __init__(self, in_dim: int = N_FEATURES, hidden_dim: int = 128):
        super().__init__()
        self.head = MLPHead(in_dim, hidden_dim)

    def forward(self, features):
        return self.head(features)


def _trajectory_variants(generator: torch.Generator, trajs, videos, train_cfg: TrainConfig) -> Dict[str, Any]:
    """The videos beside the raw, frame-averaged and averaged + localisation
    noise (from ``generator``) trajectories."""
    trajs_avg = average_trajectories_frames(trajs, train_cfg.n_pos_per_frame)
    err_mean, err_sigma = LOCALIZATION_UNCERTAINTY
    noise = err_mean + err_sigma * torch.randn(trajs_avg.shape, generator=generator, device=generator.device)
    return {"videos": videos, "trajs_raw": trajs, "trajs_avg": trajs_avg, "trajs_avg_err": trajs_avg + noise}


def _render_dataset(generator, trajs, train_cfg: TrainConfig, optics) -> Dict[str, Any]:
    """``make_dataset`` without the features."""
    if isinstance(generator, torch.Generator):
        videos = render_videos(fold_in(generator, 0), trajs, train_cfg, optics)
        return _trajectory_variants(fold_in(generator, 1), trajs, videos, train_cfg)
    videos = render_videos_blocks([fold_in(g, 0) for g in generator], trajs, train_cfg, optics)
    blocks = [_trajectory_variants(fold_in(g, 1), t, v, train_cfg)
              for g, t, v in zip(generator, trajs.chunk(len(generator)), videos.chunk(len(generator)))]
    return {k: torch.cat([b[k] for b in blocks]) for k in blocks[0]}


def make_dataset(generator, trajs, train_cfg: TrainConfig, optics, dt: float = 1.0) -> Dict[str, Any]:
    """Normalised videos, the 25 features of the frame-averaged trajectories,
    and the three trajectory variants (raw, averaged, averaged +
    localisation noise), on the generator's device. ``generator`` may be a
    list: the rows then split into as many equal blocks, block ``b`` made
    from ``generator[b]`` alone (bitwise ``make_dataset`` of that block),
    every block rendered in one K1 launch and the features of all rows in
    one call."""
    data = _render_dataset(generator, trajs, train_cfg, optics)
    data["features"] = compute_features_for_multiple_trajectories(data["trajs_avg"], dt=dt)
    return data


def make_datasets(generators, trajs, train_cfg: TrainConfig, optics, dt: float = 1.0):
    """``make_dataset(g, trajs, ...)`` for each of ``generators``, as a list:
    every render in one K1 launch (``sim.render_videos_many``), each from its
    own generator's streams; the features, which depend on the trajectories
    alone, computed once and shared."""
    videos = render_videos_many([fold_in(g, 0) for g in generators], trajs, train_cfg, optics)
    out = [_trajectory_variants(fold_in(g, 1), trajs, v, train_cfg) for g, v in zip(generators, videos)]
    features = compute_features_for_multiple_trajectories(out[0]["trajs_avg"], dt=dt)
    for data in out:
        data["features"] = features
    return out


def build(
    seed: int = 0,
    sequences_per_d: int = 64,
    val_length: int = 30,
    val_d_values=(1.0, 3.0, 5.0, 7.0, 9.0),
    with_in_order: bool = False,
    in_order_suite: str = "imft",
    device=None,
) -> Experiment:
    """The images-features ``Experiment`` on ``device`` (CUDA unless told
    otherwise; raises without a card). ``in_order_suite``: ``"imft"`` (the
    published protocol, a deterministic 100-value D = 0.1..10.0 sweep) or
    ``"committed"`` (the 70-value ``valTrajsInOrder`` set, D ≤ 7.0)."""
    dev = resolve_device(device)
    train_cfg = TrainConfig(
        seed=seed,
        sequences_per_d=sequences_per_d,
        training_ds=((1, 1), (3, 1), (5, 1), (7, 1), (9, 1)),
        n_frames=val_length,
    )
    model_cfg = ModelConfig(use_pos_encoding=False)
    optics = BASELINE_OPTICS
    d_max = train_cfg.d_max_normalization

    def im_slice(data):
        return data["videos"], None, data["labels"]

    def im_ft_slice(data):
        return data["videos"], data["features"], data["labels"]

    def ft_slice(data):
        return data["features"], None, data["labels"]

    def fusion(kind):
        return GeneralTransformer(model_cfg, embedding="deep_resnet", use_global_features=True,
                                  fusion_type=kind, global_feature_dim=N_FEATURES)

    arms = {
        "im_tr": ModelEntry(model=GeneralTransformer(model_cfg, embedding="deep_resnet"), slice_fn=im_slice),
        "im_ft_early_tr": ModelEntry(model=fusion("early"), slice_fn=im_ft_slice, with_features=True),
        "im_ft_late_tr": ModelEntry(model=fusion("late"), slice_fn=im_ft_slice, with_features=True),
        "im_resnet": ModelEntry(model=MultiImageResNet(), slice_fn=im_slice),
        "im_ft_resnet": ModelEntry(
            model=MultiImageFeatureResNet(N_FEATURES, feature_size=model_cfg.embed_dim,
                                          hidden_size=model_cfg.hidden_dim),
            slice_fn=im_ft_slice,
            with_features=True,
        ),
        "ft_mlp": ModelEntry(model=FeatureMLP(), slice_fn=ft_slice),
        "MSD_Perfect": ModelEntry(baseline_fn=lambda d: d_from_msd_tau1(d["trajs_raw"]) * MSD_MULT_FACTOR * d_max),
        "MSD_Frame": ModelEntry(baseline_fn=lambda d: d_from_msd_tau1(d["trajs_avg"]) * MSD_MULT_FACTOR_AVG * d_max),
        "MSD_Localized": ModelEntry(
            baseline_fn=lambda d: d_from_msd_tau1(d["trajs_avg_err"]) * MSD_MULT_FACTOR_AVG * d_max
        ),
    }

    p = train_cfg.n_pos_per_frame
    t = train_cfg.n_frames * p

    def generate_fn(generator, part=None):
        classes = part_units(part, len(train_cfg.training_ds))
        if not classes:
            return None
        parts, labels = [], []
        for i in classes:
            trajs, lab = single_state(fold_in(generator, i, 0), sequences_per_d, t, Ds=tuple(train_cfg.training_ds[i]))
            parts.append(_render_dataset(fold_in(generator, i, 1), trajs / train_cfg.traj_div_factor,
                                         train_cfg, optics))
            labels.append(lab[:, :1, 1] / d_max)
        merged = {k: torch.cat([d[k] for d in parts], dim=0) for k in parts[0]}
        # the features of every class at once (each row is its trajectory's alone)
        merged["features"] = compute_features_for_multiple_trajectories(merged["trajs_avg"], dt=1.0)
        merged["labels"] = torch.cat(labels, dim=0)
        return merged

    frozen = load_validation_trajectories(length=val_length, device=dev)
    val_data = {}
    for d in val_d_values:
        name = f"val{d:g}"
        if name in frozen:
            tr = torch.as_tensor(frozen[name], dtype=torch.float32, device=dev) / train_cfg.traj_div_factor
            vdata = make_dataset(seeded_generator(dev, seed + 99, int(d)), tr, train_cfg, optics)
            vdata["labels"] = None
            val_data[d] = vdata

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
            in_order = build_in_order_data(arr, d_values, seeded_generator(dev, seed + 99), train_cfg, optics,
                                           make_dataset)

    return Experiment("images_features", train_cfg, optics, arms, generate_fn, val_data, in_order, device=dev)


# the image arms and their TTA rows' names in the reference's tables
TTA_ARMS = (("im_tr", "im_tr_rot"), ("im_resnet", "im_res_rot"), ("im_ft_resnet", "im_ft_res_rot"),
            ("im_ft_early_tr", "im_ft_tr_rot"))


def arm_predictions(exp: Experiment, data, arm: str, tta: bool) -> torch.Tensor:
    """One learned arm's predictions ``(N,)`` in D units on ``data``: plain,
    or with ``tta`` the mean over the videos rotated by 0, 90, 180 and 270°
    (the features unrotated). An arm without images (``ft_mlp``) gives its
    plain prediction either way."""
    entry = exp.arms[arm]
    evaluate, state = exp._impls[arm].evaluate, exp.states[arm]
    inputs, feats, _ = entry.slice_fn(data)
    inputs = inputs.to(exp.device)
    feats = feats.to(exp.device) if entry.with_features else None
    if not tta or inputs.ndim != 4:
        return evaluate(state, inputs, feats)[..., 0]
    return torch.stack([evaluate(state, rotate_videos(inputs, k), feats) for k in range(4)]).mean(dim=0)[..., 0]


def tta_error_tables(exp: Experiment, data, d_values) -> Dict[str, Dict[str, float]]:
    """Rotation test-time augmentation of the trained image arms
    (``arm_predictions`` with ``tta``), scored as poster error tables under
    the reference's ``*_rot`` names."""
    return {rot: error_table(arm_predictions(exp, data, name, True).reshape(len(d_values), -1).cpu().numpy(), d_values)
            for name, rot in TTA_ARMS}
