"""ModularTransformer experiment: per-frame feature tokens beside the images.

Port of ``moleculardiffusion_mivit_tpu/experiments/modular.py``. Five arms
share one generated dataset of videos and per-frame kinematic tokens of the
frame-averaged trajectories (``features.compute_per_frame_features``):

- ``mod_images``: images only;
- ``mod_features``: the per-frame tokens only (the arm is handed the videos
  and never reads them);
- ``mod_both_add``: tokens embedded by a 2-layer MLP and added to the image
  tokens;
- ``mod_both_concat``: concatenated, then projected back to ``embed_dim``;
- ``mod_both_concat_feat``: the image embedded into ``embed_dim − 6`` = 58
  dims and the raw token values concatenated.

``with_hybrid`` adds the composition study's arms: ``glob_early_tr`` (the
25 global features fused early into a ``GeneralTransformer``'s regression
token) and ``hybrid_concat`` / ``hybrid_add`` (``HybridFusionTransformer``:
per-frame tokens and the global features in one model, which takes them
packed as ``(N, 30·6 + 25)``). Every arm embeds images with the deep ResNet
and per-frame tokens with the MLP.

Random streams (``utils.rng``), in the layout of ``images_features``:

- cycle data: ``generate_fn(g, part=None)``, with ``g`` the experiment's
  per-cycle stream; class ``i`` simulates from ``fold_in(g, i, 0)`` and
  renders from ``fold_in(g, i, 1)``; with a mesh's ``part``, its classes
  alone (their tokens and features too);
- ``make_dataset(g, ...)``: the render from ``g``;
- validation at D: ``make_dataset`` from ``(seed + 99, int(D))``;
- the in-order sweep: ``make_dataset`` from ``fold_in((seed + 99), 777)``
  (``evaluation.build_in_order_data``) on the ``"imft"`` suite, the JAX
  package's own array (``evaluation.generate_in_order_imft``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import (
    IN_ORDER_D_VALUES,
    IN_ORDER_IMFT_D_VALUES,
    build_in_order_data,
    generate_in_order_imft,
    load_validation_trajectories,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, ModelEntry
from moleculardiffusion_mivit_tpu_torch.features import (
    N_FEATURES,
    N_PER_FRAME_FEATURES,
    compute_features_for_multiple_trajectories,
    compute_per_frame_features,
)
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, HybridFusionTransformer, ModularTransformer
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import part_units
from moleculardiffusion_mivit_tpu_torch.sim import (
    average_trajectories_frames,
    render_videos,
    single_state,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator


def _add_features(data: Dict[str, Any], trajs_avg: torch.Tensor, with_global: bool) -> Dict[str, Any]:
    """Put the per-frame tokens of ``trajs_avg`` into ``data``, and with
    ``with_global`` the 25 global features and the packed hybrid tensor.
    Every feature is a deterministic function of the trajectories, so the
    global ones (~0.1 s a cycle of host-bound launches on the card) are
    computed only when an arm reads them."""
    pf = compute_per_frame_features(trajs_avg)
    data["pf_features"] = pf
    if with_global:
        gf = compute_features_for_multiple_trajectories(trajs_avg, dt=1.0)
        data["g_features"] = gf
        data["hybrid_features"] = torch.cat([pf.reshape(pf.shape[0], -1), gf], dim=-1)
    return data


def make_dataset(generator: torch.Generator, trajs, train_cfg: TrainConfig, optics,
                 with_global: bool = True) -> Dict[str, Any]:
    """Normalised videos and the per-frame tokens ``(N, F, 6)`` of one batch
    of trajectories, on the generator's device; with ``with_global`` also
    the 25 global features ``(N, 25)`` and the packed hybrid tensor ``(N,
    F·6 + 25)`` (per-frame flattened, global appended) that
    ``HybridFusionTransformer`` unpacks."""
    videos = render_videos(generator, trajs, train_cfg, optics)
    return _add_features({"videos": videos}, average_trajectories_frames(trajs, train_cfg.n_pos_per_frame),
                         with_global)


def build(
    seed: int = 0,
    sequences_per_d: int = 64,
    val_length: int = 30,
    val_d_values=(1.0, 3.0, 5.0, 7.0),
    num_cycles: int = 10,
    with_in_order: bool = False,
    in_order_suite: str = "imft",
    with_hybrid: bool = False,
    device=None,
) -> Experiment:
    """The modular ``Experiment`` on ``device`` (CUDA unless told otherwise;
    raises without a card). Training classes D = 1, 3, 5, 7, and 9 as well
    when ``with_in_order`` scores the ``"imft"`` suite (the published
    100-value D = 0.1..10.0 protocol, whose top the extra class covers);
    ``"committed"`` scores the 70-value ``valTrajsInOrder`` set on the four
    classes."""
    dev = resolve_device(device)
    training_ds = ((1, 1), (3, 1), (5, 1), (7, 1))
    if with_in_order and in_order_suite == "imft":
        training_ds = training_ds + ((9, 1),)
    train_cfg = TrainConfig(seed=seed, sequences_per_d=sequences_per_d, training_ds=training_ds,
                            n_frames=val_length, num_cycles=num_cycles)
    model_cfg = ModelConfig(use_pos_encoding=False)
    optics = BASELINE_OPTICS
    dataset = functools.partial(make_dataset, with_global=with_hybrid)

    def im_slice(data):
        return data["videos"], None, data["labels"]

    def pf_slice(data):
        return data["videos"], data["pf_features"], data["labels"]

    def modular(mode, fusion):
        return ModularTransformer(model_cfg, mode=mode, image_embedding="deep_resnet",
                                  features_dim=N_PER_FRAME_FEATURES, feature_embedding_type="mlp",
                                  fusion_method=fusion)

    arms = {
        "mod_images": ModelEntry(model=modular("images_only", "add"), slice_fn=im_slice),
        "mod_features": ModelEntry(model=modular("features_only", "add"), slice_fn=pf_slice, with_features=True),
        "mod_both_add": ModelEntry(model=modular("both", "add"), slice_fn=pf_slice, with_features=True),
        "mod_both_concat": ModelEntry(model=modular("both", "concat_proj"), slice_fn=pf_slice, with_features=True),
        "mod_both_concat_feat": ModelEntry(model=modular("both", "concat_features"), slice_fn=pf_slice,
                                           with_features=True),
    }
    if with_hybrid:
        def g_slice(data):
            return data["videos"], data["g_features"], data["labels"]

        def hybrid_slice(data):
            return data["videos"], data["hybrid_features"], data["labels"]

        arms["glob_early_tr"] = ModelEntry(
            model=GeneralTransformer(model_cfg, embedding="deep_resnet", use_global_features=True,
                                     fusion_type="early", global_feature_dim=N_FEATURES),
            slice_fn=g_slice, with_features=True,
        )
        for fusion in ("concat_proj", "add"):
            arms[f"hybrid_{fusion.split('_')[0]}"] = ModelEntry(
                model=HybridFusionTransformer(model_cfg, image_embedding="deep_resnet",
                                              per_frame_dim=N_PER_FRAME_FEATURES, global_dim=N_FEATURES,
                                              fusion_method=fusion),
                slice_fn=hybrid_slice, with_features=True,
            )

    p = train_cfg.n_pos_per_frame
    t = train_cfg.n_frames * p
    d_max = train_cfg.d_max_normalization

    def generate_fn(generator, part=None):
        classes = part_units(part, len(train_cfg.training_ds))
        if not classes:
            return None
        videos, avg, labels = [], [], []
        for i in classes:
            trajs, lab = single_state(fold_in(generator, i, 0), sequences_per_d, t, Ds=tuple(train_cfg.training_ds[i]))
            trajs = trajs / train_cfg.traj_div_factor
            videos.append(render_videos(fold_in(generator, i, 1), trajs, train_cfg, optics))
            avg.append(average_trajectories_frames(trajs, p))
            labels.append(lab[:, :1, 1] / d_max)
        # the features of every class at once (each row is its trajectory's alone)
        data = _add_features({"videos": torch.cat(videos)}, torch.cat(avg), with_hybrid)
        data["labels"] = torch.cat(labels)
        return data

    frozen = load_validation_trajectories(length=val_length, device=dev)
    val_data = {}
    for d in val_d_values:
        name = f"val{d:g}"
        if name in frozen:
            tr = torch.as_tensor(frozen[name], dtype=torch.float32, device=dev) / train_cfg.traj_div_factor
            vdata = dataset(seeded_generator(dev, seed + 99, int(d)), tr, train_cfg, optics)
            vdata["labels"] = None
            val_data[d] = vdata

    in_order = None
    if with_in_order:
        if in_order_suite == "imft":
            arr, d_values = generate_in_order_imft(t_steps=t), IN_ORDER_IMFT_D_VALUES
        elif in_order_suite == "committed":
            arr, d_values = frozen.get("valTrajsInOrder"), IN_ORDER_D_VALUES
        else:
            raise ValueError(f"unknown in_order_suite {in_order_suite!r}; expected 'imft' or 'committed'")
        if arr is not None:
            in_order = build_in_order_data(arr, d_values, seeded_generator(dev, seed + 99), train_cfg, optics,
                                           dataset)

    return Experiment("modular", train_cfg, optics, arms, generate_fn, val_data, in_order, device=dev)
