"""Embeddings size-sweep experiment.

Port of ``moleculardiffusion_mivit_tpu/experiments/embeddings.py``: the
three embeddings (linear, cnn, deep_resnet) of ``GeneralTransformer`` at
three sizes, normal (embed 64, 4 heads, FFN 128, 6 layers), small (each
halved: 32/2/64/3) and big (each doubled: 128/8/256/12), plus
``MultiImageResNet``: 10 arms, positional encoding on, baseline optics, D
classes 1, 3, 5, 7. ``param_counts`` gives each arm's learnable parameter
count, as the reference prints them.

Random streams (``utils.rng``), in the layout of ``baseline``: the cycle's
data from ``fold_in(g, 0)`` (``train.loop.generate_cycle_data``, class by
class; with a mesh's ``part``, that part's classes), with ``g`` the
experiment's per-cycle stream; the validation videos as
``evaluation.render_validation_videos`` renders them.
"""

from __future__ import annotations

from typing import Dict

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import load_validation_trajectories, render_validation_videos
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, ModelEntry
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet, param_count
from moleculardiffusion_mivit_tpu_torch.train.loop import generate_cycle_data
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in

SIZE_VARIANTS = {"_n": 1, "_s": 0.5, "_b": 2}
EMBEDDINGS = {"linear_2layer": "linear", "cnn_2layer": "cnn", "deepcnn_2layer": "deep_resnet"}


def build(
    seed: int = 0,
    sequences_per_d: int = 64,
    val_length: int = 30,
    val_d_values=(1.0, 3.0, 5.0, 7.0),
    device=None,
) -> Experiment:
    """The embeddings ``Experiment`` on ``device`` (CUDA unless told
    otherwise; raises without a card)."""
    dev = resolve_device(device)
    train_cfg = TrainConfig(
        seed=seed,
        sequences_per_d=sequences_per_d,
        training_ds=((1, 1), (3, 1), (5, 1), (7, 1)),
        n_frames=val_length,
    )
    base = ModelConfig(use_pos_encoding=True)
    optics = BASELINE_OPTICS

    def identity_slice(data):
        return data["videos"], None, data["labels"]

    arms = {}
    for suffix, scale in SIZE_VARIANTS.items():
        cfg = base.replace(
            embed_dim=int(base.embed_dim * scale),
            num_heads=max(int(base.num_heads * scale), 1),
            hidden_dim=int(base.hidden_dim * scale),
            num_layers=max(int(base.num_layers * scale), 1),
        )
        for key_name, emb in EMBEDDINGS.items():
            arms[key_name + suffix] = ModelEntry(model=GeneralTransformer(cfg, embedding=emb), slice_fn=identity_slice)
    arms["resnet"] = ModelEntry(model=MultiImageResNet(), slice_fn=identity_slice)

    def generate_fn(generator, part=None):
        out = generate_cycle_data(fold_in(generator, 0), train_cfg, optics, part=part)
        return None if out is None else {"videos": out[0], "labels": out[1]}

    # only the classes validated on are rendered (the experiment has no in-order sweep)
    trajs = load_validation_trajectories(length=val_length, device=dev)
    wanted = {f"val{d:g}": trajs[f"val{d:g}"] for d in val_d_values if f"val{d:g}" in trajs}
    rendered = render_validation_videos(wanted, train_cfg, optics, device=dev)
    val_data = {d: {"videos": rendered[f"val{d:g}"], "labels": None} for d in val_d_values if f"val{d:g}" in rendered}
    return Experiment("embeddings", train_cfg, optics, arms, generate_fn, val_data, device=dev)


def param_counts(exp: Experiment) -> Dict[str, int]:
    """Per-arm learnable parameter counts (the reference prints these)."""
    if not exp._built:
        exp.build()
    return {name: param_count(exp.states[name].model) for name in exp.states}
