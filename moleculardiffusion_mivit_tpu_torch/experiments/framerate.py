"""Framerate / exposure-time experiment.

Port of ``moleculardiffusion_mivit_tpu/experiments/framerate.py``. One
(transformer, ResNet) pair per exposure setting, ``RATES`` = 5 … 50
sub-positions a frame (50 … 500 ms): the same 300-step trajectories are
rendered at each rate on 13×13 frames (``FRAMERATE_OPTICS``) with the photon
flux scaled with the exposure (``part_mean · rate / 10``), normalised per
rate against its own ``bg_mean + flux``, and zero-padded to ``T // 5 = 60``
frames: ``(N, len(RATES), 60, 13, 13)``. Arms ``tr_i`` (deep-ResNet
``GeneralTransformer``, no positional encoding) and ``res_i``
(``MultiImageResNet``) read the first ``T // rate_i`` frames of slice ``i``.

``in_order_rescore`` scores trained arms on the published in-order suite
rendered at every rate, the poster's way (the port's copy of the JAX
package's ``examples/framerate_inorder_rescore.py``); run it on a
checkpoint with ``python -m
moleculardiffusion_mivit_tpu_torch.experiments.framerate --ckpt
<out>/final``.

Random streams (``utils.rng``):

- ``render_framerate_stack(g, ...)``: rate ``i`` renders from
  ``fold_in(g, i)``;
- cycle data: ``generate_fn(g, part=None)``, with ``g`` the experiment's
  per-cycle stream; class ``i`` simulates from ``fold_in(g, i, 0)`` and
  renders from ``fold_in(g, i, 1)``; with ``continuous_d``, D from
  ``fold_in(g, 0)`` and the walks from ``fold_in(g, 1)`` for every row,
  and block ``b`` (the rows of class ``b``'s count) renders from
  ``fold_in(g, 2, b)``; with a mesh's ``part``, its classes or blocks
  alone;
- validation at D: the render from ``(seed + 99, int(D))``;
- the in-order rescore: chunk ``start`` renders from ``fold_in((123),
  start)``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import FRAMERATE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import (
    IN_ORDER_IMFT_D_VALUES,
    error_table,
    generate_in_order_imft,
    load_validation_trajectories,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, ModelEntry, class_sequence_counts
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import part_units
from moleculardiffusion_mivit_tpu_torch.sim import brownian_motion, normalize_images, single_state, trajectories_to_video
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

RATES: Tuple[int, ...] = (5, 10, 15, 20, 30, 50)
ORIGINAL_N_POS = 10
# exposure in ms per rate (50 ms per 5 sub-positions)
EXPOSURE_MS = {5: 50, 10: 100, 15: 150, 20: 200, 30: 300, 50: 500}
# the published exposure table (outPoster/exposure_time_errors.csv):
# ("t" transformer | "r" ResNet, exposure ms) -> in-order MSE
PUBLISHED = {
    ("t", 50): 1.24, ("r", 50): 1.32,
    ("t", 100): 0.76, ("r", 100): 0.82,
    ("t", 150): 0.632, ("r", 150): 0.678,
    ("t", 200): 0.653, ("r", 200): 0.733,
    ("t", 300): 0.722, ("r", 300): 0.833,
    ("t", 500): 0.885, ("r", 500): 1.039,
}
RESCORE_CSV = "inorder_imft_rescore.csv"


def render_framerate_stack(
    generator: torch.Generator,
    trajectories: torch.Tensor,
    optics,
    rates: Tuple[int, ...] = RATES,
    center: bool = True,
) -> torch.Tensor:
    """``(N, T, 2)`` trajectories (already divided by ``traj_div_factor``)
    → ``(N, len(rates), T // rates[0], S, S)`` normalised videos, each
    rate's frames zero-padded at the end. ``generator`` lies on the
    trajectories' device."""
    n, t, _ = trajectories.shape
    max_frames = t // rates[0]
    s = optics.output_size
    part_mean, part_std = optics.particle_intensity
    bg_mean, bg_sigma = optics.background_intensity
    out = torch.zeros((n, len(rates), max_frames, s, s), dtype=torch.float32, device=trajectories.device)
    for i, rate in enumerate(rates):
        if t % rate != 0:
            raise ValueError(f"T={t} not divisible by rate {rate}")
        flux = part_mean * (rate / ORIGINAL_N_POS)
        optics_rate = optics.replace(particle_intensity=(flux, part_std))
        vids = trajectories_to_video(fold_in(generator, i), trajectories, rate, center, optics_rate)
        out[:, i, : t // rate] = normalize_images(vids, bg_mean, bg_sigma, bg_mean + flux)[0]
    return out


def build(
    seed: int = 0,
    rates: Tuple[int, ...] = RATES,
    sequences_per_d: int = 64,
    val_length: int = 30,
    val_d_values=(1.0, 3.0, 5.0, 7.0, 9.0),
    continuous_d: Optional[Tuple[float, float]] = None,
    device=None,
) -> Experiment:
    """The framerate ``Experiment`` on ``device`` (CUDA unless told
    otherwise; raises without a card). Training classes D = 1, 3, 5, 7, 9
    and the half-count 10.2 tail, which covers the top of the in-order
    sweep. ``continuous_d=(lo, hi)`` replaces them by a per-sequence D ~
    Uniform(lo, hi) at the same per-cycle budget (5.5 × ``sequences_per_d``)."""
    dev = resolve_device(device)
    train_cfg = TrainConfig(
        seed=seed,
        sequences_per_d=sequences_per_d,
        training_ds=((1, 1), (3, 1), (5, 1), (7, 1), (9, 1), (10.2, 1)),
        n_frames=val_length,
        n_pos_per_frame=ORIGINAL_N_POS,
    )
    model_cfg = ModelConfig(patch_size=13, use_pos_encoding=False)
    optics = FRAMERATE_OPTICS
    t = train_cfg.n_frames * ORIGINAL_N_POS
    d_max = train_cfg.d_max_normalization

    def make_slice(i, rate):
        frames = t // rate

        def slice_fn(data):
            return data["videos"][:, i, :frames], None, data["labels"]

        return slice_fn

    arms = {}
    for i, rate in enumerate(rates):
        arms[f"tr_{i}"] = ModelEntry(model=GeneralTransformer(model_cfg, embedding="deep_resnet"),
                                     slice_fn=make_slice(i, rate))
        arms[f"res_{i}"] = ModelEntry(model=MultiImageResNet(), slice_fn=make_slice(i, rate))

    counts = class_sequence_counts(train_cfg.training_ds, sequences_per_d)
    if continuous_d is not None:
        d_lo, d_hi = continuous_d
        n_total = sum(counts)
        starts = np.cumsum((0,) + counts)  # block b: the rows of class b's count

        def generate_fn(generator, part=None):
            blocks = part_units(part, len(counts))
            if not blocks:
                return None
            gd = fold_in(generator, 0)
            d = d_lo + (d_hi - d_lo) * torch.rand(n_total, generator=gd, device=gd.device)
            trajs = brownian_motion(fold_in(generator, 1), n_total, train_cfg.n_frames, ORIGINAL_N_POS, d,
                                    float(ORIGINAL_N_POS)) / train_cfg.traj_div_factor
            videos = [render_framerate_stack(fold_in(generator, 2, b), trajs[starts[b]:starts[b + 1]], optics, rates)
                      for b in blocks]
            return {"videos": torch.cat(videos), "labels": (d / d_max)[starts[blocks.start]:starts[blocks.stop], None]}

    else:

        def generate_fn(generator, part=None):
            classes = part_units(part, len(counts))
            if not classes:
                return None
            videos, labels = [], []
            for i in classes:
                trajs, lab = single_state(fold_in(generator, i, 0), counts[i], t, Ds=tuple(train_cfg.training_ds[i]))
                videos.append(render_framerate_stack(fold_in(generator, i, 1), trajs / train_cfg.traj_div_factor,
                                                     optics, rates))
                labels.append(lab[:, :1, 1] / d_max)
            return {"videos": torch.cat(videos), "labels": torch.cat(labels)}

    frozen = load_validation_trajectories(length=val_length, device=dev)
    val_data = {}
    for d in val_d_values:
        name = f"val{d:g}"
        if name in frozen:
            tr = torch.as_tensor(frozen[name], dtype=torch.float32, device=dev) / train_cfg.traj_div_factor
            val_data[d] = {"videos": render_framerate_stack(seeded_generator(dev, seed + 99, int(d)), tr, optics,
                                                            rates),
                           "labels": None}

    return Experiment("framerate", train_cfg, optics, arms, generate_fn, val_data, device=dev)


def in_order_rescore(
    exp: Experiment,
    rates: Tuple[int, ...] = RATES,
    chunk: int = 100,
    out_csv: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Score every ``tr_i`` / ``res_i`` arm of a trained framerate
    experiment (built with ``rates``) on the published in-order suite
    (``evaluation.generate_in_order_imft``: 100 D values × 10 particles ×
    300 steps), rendered at each rate ``chunk`` sequences at a time: the
    poster's ``error_table`` over all 100 D values and over D ≤ 7.0 (the
    reference's committed 70-value range). With ``out_csv`` writes the
    JAX example's CSV (``model,exposure_ms,mse,std,mse_d_le_7,published_mse``,
    ``tr_0, res_0, tr_1, …``). Returns ``{arm: {"mse", "std", "mae",
    "mse_d_le_7"}}``."""
    trajs = generate_in_order_imft()
    n_d, n_p, t, _ = trajs.shape
    flat = torch.as_tensor(trajs.reshape(n_d * n_p, t, 2), dtype=torch.float32, device=exp.device)
    flat = flat / exp.train_cfg.traj_div_factor
    key = seeded_generator(exp.device, 123)
    names = [f"{prefix}_{i}" for i in range(len(rates)) for prefix in ("tr", "res")]
    preds = {name: [] for name in names}
    for start in range(0, flat.shape[0], chunk):
        vids = render_framerate_stack(fold_in(key, start), flat[start:start + chunk], exp.optics, rates)
        data = {"videos": vids, "labels": None}
        for name in names:
            preds[name].append(exp.predict(name, data).reshape(-1).cpu().numpy())
    d_values = IN_ORDER_IMFT_D_VALUES[:n_d]
    n70 = int(np.sum(d_values <= 7.0 + 1e-9))
    rows = {}
    for name in names:
        p = np.concatenate(preds[name]).reshape(n_d, n_p)
        rows[name] = dict(error_table(p, d_values), mse_d_le_7=error_table(p[:n70], d_values[:n70])["mse"])
    if out_csv:
        with open(out_csv, "w") as f:
            f.write("model,exposure_ms,mse,std,mse_d_le_7,published_mse\n")
            for i, rate in enumerate(rates):
                for kind, prefix in (("t", "tr"), ("r", "res")):
                    r = rows[f"{prefix}_{i}"]
                    f.write(f"{prefix}_{i},{EXPOSURE_MS[rate]},{r['mse']:.6g},{r['std']:.6g},"
                            f"{r['mse_d_le_7']:.6g},{PUBLISHED[(kind, EXPOSURE_MS[rate])]}\n")
    return rows


def main(argv=None) -> Dict[str, Dict[str, float]]:
    """Restore a trained framerate run (``run_experiment framerate``'s
    ``<out>/final``) and write its in-order rescore next to it,
    ``<out>/inorder_imft_rescore.csv`` unless ``--out-csv`` says otherwise."""
    ap = argparse.ArgumentParser(description="in-order rescore of a trained framerate run")
    ap.add_argument("--ckpt", default="results/framerate/final")
    ap.add_argument("--chunk", type=int, default=100, help="sequences per render/eval call")
    ap.add_argument("--out-csv", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from moleculardiffusion_mivit_tpu_torch.utils.checkpoint import restore_experiment

    exp = build(device=args.device)
    restore_experiment(exp, args.ckpt)
    out_csv = args.out_csv or os.path.join(os.path.dirname(os.path.abspath(args.ckpt)), RESCORE_CSV)
    rows = in_order_rescore(exp, rates=RATES, chunk=args.chunk, out_csv=out_csv)
    for name, r in rows.items():
        print(f"{name:<6} mse {r['mse']:.4f} std {r['std']:.4f} mse_d<=7 {r['mse_d_le_7']:.4f}")
    print(f"wrote {out_csv}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
