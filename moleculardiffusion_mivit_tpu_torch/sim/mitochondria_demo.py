"""Constrained-diffusion demo: molecules diffusing along a mitochondrion.

Port of ``examples/mitochondria_demo.py``. Build a bent 3-edge skeleton
(``PiecewiseLinearGeometry.from_edges``), simulate 1-D fBm of molecules
constrained to it, render the constrained trajectories into noisy 9×9
fluorescence videos with the baseline optics (K1 on the card), and recover
D three ways on 50 molecules at D = 4:

- MSD naive: the 2-D free-diffusion estimator, MSD(τ=1)/4 on the
  sub-position trajectories (reads ~D/2 along a 1-D path);
- MSD confined: the geometry-aware 1-D factor, MSD(τ=1)/2;
- MiViT: a full-width ``GeneralTransformer(embedding="deep_resnet")`` (the
  default ``ModelConfig``; K2/K3 on the card) trained on the fly through
  ``train.loop.make_train_impls`` on constrained sequences, 16 molecules for
  each of D = 1, 3, 5, 7 a cycle, with the default ``TrainConfig``'s
  schedule (batch 1 for the first 20 cycles).

Run: python -m moleculardiffusion_mivit_tpu_torch.sim.mitochondria_demo
     [--cycles 15] [--seed S] [--out DIR] [--device cuda|cpu] [figure.png]

It writes ``DIR/mitochondria_report.json``: the three estimates, the
per-molecule sd of the MiViT estimates, and each cycle's training loss and
seconds. The four-panel figure is written only when a PNG path is given; it
needs matplotlib, and without it the demo raises before it trains. Without
``--device`` it runs on the card and raises on a machine without one.

Streams from ``--seed``: the evaluation videos ``(seed, 0)`` (each D class
``fold_in(·, i)``: trajectories, then its render), cycle ``c``'s training
data ``(seed, 1, c)`` and epoch order ``(seed, 2, c)``, the initial weights
``(seed, 4)`` on the CPU, the evaluation trajectories of the MSD estimators
``(seed, 3)``.

The outcome rule, written before the card runs. Run the demo with
``--cycles 15 --seed S`` for S = 0…3 on the H100 and score the seeds with
``python3 mitochondria_outcome.py``:

- MSD columns (no training): JAX's evaluation draw of the example
  (``geo.simulate`` alone, on the CPU) over N ≥ 16 keys gives J. Each port
  seed must lie in [min J, max J], and |mean P − mean J| ≤ 2·sd(J)·sqrt(1/4 +
  1/N).
- MiViT column: one JAX CPU seed of the example (15 cycles × 64 steps) is
  timed first. If it takes ≤ 15 min, at least two JAX seeds run and the
  port's four-seed mean must lie within 2 pooled standard errors
  (sqrt(sd_P²/4 + sd_J²/n_J)) of JAX's mean; otherwise the column is
  reported beside the record (4.70 ± 1.07) and not held.

A miss is logged as F7 in ROADMAP.md section 3; it is not tuned away.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
from moleculardiffusion_mivit_tpu_torch.sim import (
    Edge,
    PiecewiseLinearGeometry,
    normalize_images,
    trajectories_to_video,
)
from moleculardiffusion_mivit_tpu_torch.train.loop import make_train_impls
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

D_TRAIN = (1.0, 3.0, 5.0, 7.0)
D_EVAL = 4.0
N_TRAIN_PER_D = 16
N_EVAL = 50
MODEL_CONFIG = ModelConfig()


def build_skeleton() -> PiecewiseLinearGeometry:
    """A bent 3-edge mitochondrion skeleton, ~200 trajectory units long
    (units of 100 nm)."""
    return PiecewiseLinearGeometry.from_edges(
        [
            Edge((0.0, 0.0), (80.0, 10.0)),
            Edge((80.0, 10.0), (130.0, 60.0)),
            Edge((130.0, 60.0), (210.0, 70.0)),
        ]
    )


def constrained_batch(generator: torch.Generator, geo: PiecewiseLinearGeometry, n: int, n_frames: int,
                      n_pos: int, d_values):
    """``n`` constrained sequences for each D in ``d_values``, on the
    generator's device: fBm along ``geo`` from its midpoint (D in trajectory
    units² a step), positions divided by 100 as the training pipeline does,
    rendered with per-frame centering (one ``trajectories_to_video`` call, so
    one K1 launch, a class) and normalised against the baseline optics.
    Returns ``(videos (n·len(d_values), n_frames, 9, 9), labels_D (·, 1))``."""
    bg_mean, bg_sigma = BASELINE_OPTICS.background_intensity
    theo_max = BASELINE_OPTICS.particle_intensity[0] + bg_mean
    videos, labels = [], []
    for i, d in enumerate(d_values):
        g = fold_in(generator, i)
        trajs = geo.simulate(g, n, n_frames * n_pos, D=float(d), initial_distance=geo.total_length / 2.0)
        v = trajectories_to_video(g, trajs / 100.0, n_pos, True, BASELINE_OPTICS)
        videos.append(normalize_images(v, bg_mean, bg_sigma, theo_max)[0])
        labels.append(torch.full((n, 1), float(d), dtype=torch.float32, device=v.device))
    return torch.cat(videos), torch.cat(labels)


def msd_estimates(trajs: torch.Tensor) -> tuple:
    """``(naive, confined)``: MSD(τ=1) of the sub-position trajectories over
    4 (free 2-D) and over 2 (1-D along the path)."""
    msd1 = float((torch.diff(trajs, dim=1) ** 2).sum(-1).mean())
    return msd1 / 4.0, msd1 / 2.0


def _figure(path, geo, eval_trajs, eval_videos, naive, confined, d_mivit, sd_mivit):
    from moleculardiffusion_mivit_tpu_torch.evaluation.plots import require_matplotlib

    plt = require_matplotlib()
    trajs = eval_trajs.cpu().numpy()
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    ax = axes[0, 0]
    geo.draw(ax=ax, show_vertices=True)
    ax.scatter(trajs[0, :, 0], trajs[0, :, 1], c=np.arange(trajs.shape[1]), cmap="autumn", s=6, zorder=5)
    ax.set_title("skeleton + one constrained trajectory")
    ax = axes[0, 1]
    frames = eval_videos[0, :6].cpu().numpy().reshape(2, 3, 9, 9)
    ax.imshow(frames.transpose(0, 2, 1, 3).reshape(18, 27), cmap="gray")
    ax.set_title("first 6 rendered frames (molecule 0)")
    ax.axis("off")
    ax = axes[1, 0]
    lags = np.arange(1, 31)
    msd = [float(((trajs[:, lag:] - trajs[:, :-lag]) ** 2).sum(-1).mean()) for lag in lags]
    ax.plot(lags, msd, "o-", ms=3, label="constrained MSD")
    ax.plot(lags, 2 * D_EVAL * lags, "--", label="2·D·t (1-D)")
    ax.plot(lags, 4 * D_EVAL * lags, ":", label="4·D·t (free 2-D)")
    ax.set_xlabel("lag (steps)")
    ax.set_ylabel("MSD (traj-units²)")
    ax.legend()
    ax.set_title("confinement bends the MSD")
    ax = axes[1, 1]
    ax.bar(["MSD naive", "MSD confined", "MiViT"], [naive, confined, d_mivit], yerr=[0, 0, sd_mivit],
           color=["#999", "#667", "#3a6"])
    ax.axhline(D_EVAL, color="k", ls="--", label=f"true D = {D_EVAL}")
    ax.set_ylabel("estimated D")
    ax.legend()
    ax.set_title("D recovery on confined molecules")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> dict:
    """Run the demo; returns its report (also written as JSON)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="results/torch_mitochondria_demo")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    ap.add_argument("figure", nargs="?", default=None, help="write the four-panel figure to this PNG")
    args = ap.parse_args(argv)
    if args.figure:
        from moleculardiffusion_mivit_tpu_torch.evaluation.plots import require_matplotlib

        require_matplotlib()  # raise now, not after training
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    geo = build_skeleton()
    cfg = TrainConfig(num_cycles=args.cycles)
    n_frames, n_pos = cfg.n_frames, cfg.n_pos_per_frame

    eval_videos, _ = constrained_batch(seeded_generator(dev, args.seed, 0), geo, N_EVAL, n_frames, n_pos, [D_EVAL])
    eval_trajs = geo.simulate(seeded_generator(dev, args.seed, 3), N_EVAL, n_frames * n_pos, D=D_EVAL,
                              initial_distance=geo.total_length / 2.0)
    naive, confined = msd_estimates(eval_trajs)

    impls = make_train_impls(GeneralTransformer(MODEL_CONFIG, embedding="deep_resnet"), cfg, dev)
    state = impls.init_state(seeded_generator("cpu", args.seed, 4))
    losses, seconds = [], []
    for c in range(args.cycles):
        t0 = time.perf_counter()
        videos, labels = constrained_batch(seeded_generator(dev, args.seed, 1, c), geo, N_TRAIN_PER_D, n_frames,
                                           n_pos, D_TRAIN)
        loss = impls.train_cycle(state, videos, labels / cfg.d_max_normalization,
                                 seeded_generator(dev, args.seed, 2, c), cfg.lr_for_cycle(c),
                                 cfg.batch_size_for_cycle(c))
        losses.append(float(loss))
        sync()
        seconds.append(time.perf_counter() - t0)
        print(f"cycle {c}: train loss {losses[-1]:.4f} ({seconds[-1]:.2f} s)", flush=True)
    preds = impls.evaluate(state, eval_videos)[:, 0].cpu().numpy()
    d_mivit, sd_mivit = float(preds.mean()), float(preds.std())

    print(f"true D = {D_EVAL}")
    print(f"MSD naive (2D factor 4):     {naive:.3f}")
    print(f"MSD confined (1D factor 2):  {confined:.3f}")
    print(f"MiViT (trained constrained): {d_mivit:.3f} ± {sd_mivit:.3f}")
    report = {"seed": args.seed, "cycles": args.cycles, "d_true": D_EVAL, "msd_naive": naive,
              "msd_confined": confined, "mivit": d_mivit, "mivit_sd": sd_mivit, "mivit_per_molecule": preds.tolist(),
              "train_loss": losses, "s_per_cycle": seconds,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "mitochondria_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    if args.figure:
        _figure(args.figure, geo, eval_trajs, eval_videos, naive, confined, d_mivit, sd_mivit)
        print(f"wrote {args.figure}")
    return report


if __name__ == "__main__":
    main()
