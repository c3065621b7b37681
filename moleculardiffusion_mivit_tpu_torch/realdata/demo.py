"""The real-data pipeline end to end on a synthetic wide-field movie.

Port of ``examples/realdata_demo.py``: render a movie of 6 particles
diffusing at D = 0.3 px²/frame with exposure blur (10 sub-positions a
frame) into a 63-px field, write it as a TIFF and read it back, then detect
(DoG) → track (Hungarian) → patches → sub-pixel localisation, and estimate
each track's D two ways:

- the MSD(τ=1) baseline on the refined localisations;
- a patch model (``GeneralTransformer`` with the deep-ResNet embedding and a
  learned positional embedding, full width) trained on patch-following
  sequences rendered by the same wide-field renderer, with the detection's
  rounding as ±0.5 px jitter and D ~ U(0.02, 1.0) per sequence.

The trajectories are the JAX example's numpy draw (``default_rng(0)``);
the render noise and the training data come from ``--seed``.

Run: python -m moleculardiffusion_mivit_tpu_torch.realdata.demo
     [--train-cycles 50] [--tif movie.tif] [--out results/torch_realdata_demo]
     [--seed 0] [--device cuda|cpu]

It writes ``<out>/realdata_metrics.json`` with the JAX example's keys and
``<out>/realdata_report.json`` with the unrounded per-track estimates, the
true particles each track follows, each cycle's training loss and seconds,
and each stage's seconds.
Without ``--device`` it runs on the card and raises on a machine without
one.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig, OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
from moleculardiffusion_mivit_tpu_torch.realdata import (
    analyze_microscopy_sequence,
    estimate_d_for_tracks,
    extract_particle_patches,
    read_tiff_stack,
    refine_localizations,
    track_particles,
    write_tiff_stack,
)
from moleculardiffusion_mivit_tpu_torch.realdata.stats import track_columns
from moleculardiffusion_mivit_tpu_torch.sim import (
    brownian_motion,
    normalize_images,
    render_widefield,
    render_widefield_panel,
)
from moleculardiffusion_mivit_tpu_torch.train.loop import make_train_impls
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

D_TRUE = 0.3  # px²/frame
N_POS = 10  # sub-positions a frame (the exposure blur carries the D signal)
PATCH = 9
FIELD = 63
BG_MEAN, BG_SIGMA, THEO_MAX = 1000.0, 100.0, 5000.0

OPTICS = OpticsConfig(
    particle_intensity=(4000.0, 200.0),
    psf_division_factor=1.3,
    output_size=PATCH,
    background_intensity=(BG_MEAN, BG_SIGMA),
    poisson_noise=100.0,
    trajectory_unit=-1,  # positions already in px
)
MODEL_CONFIG = ModelConfig(patch_size=PATCH, use_pos_encoding=True)
SEQS_PER_CYCLE, BATCH = 256, 16
# (min_distance, max_linking_distance, min_track_length) of the analysis
TRACKING = dict(min_distance=5, max_linking_distance=8.0, min_track_length=10)


def movie_trajectories(n_particles: int = 6, n_frames: int = 25, field: int = FIELD) -> np.ndarray:
    """The JAX example's trajectories ``(n_particles, n_frames·N_POS, 2)``
    in pixels: uniform starts 14 px inside the field, Brownian sub-steps."""
    rng = np.random.default_rng(0)
    starts = rng.uniform(14, field - 14, size=(n_particles, 1, 2))
    steps = rng.normal(0, np.sqrt(2 * D_TRUE / N_POS), size=(n_particles, n_frames * N_POS, 2))
    steps[:, 0] = 0
    return starts + np.cumsum(steps, axis=1)


def make_movie(path: str, generator: torch.Generator) -> np.ndarray:
    """Render the movie on the generator's device (one K1 launch) and write
    it to ``path`` as a 32-bit float TIFF. Returns it ``(F, S, S)``."""
    trajs = torch.tensor(movie_trajectories(), dtype=torch.float32, device=generator.device)
    movie = render_widefield(generator, trajs, N_POS, FIELD, OPTICS).cpu().numpy()
    write_tiff_stack(path, movie)
    return movie


def track_identities(tracks, refined) -> dict:
    """For each track of the demo's movie, the true particles nearest its
    refined positions frame by frame (their exposure means): one particle
    for a clean track, two or more where the tracker swapped identities."""
    truth = movie_trajectories()
    truth = truth.reshape(len(truth), -1, N_POS, 2).mean(axis=2)  # (K, F, 2) as (x, y)
    out = {}
    for tid, positions in tracks.items():
        frames = [int(f) for f, _, _ in positions]
        xy = np.array([[refined[(tid, f)]["x_refined"], refined[(tid, f)]["y_refined"]] for f in frames])
        nearest = np.linalg.norm(truth[:, frames] - xy[None], axis=-1).argmin(axis=0)
        out[tid] = sorted({int(i) for i in nearest})
    return out


def patch_sequences(generator: torch.Generator, n: int, n_frames: int,
                    optics_panel: Tuple[OpticsConfig, ...] = (OPTICS,)):
    """One cycle's training data on the generator's device: D ~ U(0.02,
    1.0) per sequence, Brownian sub-positions with the movie's per-step
    variance, each frame re-centred on the patch centre plus U(−0.5, 0.5) px
    (the rounding of detection-centred patches), all sequences rendered in
    one ``render_widefield_panel`` call (one K1 launch on the card) and
    normalised as ``estimate_d_for_tracks`` normalises real patches.

    ``optics_panel`` splits the sequences into equal runs of ``n //
    len(optics_panel)``, run m rendered with member m (the JAX example
    ``sim2real_robustness.py``'s randomized arm); the normalisation always
    uses the nominal camera constants. Returns ``(videos (n', n_frames,
    PATCH, PATCH), labels (n', 1))``, ``n'`` being ``n`` rounded down to a
    multiple of the panel's length."""
    dev = generator.device
    n = (n // len(optics_panel)) * len(optics_panel)
    d = 0.02 + 0.98 * torch.rand((n,), generator=generator, device=dev)
    sub = brownian_motion(generator, n, n_frames, N_POS, d, dt=1.0)
    seg = sub.reshape(n, n_frames, N_POS, 2)
    seg = seg - seg.mean(dim=2, keepdim=True)  # patch-following
    jitter = torch.rand((n, n_frames, 1, 2), generator=generator, device=dev) - 0.5
    pos = (PATCH - 1) / 2.0 + seg + jitter
    videos = render_widefield_panel(generator, pos.reshape(n, 1, n_frames * N_POS, 2), N_POS, PATCH, optics_panel)
    videos, _ = normalize_images(videos, BG_MEAN, BG_SIGMA, THEO_MAX)
    return videos, d[:, None]


class PatchModel(NamedTuple):
    """A trained patch model: ``predict(videos)`` gives eval-mode D;
    ``model`` is the module itself; ``losses`` and ``seconds`` are each
    cycle's mean training loss and wall seconds."""

    predict: Callable
    model: torch.nn.Module
    losses: List[float]
    seconds: List[float]


def patch_train_config(n_frames: int) -> TrainConfig:
    """The patch model's training configuration, as the JAX examples'
    ``train_patch_model``: lr 1e-4 and labels in px²/frame."""
    return TrainConfig(d_max_normalization=1.0, n_frames=n_frames, n_pos_per_frame=N_POS, lr=1e-4)


def train_patch_model(n_frames: int, cycles: int, seed: int, device, seqs_per_cycle: int = SEQS_PER_CYCLE,
                      batch_size: int = BATCH, optics_panel: Tuple[OpticsConfig, ...] = (OPTICS,)) -> PatchModel:
    """Train the patch model (``MODEL_CONFIG``) for ``cycles`` cycles of
    fresh sequences (``patch_sequences`` over ``optics_panel``, one AdamW
    epoch each at lr 1e-4)."""
    dev = resolve_device(device)
    cfg = patch_train_config(n_frames)
    impls = make_train_impls(GeneralTransformer(MODEL_CONFIG, embedding="deep_resnet"), cfg, dev)
    state = impls.init_state(seeded_generator("cpu", seed, 0))
    losses, seconds = [], []
    for c in range(cycles):
        t0 = time.perf_counter()
        videos, labels = patch_sequences(seeded_generator(dev, seed, 1, c), seqs_per_cycle, n_frames, optics_panel)
        loss = impls.train_cycle(state, videos, labels, seeded_generator(dev, seed, 2, c), cfg.lr, batch_size)
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if (c + 1) % 10 == 0:
            print(f"  train cycle {c + 1}/{cycles}: loss {losses[-1]:.4f}", flush=True)
    return PatchModel(lambda videos: impls.evaluate(state, videos), state.model, losses, seconds)


def _print_table(cols, rows: int = 8) -> None:
    names = ("x_refined", "y_refined", "psf_size", "displacement")
    print(f"{'track_id':>8} {'frame':>5} " + " ".join(f"{n:>12}" for n in names))
    for i in range(min(rows, len(cols["frame"]))):
        print(f"{cols['track_id'][i]:>8} {cols['frame'][i]:>5} " + " ".join(f"{cols[n][i]:>12.6f}" for n in names))


def main(argv=None) -> dict:
    """Run the demo; returns its report: the metrics, each cycle's training
    loss and seconds, and each stage's seconds."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-cycles", type=int, default=50)
    ap.add_argument("--tif", type=str, default=None)
    ap.add_argument("--out", type=str, default="results/torch_realdata_demo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    stage = {}

    with tempfile.TemporaryDirectory() as tmp:
        path = args.tif or os.path.join(tmp, "movie.tif")
        t0 = time.perf_counter()
        make_movie(path, seeded_generator(dev, args.seed, 3))
        stage["render"] = time.perf_counter() - t0
        print(f"synthetic movie (6 particles, D={D_TRUE} px²/frame, blur) → {path}")
        stack = read_tiff_stack(path)

    tracks, _, _ = analyze_microscopy_sequence(stack, device=dev, **TRACKING)
    stage["detect"], stage["track"] = track_particles.seconds["detect"], track_particles.seconds["link"]
    if not tracks:
        raise RuntimeError("no track of 10 frames or more in the movie")
    t0 = time.perf_counter()
    patches = extract_particle_patches(stack, tracks, patch_size=PATCH)
    stage["patches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refined = refine_localizations(tracks, patches, patch_size=PATCH, device=dev)
    stage["localize"] = time.perf_counter() - t0
    print("\nper-track statistics (head):")
    _print_table(track_columns(tracks, refined))

    print(f"\ntraining patch model ({args.train_cycles} cycles)…", flush=True)
    predict_fn, _, losses, cycle_s = train_patch_model(
        max(len(p) for p in tracks.values()), args.train_cycles, args.seed, dev, SEQS_PER_CYCLE)

    # MSD(τ=1) of exposure-averaged positions = 4·D·(2/3) (the blur factor of
    # a full-frame exposure), so D = MSD1 × 0.375. The model was trained at
    # the longest track's length; shorter tracks go through it as they are.
    t0 = time.perf_counter()
    results = estimate_d_for_tracks(
        tracks, stack, predict_fn, patch_size=PATCH, background_mean=BG_MEAN, background_sigma=BG_SIGMA,
        theoretical_max=THEO_MAX, msd_calibration=0.375, refined_positions=refined, device=dev)
    sync()
    stage["predict"] = time.perf_counter() - t0
    d_model = np.asarray([r["d_model"] for r in results.values()])
    d_msd = np.asarray([r["d_msd"] for r in results.values()])
    print(f"\nper-track model D: {np.round(d_model, 3)}")
    print(f"per-track MSD   D: {np.round(d_msd, 3)}")
    summary = {
        "d_true": D_TRUE,
        "n_tracks": len(results),
        "train_cycles": args.train_cycles,
        "model_mean": round(float(d_model.mean()), 3),
        "model_mean_abs_err": round(float(np.abs(d_model - D_TRUE).mean()), 3),
        "msd_mean": round(float(d_msd.mean()), 3),
        "msd_mean_abs_err": round(float(np.abs(d_msd - D_TRUE).mean()), 3),
    }
    identities = track_identities(tracks, refined)
    report = {"summary": summary, "seed": args.seed, "d_model": d_model.tolist(), "d_msd": d_msd.tolist(),
              "track_particles": [identities[t] for t in results],
              "train_loss": losses, "s_per_cycle": cycle_s, "stage_s": stage,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "realdata_metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(args.out, "realdata_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(summary, indent=2))
    return report


if __name__ == "__main__":
    main()
