"""Sim-to-real robustness: does training over a panel of optics close the
transfer gap?

Port of ``examples/sim2real_robustness.py``. Two arms of the real-data
demo's patch model (``realdata.demo``: ``GeneralTransformer`` with the
deep-ResNet embedding at full width, patch-following sequences, D ~ U(0.02,
1.0) px²/frame, ±0.5 px detection jitter), trained from one seed:

- **fixed**: every cycle rendered at the nominal optics (``NOMINAL``);
- **randomized**: every cycle's 256 sequences split into 8 runs of 32, run
  m rendered with ``RAND_PANEL[m]`` (PSF scale × intensity × background σ ×
  Poisson level), all 8 in one K1 launch on the card (a sigma per member).
  Normalisation always uses the nominal camera constants.

Both are scored through the full pipeline on movies whose optics the model
never saw (``TEST_OPTICS``, 7 rows): 10 particles at D = 0.3 px²/frame, 25
frames of 10 sub-positions in a 63-px field (the example's numpy
trajectories, ``default_rng(100 + 17·m)``; a row's movies render in one K1
launch from the generator (seed, 3, row)), each written as a TIFF, read
back, then detect → track → patches → refine → ``estimate_d_for_tracks``
(calibration 0.375), beside the MSD(τ=1) baseline.

Run: python -m moleculardiffusion_mivit_tpu_torch.realdata.sim2real
     [--train-cycles 60] [--movies-per-optics 3] [--arms fixed randomized]
     [--seed 0] [--out results/torch_sim2real] [--device cuda|cpu]

``--arms`` trains and scores only the arms named (both by default); the
report then has only their columns.

It writes ``<out>/sim2real.json`` with the example's keys and rounding and
``<out>/sim2real_report.json``, unrounded: each movie's row, tracks and
per-track estimates, each arm's per-cycle loss and seconds, each stage's
seconds, the seed and the card. Without ``--device`` it runs on the card
and raises on a machine without one.

The outcome rule, written before the runs on the card; ``sim2real_outcome.py``
at the repository's root applies it.

- Port runs: ``--train-cycles 60 --seed S --out
  results/torch_sim2real_seedS`` for S = 0…7 on the H100.
- MSD column, held per row: JAX's pipeline on the CPU (the example's
  ``score_movie`` with a constant predictor, no training) over N = 32
  render keys of the row's three movies gives J; the port's 8 seeds give
  P; the statistic is the row's ``msd_mae``. Held when |mean P − mean J| ≤
  3·sqrt(sd_P²/8 + sd_J²/32). Three standard errors, not two: seven rows are
  tested at once, and a 2-SE test a row would miss by chance in about 30 %
  of honest runs. "Every seed inside [min J, max J]" is reported, not held
  (with 8 seeds against 32 keys an honest port lands all 8 inside only
  about 60 % of the time).
- Model columns (``fixed_mae``, ``randomized_mae``), held per row and arm.
  One JAX CPU seed of the example's own trainer (``train_patch_model``,
  ``seed = 42 + k``) is timed first. If a seed takes ≤ 30 min, four JAX
  seeds run, and the rule is |mean P − mean J| ≤ max(0.03,
  3·sqrt(sd_P²/8 + sd_J²/4)). Otherwise the record's one draw
  (``results/sim2real/sim2real.json``, JAX on a TPU) is held inside the
  port's spread: |mean P − record| ≤ max(0.03, 3·sd_P·sqrt(1 + 1/8)).
- Reported, not held: tracks a row (the record has 21-23); each seed's
  rows where the randomized arm beats the fixed one (the record: 4 of 6
  off-nominal rows, the fixed arm ahead at nominal); the range check.
- A miss is logged as F7 in ROADMAP.md section 3, with its run and the
  file:line on both sides. It is not tuned away, and no seed is added or
  swapped.

F7's second witness, a cut protocol on both sides (rule set before its
runs; ``sim2real_outcome.py --cycles 10`` applies it): ``--train-cycles 10
--arms fixed --seed S --out results/torch_sim2real_cut10_seedS``, S = 0…7,
on the H100, against the example's fixed arm at 10 cycles for seeds 42, 43
and 44 under JAX on the CPU, each row scored on the example's movies. On
every row, ``fixed_mae`` is held when |mean P − mean J| ≤ max(0.03,
3·sqrt(sd_P²/8 + sd_J²/3)); each seed's mean D̂ a row (dim and bright
among them) is reported on both sides.

F7's open part, the cut judged on seven JAX seeds (rules set before the
runs of seeds 45-48; ``sim2real_outcome.py --cycles 10`` applies both):
the example's fixed arm at 10 cycles for seeds 42 … 48 under JAX on the
CPU (J, 7 seeds) against the same 8 port seeds (P).

- Mean, held per row: |mean P − mean J| ≤ max(0.03, 3·sqrt(sd_P²/8 +
  sd_J²/7)).
- Spread, held per row: the variance ratio F = sd_P²/sd_J² (7 and 6 degrees
  of freedom) inside the two-sided F test's acceptance band at level
  0.05/7 (Bonferroni over the 7 rows), F_{0.05/14}(7, 6) ≤ F ≤
  F_{1−0.05/14}(7, 6), i.e. 0.0975 ≤ F ≤ 12.24. ``bright_5500`` (port sd
  0.241 against JAX's 0.042 on three seeds) is one of the rows.
- F7 is closed only if both rules hold on every row; a miss opens F8 in
  ROADMAP.md section 3. No seed is added or swapped.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.realdata import (
    analyze_microscopy_sequence,
    demo,
    estimate_d_for_tracks,
    extract_particle_patches,
    read_tiff_stack,
    refine_localizations,
    track_particles,
    write_tiff_stack,
)
from moleculardiffusion_mivit_tpu_torch.sim import render_widefield
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

D_TRUE = 0.3  # px²/frame of every test movie
N_POS, PATCH, FIELD = demo.N_POS, demo.PATCH, demo.FIELD
N_PARTICLES, N_FRAMES = 10, 25
BG_MEAN, BG_SIGMA, THEO_MAX = demo.BG_MEAN, demo.BG_SIGMA, demo.THEO_MAX  # the analyst's constants
NOMINAL = demo.OPTICS
MSD_CALIBRATION = 0.375


def _variant(**kw):
    return NOMINAL.replace(**kw)


# The randomization panel: corners and centre of the optics box (PSF scale
# ±25 %, intensity ±40 %, background σ 0.5-2×, Poisson level 0.5-2×).
RAND_PANEL = (
    NOMINAL,
    _variant(psf_division_factor=1.0, particle_intensity=(2500.0, 200.0)),
    _variant(psf_division_factor=1.0, particle_intensity=(5500.0, 400.0), background_intensity=(BG_MEAN, 200.0)),
    _variant(psf_division_factor=1.6, particle_intensity=(2500.0, 100.0), poisson_noise=50.0),
    _variant(psf_division_factor=1.6, particle_intensity=(5500.0, 200.0)),
    _variant(background_intensity=(BG_MEAN, 50.0), poisson_noise=200.0),
    _variant(psf_division_factor=1.15, particle_intensity=(3200.0, 200.0), background_intensity=(BG_MEAN, 150.0)),
    _variant(psf_division_factor=1.45, particle_intensity=(4800.0, 300.0), poisson_noise=70.0),
)

# Held-out test optics: nominal and mismatches along each axis, two of them
# outside the panel's box (PSF 1.8, intensity 2000).
TEST_OPTICS = {
    "nominal": NOMINAL,
    "psf_sharp_1.0": _variant(psf_division_factor=1.0),
    "psf_wide_1.6": _variant(psf_division_factor=1.6),
    "psf_wider_1.8": _variant(psf_division_factor=1.8),
    "dim_2000": _variant(particle_intensity=(2000.0, 150.0)),
    "bright_5500": _variant(particle_intensity=(5500.0, 300.0)),
    "noisy_bg200_p50": _variant(background_intensity=(BG_MEAN, 200.0), poisson_noise=50.0),
}
ARM_PANELS = {"fixed": (NOMINAL,), "randomized": RAND_PANEL}


class Study(NamedTuple):
    """What ``main`` returns: the unrounded report and the two trained arms
    (``demo.PatchModel`` each)."""

    report: dict
    arms: Dict[str, demo.PatchModel]


def movie_trajectories(movie: int) -> np.ndarray:
    """The example's trajectories of movie ``movie`` ``(10, 250, 2)`` in
    pixels (x, y): ``default_rng(100 + 17·movie)``, starts 14 px inside the
    field, Brownian sub-steps at ``D_TRUE``."""
    rng = np.random.default_rng(100 + 17 * movie)
    starts = rng.uniform(14, FIELD - 14, size=(N_PARTICLES, 1, 2))
    steps = rng.normal(0, np.sqrt(2 * D_TRUE / N_POS), size=(N_PARTICLES, N_FRAMES * N_POS, 2))
    steps[:, 0] = 0
    return starts + np.cumsum(steps, axis=1)


def make_movies(generator: torch.Generator, optics, n_movies: int) -> np.ndarray:
    """Movies 0 … n_movies−1 at ``optics`` ``(n_movies, 25, 63, 63)``,
    rendered on the generator's device in one ``render_widefield`` call
    (one K1 launch on the card)."""
    trajs = np.stack([movie_trajectories(m) for m in range(n_movies)])
    trajs = torch.tensor(trajs, dtype=torch.float32, device=generator.device)
    return render_widefield(generator, trajs, N_POS, FIELD, optics).cpu().numpy()


def score_movie(path: str, predictors: dict, device, stage: Optional[dict] = None) -> Optional[dict]:
    """The example's ``score_movie``, unrounded: read the TIFF, run the full
    pipeline, and return ``{"n_tracks", <arm>: mean |D̂ − D_TRUE|, ...,
    "msd": the MSD baseline's}`` with each arm's and the baseline's
    per-track estimates, or ``None`` when no track of 10 frames is found.
    Adds each stage's seconds to ``stage``."""
    dev = resolve_device(device)
    stage = {} if stage is None else stage

    def add(name, t0):
        stage[name] = stage.get(name, 0.0) + time.perf_counter() - t0

    stack = read_tiff_stack(path)
    tracks, _, _ = analyze_microscopy_sequence(stack, device=dev, **demo.TRACKING)
    stage["detect"] = stage.get("detect", 0.0) + track_particles.seconds["detect"]
    stage["track"] = stage.get("track", 0.0) + track_particles.seconds["link"]
    if not tracks:
        return None
    t0 = time.perf_counter()
    patches = extract_particle_patches(stack, tracks, patch_size=PATCH)
    add("patches", t0)
    t0 = time.perf_counter()
    refined = refine_localizations(tracks, patches, patch_size=PATCH, device=dev)
    add("localize", t0)
    t0 = time.perf_counter()
    results = {arm: estimate_d_for_tracks(
        tracks, stack, predict, patch_size=PATCH, background_mean=BG_MEAN, background_sigma=BG_SIGMA,
        theoretical_max=THEO_MAX, msd_calibration=MSD_CALIBRATION, refined_positions=refined, device=dev)
        for arm, predict in predictors.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    add("predict", t0)
    row = {"n_tracks": len(tracks)}
    for arm, res in results.items():
        d_model = np.asarray([r["d_model"] for r in res.values()])
        row[arm] = float(np.abs(d_model - D_TRUE).mean())
        row[f"d_{arm}"] = d_model.tolist()
        if "msd" not in row:
            d_msd = np.asarray([r["d_msd"] for r in res.values()])
            row["msd"] = float(np.abs(d_msd - D_TRUE).mean())
            row["d_msd"] = d_msd.tolist()
    return row


def summarize(movies: list, arms) -> dict:
    """Each row's aggregate over its movies, as the example's: ``(rounded
    as the example rounds (each movie's MAE to 1e-4, then their mean),
    unrounded)``; a row without a track in any movie is ``None``."""
    rounded, exact = {}, {}
    for name in TEST_OPTICS:
        found = [m for m in movies if m["row"] == name and m["n_tracks"]]
        if not found:
            rounded[name] = exact[name] = None
            continue
        cols = {f"{a}_mae": a for a in (*arms, "msd")}
        rounded[name] = {"n_tracks": int(sum(m["n_tracks"] for m in found)),
                         **{c: round(float(np.mean([round(m[a], 4) for m in found])), 4) for c, a in cols.items()}}
        exact[name] = {"n_tracks": int(sum(m["n_tracks"] for m in found)),
                       **{c: float(np.mean([m[a] for m in found])) for c, a in cols.items()}}
    return {"rounded": rounded, "exact": exact}


def main(argv=None) -> Study:
    """Run the study; returns its unrounded report and the trained arms."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-cycles", type=int, default=60)
    ap.add_argument("--movies-per-optics", type=int, default=3)
    ap.add_argument("--arms", nargs="+", choices=list(ARM_PANELS), default=list(ARM_PANELS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default="results/torch_sim2real")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_start = time.perf_counter()
    stage: Dict[str, float] = {}

    arms = {}
    for arm in args.arms:
        panel = ARM_PANELS[arm]
        print(f"training {arm} arm ({args.train_cycles} cycles, {len(panel)}-member optics panel)…", flush=True)
        t0 = time.perf_counter()
        arms[arm] = demo.train_patch_model(N_FRAMES, args.train_cycles, args.seed, dev, demo.SEQS_PER_CYCLE,
                                           demo.BATCH, optics_panel=panel)
        stage[f"train_{arm}"] = time.perf_counter() - t0
    predictors = {arm: trained.predict for arm, trained in arms.items()}

    movies = []
    with tempfile.TemporaryDirectory() as tmp:
        for r, (name, optics) in enumerate(TEST_OPTICS.items()):
            t0 = time.perf_counter()
            stacks = make_movies(seeded_generator(dev, args.seed, 3, r), optics, args.movies_per_optics)
            stage["render"] = stage.get("render", 0.0) + time.perf_counter() - t0
            for m, stack in enumerate(stacks):
                path = os.path.join(tmp, f"{name}_{m}.tif")
                write_tiff_stack(path, stack)
                row = score_movie(path, predictors, dev, stage)
                movies.append({"row": name, "movie": m, **(row or {"n_tracks": 0})})
    rows = summarize(movies, arms)
    for name, agg in rows["rounded"].items():
        print(name, json.dumps(agg), flush=True)

    metrics = {"d_true": D_TRUE, "train_cycles": args.train_cycles, "movies_per_optics": args.movies_per_optics,
               "rows": rows["rounded"]}
    report = {"seed": args.seed, "d_true": D_TRUE, "train_cycles": args.train_cycles,
              "movies_per_optics": args.movies_per_optics, "rows": rows["exact"], "movies": movies,
              "arms": {arm: {"panel_members": len(ARM_PANELS[arm]), "train_loss": t.losses, "s_per_cycle": t.seconds}
                       for arm, t in arms.items()},
              "stage_s": stage, "seconds": time.perf_counter() - t_start,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev), "card": card_line(dev)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "sim2real.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    with open(os.path.join(args.out, "sim2real_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {args.out}/sim2real.json")
    return Study(report, arms)


if __name__ == "__main__":
    main()
