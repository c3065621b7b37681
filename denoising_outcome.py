#!/usr/bin/env python3
"""The denoising experiment's outcome against the JAX record
``results/denoising_scaled`` (100 cycles × 128 sequences a class, one seed).

Usage: ``python3 denoising_outcome.py RUN_DIR [RUN_DIR ...] [--psfnoise
DIR]``, each ``RUN_DIR`` the ``--out`` of one seed's ``python -m
moleculardiffusion_mivit_tpu_torch.run_experiment denoising --cycles 100
--seqs-per-d 128 --eval-every 5 --seed S`` (it reads ``history.json``;
``results/torch_denoising_seed0`` … ``seed3`` are four such runs).

The statistic of a model in a run is the mean of its last four validation
averages (cycles 84-99 at ``--eval-every 5``). One JSON line per model: the
runs' values, their mean and standard deviation, the record's and the
difference; then one line with the verdict of the rules fixed before the
runs:

1. each model's mean over the runs within ±0.10 of the record;
2. (a) each ``no_noise`` model at least 40 % below every noisy model of its
   kind; (b) ``trans_gauss_filter`` and ``trans_RL_2/5/10`` within 0.05, or
   within 2 standard errors of the difference of the two means, of
   ``trans_poisson_noise``; (c) ``trans`` below ``resnet`` in at least 5 of
   the 6 noisy settings.

Exits 1 when a rule fails.

The record's validation MSEs were scored on the reference's frozen
validation assets, which this repository does not hold; the port scores on
its own seed-2025 draw. ``--psfnoise DIR`` (the ``--out`` of ``run_experiment
psfnoise --cycles 100 --in-order``) measures what that does where both sides
also share a protocol: per kind and noise level, the port's and
``results/psfnoise_reconciled``'s mean last-four validation average beside
their mean in-order MSE on the shared ``imft`` suite (one JSON line each).
"""

from __future__ import annotations

import argparse
import csv
import json
import statistics
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RECORD = ROOT / "results" / "denoising_scaled" / "history.json"
PSFNOISE_RECORD = ROOT / "results" / "psfnoise_reconciled"
NOISE_SETTINGS = (0.0, 1 / 50, 1 / 25, 1 / 20, 1 / 10, 1 / 5)
SETTINGS = ("no_noise", "gaussian_noise", "poisson_noise", "gauss_filter", "RL_2", "RL_5", "RL_10")
LAST = 4  # evaluations: cycles 84, 89, 94, 99


def last_mean(history: dict) -> dict:
    return {name: statistics.fmean(h["val_avg"][-LAST:]) for name, h in history.items()}


def validation_offset(run_dir: Path) -> None:
    """The psfnoise run's validation and in-order scores beside the
    record's, per kind and noise level (means over the five PSF settings)."""
    def load(d: Path):
        hist = last_mean(json.loads((d / "history.json").read_text()))
        with open(d / "psfnoise_errors.csv") as fh:
            in_order = {row["model"]: float(row["mse"]) for row in csv.DictReader(fh)}
        return hist, in_order

    (pv, pi), (rv, ri) = load(run_dir), load(PSFNOISE_RECORD)
    for kind in ("tr", "res"):
        for j, noise in enumerate(NOISE_SETTINGS):
            names = [f"{kind}_{i}_{j}" for i in range(5)]
            mean = lambda table: statistics.fmean(table[n] for n in names)  # noqa: E731
            print(json.dumps({"kind": kind, "noise": noise, "val_port": mean(pv), "val_record": mean(rv),
                              "val_delta": mean(pv) - mean(rv), "in_order_port": mean(pi),
                              "in_order_record": mean(ri), "in_order_delta": mean(pi) - mean(ri)}))


def main(run_dirs) -> int:
    record = last_mean(json.loads(RECORD.read_text()))
    runs = [last_mean(json.loads((Path(d) / "history.json").read_text())) for d in run_dirs]
    n = len(runs)
    mean = {m: statistics.fmean(r[m] for r in runs) for m in record}
    sd = {m: statistics.stdev(r[m] for r in runs) if n > 1 else 0.0 for m in record}
    for m in record:
        print(json.dumps({"model": m, "runs": [r[m] for r in runs], "mean": mean[m], "sd": sd[m],
                          "record": record[m], "delta": mean[m] - record[m]}))

    rule1 = {m: abs(mean[m] - record[m]) <= 0.10 for m in record}
    rule2a = {}
    for kind in ("trans", "resnet"):
        clean = mean[f"{kind}_no_noise"]
        noisy = min(mean[f"{kind}_{s}"] for s in SETTINGS[1:])
        rule2a[kind] = {"no_noise_below_best_noisy_by": 1.0 - clean / noisy, "holds": clean <= 0.6 * noisy}
    raw = "trans_poisson_noise"
    rule2b = {}
    for s in ("gauss_filter", "RL_2", "RL_5", "RL_10"):
        m = f"trans_{s}"
        diff = mean[m] - mean[raw]
        se = (sd[m] ** 2 / n + sd[raw] ** 2 / n) ** 0.5
        rule2b[m] = {"diff": diff, "se": se, "holds": abs(diff) <= 0.05 or abs(diff) <= 2 * se}
    wins = [s for s in SETTINGS[1:] if mean[f"trans_{s}"] < mean[f"resnet_{s}"]]
    verdict = {
        "runs": n,
        "rule1_within_0.10": all(rule1.values()), "rule1_misses": [m for m, ok in rule1.items() if not ok],
        "rule2a": rule2a, "rule2b": rule2b,
        "rule2c_trans_wins": wins, "rule2c_holds": len(wins) >= 5,
    }
    ok = (verdict["rule1_within_0.10"] and all(v["holds"] for v in rule2a.values())
          and all(v["holds"] for v in rule2b.values()) and verdict["rule2c_holds"])
    verdict["all_hold"] = ok
    print(json.dumps(verdict))
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", type=Path)
    ap.add_argument("--psfnoise", type=Path, default=None)
    args = ap.parse_args()
    if args.psfnoise is not None:
        validation_offset(args.psfnoise)
    raise SystemExit(main(args.runs))
