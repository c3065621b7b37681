#!/usr/bin/env python3
"""Score 100-cycle runs of the port's real-data demo against the JAX record.

Usage: ``python3 realdata_outcome.py DIR [DIR ...]``, each DIR the ``--out``
of one ``python -m moleculardiffusion_mivit_tpu_torch.realdata.demo
--train-cycles 100 --seed S`` run. Prints one row a seed (tracks, model and
MSD mean absolute error, unrounded from ``realdata_report.json``), the
record's row (``results/realdata_demo/realdata_metrics.json``, JAX, one
seed), the tracks that follow more than one true particle (identity
swaps of the tracker), and the three rules the outcome is held to: 6 tracks in every seed;
every seed's MSD error ≤ 0.10; the seeds' mean model error ≤ the record's
+ 0.04. Exits 1 when a rule misses.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RECORD = ROOT / "results" / "realdata_demo" / "realdata_metrics.json"


def main(dirs) -> int:
    record = json.loads(RECORD.read_text())
    rows = []
    for d in dirs:
        rep = json.loads(Path(d, "realdata_report.json").read_text())
        d_true = rep["summary"]["d_true"]
        rows.append({"seed": rep["seed"], "n_tracks": rep["summary"]["n_tracks"],
                     "model_mean_abs_err": float(np.abs(np.asarray(rep["d_model"]) - d_true).mean()),
                     "msd_mean_abs_err": float(np.abs(np.asarray(rep["d_msd"]) - d_true).mean()),
                     "model_mean": float(np.mean(rep["d_model"])), "msd_mean": float(np.mean(rep["d_msd"])),
                     "d_msd": rep["d_msd"], "d_model": rep["d_model"],
                     "swapped_tracks": [i for i, parts in enumerate(rep["track_particles"]) if len(parts) > 1],
                     "last_train_loss": rep["train_loss"][-1],
                     "s_per_cycle_median": float(np.median(rep["s_per_cycle"])),
                     "device": rep["device"]})
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"record": record}))
    model_mean = float(np.mean([r["model_mean_abs_err"] for r in rows]))
    rules = {
        "n_tracks_6_every_seed": all(r["n_tracks"] == 6 for r in rows),
        "msd_err_le_0.10_every_seed": all(r["msd_mean_abs_err"] <= 0.10 for r in rows),
        "mean_model_err_le_record_plus_0.04": model_mean <= record["model_mean_abs_err"] + 0.04,
    }
    print(json.dumps({"seeds": len(rows), "mean_model_mean_abs_err": model_mean, "rules": rules}))
    return 0 if all(rules.values()) else 1


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
