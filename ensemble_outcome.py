#!/usr/bin/env python3
"""The ensemble and continuous-D studies' outcome: the port's card seeds
against JAX's records, by the rules in the docstring of
``moleculardiffusion_mivit_tpu_torch/experiments/ensemble.py`` (written
before the runs).

- Ensemble: ``results/torch_ensemble_seed{0..3}`` (``python -m
  moleculardiffusion_mivit_tpu_torch.experiments.ensemble --members 8
  --cycles 150 --n 256 --curriculum continuous --d-high 10.5 --seed S``)
  against ``results/ensemble_150`` (JAX on a TPU, one draw of 8 members).
  E1: the 32 ``imft`` member MSEs pooled, |mean P − mean J| ≤ max(0.02,
  3·sqrt(sd_P²/32 + sd_J²/8)); E2: ``ensemble_mse`` of ``imft`` and
  ``imft_tta``, |mean P − record| ≤ max(0.02, 3·sd_P·sqrt(1 + 1/4)); E3:
  in every seed ``imft``'s ``ensemble_mse`` < ``member_mse_mean``.
- Continuous-D: ``results/torch_continuous_d_seed{0..3}`` (``python -m
  moleculardiffusion_mivit_tpu_torch.experiments.continuous_d --cycles 150
  --n 256 --d-high 8 --seed S``), its ``imft`` MSE against the 8 ``imft``
  members of ``results/ensemble_d8``. C1: |mean P − mean J| ≤ max(0.03,
  3·sqrt(sd_P²/4 + sd_J²/8)).
- The records keep only their members' mean, min and max: sd_J = (max −
  min) / 2.847 (d₂ for 8 normal draws).
- Reported, not held: the ``committed`` columns beside the records',
  ``imft_tta``'s members, each seed's averaging gain, the continuous runs'
  ``committed`` MSE beside RESULTS.md's 0.314, the seconds.

It reads only the JSON reports. Writes
``results/ensemble_outcome/verdict.json`` and exits 1 when a held rule
misses.

Usage: ``python3 ensemble_outcome.py [--out results/ensemble_outcome]``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RESULTS = ROOT / "results"
OUT = RESULTS / "ensemble_outcome"
PORT_SEEDS = range(4)
PORT_ENSEMBLE = [RESULTS / f"torch_ensemble_seed{s}" for s in PORT_SEEDS]
PORT_CONTINUOUS = [RESULTS / f"torch_continuous_d_seed{s}" for s in PORT_SEEDS]
RECORD = RESULTS / "ensemble_150"  # JAX, 8 members, U(0.1, 10.5), 150 cycles × 256
RECORD_D8 = RESULTS / "ensemble_d8"  # JAX, 8 members, U(0.1, 8), 150 cycles × 256
ENSEMBLE_FILE, FULL_FILE = "ensemble_report.json", "ensemble_full_report.json"
CONTINUOUS_FILE = "continuous_d_report.json"
D2_8 = 2.847  # expected range of 8 standard normal draws
MIN_LIMIT = {"E1": 0.02, "E2": 0.02, "C1": 0.03}
RESULTS_MD_CONTINUOUS_COMMITTED = 0.314  # RESULTS.md, the continuous-D curriculum on the committed suite


def record_members(record: dict, tag: str = "imft") -> dict:
    """A record's member MSEs as it keeps them: mean, min, max, and the sd
    estimated from the range."""
    t = record[tag]
    return {"mean": t["member_mse_mean"], "min": t["member_mse_min"], "max": t["member_mse_max"],
            "n": record["members"], "sd": (t["member_mse_max"] - t["member_mse_min"]) / D2_8}


def _rule(p, mean_j, limit) -> dict:
    p = np.asarray(p, dtype=np.float64)
    delta = float(abs(p.mean() - mean_j))
    return {"port": p.tolist(), "port_mean": float(p.mean()), "port_sd": float(p.std(ddof=1)), "jax_mean": mean_j,
            "limit": float(limit), "delta": delta, "held": bool(delta <= limit)}


def judge(ensemble: list, members: list, continuous: list, record: dict, record_d8: dict) -> dict:
    """The rules of ``experiments/ensemble.py``'s docstring. ``ensemble``:
    each port seed's ``ensemble_report.json``; ``members``: each seed's
    unrounded ``imft`` member MSEs; ``continuous``: each continuous-D seed's
    ``continuous_d_report.json``; ``record``, ``record_d8``: JAX's
    ``ensemble_150`` and ``ensemble_d8`` reports."""
    out = {"port_seeds": [r["seed"] for r in ensemble], "continuous_seeds": [r["seed"] for r in continuous],
           "held": {}, "rules": {}, "reported": {}}
    j = record_members(record)
    p = [x for seed in members for x in seed]
    e1 = _rule(p, j["mean"], max(MIN_LIMIT["E1"], 3 * np.sqrt(np.var(p, ddof=1) / len(p) + j["sd"] ** 2 / j["n"])))
    out["rules"]["E1"] = {**e1, "jax": j}
    out["held"]["E1_imft_member_mse_mean"] = e1["held"]
    for tag in ("imft", "imft_tta"):
        e = [r[tag]["ensemble_mse"] for r in ensemble]
        rec = record[tag]["ensemble_mse"]
        e2 = _rule(e, rec, max(MIN_LIMIT["E2"], 3 * np.std(e, ddof=1) * np.sqrt(1 + 1 / len(e))))
        out["rules"][f"E2_{tag}"] = e2
        out["held"][f"E2_{tag}_ensemble_mse"] = e2["held"]
    gains = [1 - r["imft"]["ensemble_mse"] / r["imft"]["member_mse_mean"] for r in ensemble]
    out["rules"]["E3"] = {"gain_per_seed": gains, "record_gain": 1 - record["imft"]["ensemble_mse"] / j["mean"]}
    out["held"]["E3_imft_ensemble_below_member_mean_every_seed"] = bool(
        all(r["imft"]["ensemble_mse"] < r["imft"]["member_mse_mean"] for r in ensemble))
    j8 = record_members(record_d8)
    c = [r["imft"]["mse"] for r in continuous]
    c1 = _rule(c, j8["mean"], max(MIN_LIMIT["C1"], 3 * np.sqrt(np.var(c, ddof=1) / len(c) + j8["sd"] ** 2 / j8["n"])))
    out["rules"]["C1"] = {**c1, "jax": j8}
    out["held"]["C1_continuous_d_imft_mse"] = c1["held"]
    rep = out["reported"]
    for tag in ("imft_tta", "committed", "committed_tta"):
        rep[tag] = {"port_member_mse_mean": [r[tag]["member_mse_mean"] for r in ensemble],
                    "port_ensemble_mse": [r[tag]["ensemble_mse"] for r in ensemble],
                    "record_member_mse_mean": record[tag]["member_mse_mean"],
                    "record_ensemble_mse": record[tag]["ensemble_mse"]}
    rep["continuous_committed_mse"] = {"port": [r["committed"]["mse"] for r in continuous],
                                       "results_md": RESULTS_MD_CONTINUOUS_COMMITTED,
                                       "record_d8_committed_member_mse_mean": record_d8["committed"]["member_mse_mean"]}
    rep["train_seconds"] = {"ensemble": [r["train_seconds"] for r in ensemble],
                            "continuous_d": [r["train_seconds"] for r in continuous],
                            "record_ensemble": record["train_seconds"]}
    rep["card"] = sorted({r["card"] for r in ensemble + continuous})
    out["ok"] = all(out["held"].values())
    return out


def load() -> tuple:
    """The committed reports: ``(ensemble, members, continuous, record,
    record_d8)`` as ``judge`` takes them."""
    ensemble = [json.loads((d / ENSEMBLE_FILE).read_text()) for d in PORT_ENSEMBLE]
    members = [json.loads((d / FULL_FILE).read_text())["suites"]["imft"]["member_mse"] for d in PORT_ENSEMBLE]
    continuous = [json.loads((d / CONTINUOUS_FILE).read_text()) for d in PORT_CONTINUOUS]
    record = json.loads((RECORD / ENSEMBLE_FILE).read_text())
    record_d8 = json.loads((RECORD_D8 / ENSEMBLE_FILE).read_text())
    return ensemble, members, continuous, record, record_d8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    verdict = judge(*load())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "verdict.json").write_text(json.dumps(verdict, indent=1) + "\n")
    print(json.dumps({k: verdict[k] for k in ("held", "ok")}, indent=1))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
