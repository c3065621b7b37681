#!/usr/bin/env python3
"""The change-point studies' outcome: the port's card seeds against JAX's
records, by the rules in the docstring of
``moleculardiffusion_mivit_tpu_torch/evaluation/changepoint_study.py``
(written before the runs).

- Modular study: ``results/torch_changepoint_modular_seed{0..3}`` (``python
  -m moleculardiffusion_mivit_tpu_torch.evaluation.changepoint_study
  modular --with-hybrid --cycles 150 --seqs-per-d 256 --eval-per-class 384
  --seed S``) against JAX's three seeds at that protocol
  (``results/changepoint_modular_r5``, ``_r5_seed1``, ``_r5_seed2``): per
  arm, ``roc_auc`` and ``detection_rate`` held when |mean P − mean J| ≤
  max(f, 3·sqrt(sd_P²/n_P + sd_J²/n_J)), f = 0.02 / 0.05; mod_images' AUC
  below both feature-token arms' in every port seed.
- Demo: ``results/torch_changepoint_demo_seed{0..3}`` (``demo --cycles 150
  --seqs-per-d 256 --seed S``) against ``results/changepoint_scaled`` (one
  JAX draw): the AUC held when |mean P − record| ≤ max(0.03,
  3·sd_P·sqrt(1 + 1/n_P)).
- Reported, not held: false-positive rates, median split errors, the
  rates by |ΔD| with their intervals, the demo's detection rate and
  ``results/changepoint_demo``, and the continuous-curriculum runs
  (``results/torch_changepoint_{modular,demo}_continuous_seed0``, ``--continuous
  0.1,8``) beside ``results/changepoint_modular_continuous`` and
  ``results/changepoint_continuous``.

It reads only the JSON reports. Writes
``results/changepoint_outcome/verdict.json`` and exits 1 when a held rule
misses.

Usage: ``python3 changepoint_outcome.py [--out results/changepoint_outcome]``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RESULTS = ROOT / "results"
OUT = RESULTS / "changepoint_outcome"
PORT_SEEDS = range(4)
JAX_MODULAR = [RESULTS / d for d in ("changepoint_modular_r5", "changepoint_modular_r5_seed1",
                                     "changepoint_modular_r5_seed2")]
PORT_MODULAR = [RESULTS / f"torch_changepoint_modular_seed{s}" for s in PORT_SEEDS]
PORT_DEMO = [RESULTS / f"torch_changepoint_demo_seed{s}" for s in PORT_SEEDS]
DEMO_RECORD = RESULTS / "changepoint_scaled"  # JAX, 150 cycles × 256 a class, one draw
DEMO_REPORTED = RESULTS / "changepoint_demo"  # JAX, 100 cycles × 64 a class
CONTINUOUS = {  # port run → JAX record, reported
    "modular": (RESULTS / "torch_changepoint_modular_continuous_seed0", RESULTS / "changepoint_modular_continuous"),
    "demo": (RESULTS / "torch_changepoint_demo_continuous_seed0", RESULTS / "changepoint_continuous"),
}
ARMS = ("mod_images", "mod_both_concat", "mod_hybrid")
MIN_LIMIT = {"roc_auc": 0.02, "detection_rate": 0.05}
DEMO_MIN_LIMIT = 0.03
MODULAR_FILE, DEMO_FILE = "changepoint_modular.json", "changepoint_metrics.json"


def _load(d: Path, name: str) -> dict:
    return json.loads((d / name).read_text())


def _stats(values) -> dict:
    v = np.asarray(values, dtype=np.float64)
    return {"values": v.tolist(), "mean": float(v.mean()), "sd": float(v.std(ddof=1)) if len(v) > 1 else 0.0}


def judge(port_modular: list, jax_modular: list, port_demo: list, demo_record: dict,
          demo_reported: dict | None = None, continuous: dict | None = None) -> dict:
    """The rules of ``changepoint_study.py``'s docstring on the reports (each
    a ``changepoint_modular.json`` or ``changepoint_metrics.json`` dict)."""
    out = {"port_modular_seeds": [r["seed"] for r in port_modular],
           "jax_modular_seeds": [r["seed"] for r in jax_modular],
           "held": {}, "reported": {}, "modular": {}, "demo": {}}
    n_p, n_j = len(port_modular), len(jax_modular)
    for arm in ARMS:
        cells = {}
        for stat, floor in MIN_LIMIT.items():
            p, j = _stats([r[arm][stat] for r in port_modular]), _stats([r[arm][stat] for r in jax_modular])
            limit = max(floor, 3 * np.sqrt(p["sd"] ** 2 / n_p + j["sd"] ** 2 / n_j))
            delta = abs(p["mean"] - j["mean"])
            cells[stat] = {"port": p, "jax": j, "limit": float(limit), "delta": float(delta)}
            out["held"][f"modular_{arm}_{stat}"] = bool(delta <= limit)
        for stat in ("false_positive_rate", "median_split_error_frames"):
            cells[stat] = {"port": [r[arm][stat] for r in port_modular], "jax": [r[arm][stat] for r in jax_modular]}
        cells["by_contrast"] = {"port": [r[arm]["by_contrast"] for r in port_modular],
                                "jax": [r[arm]["by_contrast"] for r in jax_modular]}
        out["modular"][arm] = cells
    below = [r["mod_images"]["roc_auc"] < min(r["mod_both_concat"]["roc_auc"], r["mod_hybrid"]["roc_auc"])
             for r in port_modular]
    out["held"]["modular_images_auc_below_both_feature_arms_every_seed"] = bool(all(below))
    out["reported"]["modular_auc_margin_per_seed"] = {
        "port": [min(r["mod_both_concat"]["roc_auc"], r["mod_hybrid"]["roc_auc"]) - r["mod_images"]["roc_auc"]
                 for r in port_modular],
        "jax": [min(r["mod_both_concat"]["roc_auc"], r["mod_hybrid"]["roc_auc"]) - r["mod_images"]["roc_auc"]
                for r in jax_modular]}

    p = _stats([r["roc_auc"] for r in port_demo])
    limit = max(DEMO_MIN_LIMIT, 3 * p["sd"] * np.sqrt(1 + 1 / len(port_demo)))
    delta = abs(p["mean"] - demo_record["roc_auc"])
    out["demo"] = {"seeds": [r.get("seed") for r in port_demo],
                   "roc_auc": {"port": p, "record": demo_record["roc_auc"], "limit": float(limit),
                               "delta": float(delta)},
                   "detection_rate": {"port": _stats([r["detection_rate"] for r in port_demo]),
                                      "record": demo_record["detection_rate"]},
                   "false_positive_rate": {"port": [r["false_positive_rate"] for r in port_demo],
                                           "record": demo_record["false_positive_rate"]}}
    if demo_reported is not None:
        out["demo"]["record_100x64_roc_auc"] = demo_reported["roc_auc"]
    out["held"]["demo_roc_auc"] = bool(delta <= limit)
    if continuous:
        out["reported"]["continuous"] = continuous
    out["ok"] = all(out["held"].values())
    return out


def _continuous() -> dict:
    """Each continuous-curriculum run beside its JAX record, where the run
    exists: the AUC and detection rate of every arm."""
    out = {}
    for study, (port_dir, record_dir) in CONTINUOUS.items():
        name = MODULAR_FILE if study == "modular" else DEMO_FILE
        if not (port_dir / name).exists():
            continue
        port, record = _load(port_dir, name), _load(record_dir, name)
        if study == "modular":
            out[study] = {a: {s: {"port": port[a][s], "record": record.get(a, {}).get(s)} for s in MIN_LIMIT}
                          for a in ARMS if a in port}
        else:
            out[study] = {s: {"port": port[s], "record": record[s]} for s in MIN_LIMIT}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    verdict = judge([_load(d, MODULAR_FILE) for d in PORT_MODULAR], [_load(d, MODULAR_FILE) for d in JAX_MODULAR],
                    [_load(d, DEMO_FILE) | {"seed": s} for s, d in zip(PORT_SEEDS, PORT_DEMO)],
                    _load(DEMO_RECORD, DEMO_FILE), _load(DEMO_REPORTED, DEMO_FILE), _continuous())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "verdict.json").write_text(json.dumps(verdict, indent=1) + "\n")
    print(json.dumps({k: verdict[k] for k in ("held", "ok")}, indent=1))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
