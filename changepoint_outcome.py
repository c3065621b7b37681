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
- The continuous-curriculum demo (C1, C2): at the cut (10 cycles × 64 a
  class), the port's eight card seeds of each curriculum
  (``results/torch_changepoint_demo_cut10_{continuous,discrete}_seed{0..7}``)
  against four JAX seeds of each
  (``results/changepoint_outcome/jax_cut10_{continuous,discrete}_seed{1..4}.json``):
  the AUC held per curriculum when |mean P − mean J| ≤ max(0.03,
  3·sqrt(sd_P²/n_P + sd_J²/n_J)), and the sign of (discrete − continuous)
  held equal on both sides; at the records' protocol (100 cycles × 64), the
  port's four seeds of each (``results/torch_changepoint_demo_{continuous,
  discrete}_seed{0..3}``) against ``results/changepoint_continuous`` and
  ``results/changepoint_demo``: each record held within max(0.03,
  3·sd_P·sqrt(1 + 1/n_P)) of the port's mean.
- Reported, not held: false-positive rates, median split errors, the
  rates by |ΔD| with their intervals, the demo's detection rate and
  ``results/changepoint_demo``, the single continuous-curriculum runs
  (``results/torch_changepoint_modular_continuous_seed0`` and the demo's
  earlier seed 0, ``results/torch_changepoint_demo_continuous_seed0_earlier_streams``,
  ``--continuous 0.1,8``) beside ``results/changepoint_modular_continuous`` and
  ``results/changepoint_continuous``, and per C1/C2 seed the detection
  rate, the mean scores and ``const_frame_sd``; and, where they exist, the
  port's C1 seeds re-run and scored on JAX's own evaluation set as well
  (``results/changepoint_outcome/shared_eval``, by
  ``changepoint_shared_eval.py``) beside JAX's seeds on that set.

It reads only the JSON reports. Writes
``results/changepoint_outcome/verdict.json`` and exits 1 when a held rule
misses.

JAX's C1 seeds are made by ``changepoint_jax_seeds.py`` (``python3
changepoint_jax_seeds.py --jax-seeds 1 --first-jax-seed K --cycles 10
[--continuous 0.1,8]``, one process a seed), not here: this script imports
no JAX.

Usage: ``python3 changepoint_outcome.py [--out results/changepoint_outcome]``.
"""

from __future__ import annotations

import argparse
import hashlib
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
CONTINUOUS = {  # port run → JAX record, reported (the demo's from the streams before the re-keying of the
    # continuous curriculum's render; C2 re-ran its seed 0)
    "modular": (RESULTS / "torch_changepoint_modular_continuous_seed0", RESULTS / "changepoint_modular_continuous"),
    "demo": (RESULTS / "torch_changepoint_demo_continuous_seed0_earlier_streams", RESULTS / "changepoint_continuous"),
}
ARMS = ("mod_images", "mod_both_concat", "mod_hybrid")
MIN_LIMIT = {"roc_auc": 0.02, "detection_rate": 0.05}
DEMO_MIN_LIMIT = 0.03
MODULAR_FILE, DEMO_FILE = "changepoint_modular.json", "changepoint_metrics.json"
# the continuous-curriculum demo against the JAX package (C1 at the cut, C2 at the records' protocol)
CURRICULA = ("continuous", "discrete")
CUT_CYCLES = 10
C1_PORT_SEEDS, C1_JAX_SEEDS, C2_PORT_SEEDS = range(8), range(1, 5), range(4)
C2_RECORDS = {"continuous": RESULTS / "changepoint_continuous", "discrete": RESULTS / "changepoint_demo"}
PER_SEED = ("roc_auc", "detection_rate", "mean_score_mixed", "mean_score_const", "const_frame_sd")


def c1_port_dir(curriculum: str, seed: int) -> Path:
    return RESULTS / f"torch_changepoint_demo_cut{CUT_CYCLES}_{curriculum}_seed{seed}"


def c2_port_dir(curriculum: str, seed: int) -> Path:
    return RESULTS / f"torch_changepoint_demo_{curriculum}_seed{seed}"


def c1_jax_file(curriculum: str, seed: int, out: Path = OUT) -> Path:
    return out / f"jax_cut{CUT_CYCLES}_{curriculum}_seed{seed}.json"


def eval_set_digest(arrays: dict) -> str:
    """SHA-256 over an evaluation set's arrays in key order (name, dtype,
    shape and bytes): the same set on both sides of C1."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(f"{name}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def shared_eval_file(curriculum: str, seed: int, out: Path = OUT) -> Path:
    return out / "shared_eval" / f"port_cut{CUT_CYCLES}_{curriculum}_seed{seed}.json"


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


def judge_continuous_demo(c1_port: dict, c1_jax: dict, c2_port: dict, c2_records: dict) -> dict:
    """The continuous-curriculum demo's rule (C1, C2) of
    ``changepoint_study.py``'s docstring. Each argument maps a curriculum
    to its per-seed dicts (``seed`` and ``PER_SEED``; a record is one
    ``changepoint_metrics.json``)."""
    out = {"held": {}, "c1": {}, "c2": {}}
    for curr in CURRICULA:
        p, j = _stats([r["roc_auc"] for r in c1_port[curr]]), _stats([r["roc_auc"] for r in c1_jax[curr]])
        limit = max(DEMO_MIN_LIMIT, 3 * np.sqrt(p["sd"] ** 2 / len(c1_port[curr]) + j["sd"] ** 2 / len(c1_jax[curr])))
        delta = abs(p["mean"] - j["mean"])
        out["c1"][curr] = {"roc_auc": {"port": p, "jax": j, "limit": float(limit), "delta": float(delta)},
                           "per_seed": {"port": [{k: r.get(k) for k in ("seed", *PER_SEED)} for r in c1_port[curr]],
                                        "jax": [{k: r.get(k) for k in ("seed", *PER_SEED)} for r in c1_jax[curr]]}}
        for k in PER_SEED[1:]:
            out["c1"][curr][k] = {side: _stats([r[k] for r in runs[curr]])
                                  for side, runs in (("port", c1_port), ("jax", c1_jax))
                                  if all(r.get(k) is not None for r in runs[curr])}
        out["held"][f"c1_{curr}_roc_auc"] = bool(delta <= limit)
    gap = {side: out["c1"]["discrete"]["roc_auc"][side]["mean"] - out["c1"]["continuous"]["roc_auc"][side]["mean"]
           for side in ("port", "jax")}
    out["c1"]["discrete_minus_continuous"] = gap
    out["held"]["c1_direction"] = bool(np.sign(gap["port"]) == np.sign(gap["jax"]))
    for curr in CURRICULA:
        p = _stats([r["roc_auc"] for r in c2_port[curr]])
        record = c2_records[curr]["roc_auc"]
        limit = max(DEMO_MIN_LIMIT, 3 * p["sd"] * np.sqrt(1 + 1 / len(c2_port[curr])))
        delta = abs(p["mean"] - record)
        out["c2"][curr] = {"roc_auc": {"port": p, "record": record, "limit": float(limit), "delta": float(delta)},
                           "per_seed": [{k: r.get(k) for k in ("seed", *PER_SEED)} for r in c2_port[curr]],
                           "record": {k: c2_records[curr].get(k) for k in PER_SEED}}
        out["held"][f"c2_{curr}_roc_auc"] = bool(delta <= limit)
    out["ok"] = all(out["held"].values())
    return out


def judge_shared_eval(shared: dict, c1_jax: dict, c1_port: dict) -> dict:
    """Reported, not held: the port's C1 seeds re-run and scored on JAX's
    own evaluation set (``changepoint_shared_eval.py``) beside JAX's seeds,
    which scored that set. ``shared`` maps a curriculum to those runs'
    dicts, ``c1_jax`` and ``c1_port`` as for ``judge_continuous_demo``. Per
    curriculum: each side's statistics, the AUC's distance on the one set
    with C1's limit on it, and each re-run's own-set AUC beside the
    committed C1 run of its seed; the sign of (discrete − continuous) on
    the one set."""
    out = {}
    for curr in CURRICULA:
        runs, jax = shared[curr], c1_jax[curr]
        cell = {}
        for k in ("roc_auc", "detection_rate", "mean_score_mixed", "mean_score_const"):
            cell[k] = {"port_own_set": _stats([r["own_set"][k] for r in runs]),
                       "port_jax_set": _stats([r["jax_set"][k] for r in runs]), "jax": _stats([r[k] for r in jax])}
        cell["const_frame_sd"] = {"port_own_set": _stats([r["own_set_const_frame_sd"] for r in runs]),
                                  "port_jax_set": _stats([r["jax_set_const_frame_sd"] for r in runs]),
                                  "jax": _stats([r["const_frame_sd"] for r in jax])}
        p, j = cell["roc_auc"]["port_jax_set"], cell["roc_auc"]["jax"]
        limit = max(DEMO_MIN_LIMIT, 3 * np.sqrt(p["sd"] ** 2 / len(runs) + j["sd"] ** 2 / len(jax)))
        cell["roc_auc"].update(delta=float(abs(p["mean"] - j["mean"])), limit=float(limit),
                               within=bool(abs(p["mean"] - j["mean"]) <= limit))
        c1 = {r["seed"]: r["roc_auc"] for r in c1_port[curr]}
        cell["per_seed"] = [{"seed": r["seed"], "c1_run": c1.get(r["seed"]), "own_set": r["own_set"]["roc_auc"],
                             "jax_set": r["jax_set"]["roc_auc"]} for r in runs]
        cell["own_set_repeats_c1"] = sum(s["own_set"] == s["c1_run"] for s in cell["per_seed"])
        out[curr] = cell
    gap = {side: out["discrete"]["roc_auc"][side]["mean"] - out["continuous"]["roc_auc"][side]["mean"]
           for side in ("port_own_set", "port_jax_set", "jax")}
    digests = {r["jax_set_sha256"] for c in CURRICULA for r in shared[c]}
    digests |= {r.get("eval_set_sha256") for c in CURRICULA for r in c1_jax[c]}
    out.update(discrete_minus_continuous=gap, same_sign_on_jax_set=bool(np.sign(gap["port_jax_set"]) ==
                                                                        np.sign(gap["jax"])),
               one_set=len(digests) == 1, cards=sorted({r["card"] for c in CURRICULA for r in shared[c]}))
    return out


def load_shared_eval(out: Path = OUT) -> dict | None:
    """The shared-evaluation runs of every C1 port seed, or None if any is
    missing."""
    files = {c: [shared_eval_file(c, s, out) for s in C1_PORT_SEEDS] for c in CURRICULA}
    if not all(f.exists() for fs in files.values() for f in fs):
        return None
    return {c: [json.loads(f.read_text()) for f in fs] for c, fs in files.items()}


def with_continuous_demo(verdict: dict, continuous_demo: dict) -> dict:
    """``judge``'s verdict with the C1/C2 verdict under ``continuous_demo``
    and its held rules among the others (``demo_``-prefixed)."""
    held = {**verdict["held"], **{f"demo_{k}": v for k, v in continuous_demo["held"].items()}}
    return {**verdict, "held": held, "continuous_demo": continuous_demo, "ok": all(held.values())}


def _port_demo_seed(d: Path) -> dict:
    """A port run's example report with its seed and ``const_frame_sd``."""
    full = _load(d, "changepoint_metrics_report.json")
    return {**full["report"], "seed": full["seed"], "const_frame_sd": full.get("const_frame_sd"),
            "card": full["card"], "seconds": full["seconds"]}


def _jax_demo_seed(path: Path) -> dict:
    full = json.loads(path.read_text())
    return {**full["report"], "seed": full["seed"], "const_frame_sd": full["const_frame_sd"],
            "eval_set_sha256": full.get("eval_set_sha256"), "seconds": full["seconds"]}


def load_continuous_demo(out: Path = OUT) -> tuple:
    """The C1/C2 runs the rule names: ``(c1_port, c1_jax, c2_port,
    c2_records)`` for ``judge_continuous_demo``."""
    c1_port = {c: [_port_demo_seed(c1_port_dir(c, s)) for s in C1_PORT_SEEDS] for c in CURRICULA}
    c1_jax = {c: [_jax_demo_seed(c1_jax_file(c, s, out)) for s in C1_JAX_SEEDS] for c in CURRICULA}
    c2_port = {c: [_port_demo_seed(c2_port_dir(c, s)) for s in C2_PORT_SEEDS] for c in CURRICULA}
    return c1_port, c1_jax, c2_port, {c: _load(d, DEMO_FILE) for c, d in C2_RECORDS.items()}


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
    runs = load_continuous_demo(out)
    continuous_demo = judge_continuous_demo(*runs)
    shared = load_shared_eval(out)
    if shared is not None:
        continuous_demo["shared_eval"] = judge_shared_eval(shared, runs[1], runs[0])
    verdict = with_continuous_demo(verdict, continuous_demo)
    out.mkdir(parents=True, exist_ok=True)
    (out / "verdict.json").write_text(json.dumps(verdict, indent=1) + "\n")
    print(json.dumps({k: verdict[k] for k in ("held", "ok")}, indent=1))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
