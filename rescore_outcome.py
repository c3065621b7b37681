#!/usr/bin/env python3
"""The images-features rescoring studies' outcome and the CPU-sized
examples': the port's committed card reports against JAX's records, by the
rules in the docstrings of ``moleculardiffusion_mivit_tpu_torch/``
``experiments/render_noise.py`` (R1-R2), ``experiments/seed_ensemble.py``
(S1-S2), ``experiments/tta_rescore.py`` (T1-T2), ``evaluation/
msd_protocol.py`` (M1) and ``sim/simulator_validation.py`` (V1), written
before the runs.

- R1-R2: ``results/torch_render_noise`` (four seeds × five renders) against
  ``results/render_noise``.
- S1-S2: ``results/torch_seed_ensemble/seed{0..4}`` (five shared renders)
  against ``results/seed_ensemble``. Reported beside them, not judged: the
  ``ft_mlp`` members, port against JAX, in pooled standard errors (that arm
  reads no image, so its spread over renders is 0).
- T1-T2: ``results/torch_images_features_seed{0..3}/tta_report.json``
  against ``results/images_features_reconciled_scaled/tta_errors.csv``.
- M1: ``results/torch_msd_protocol`` against JAX's rows on the same arrays
  (``results/torch_msd_protocol/jax_rows.json``).
- V1: ``results/torch_simulator_validation`` against JAX's example on the
  CPU (``results/simulator_validation/jax_report.json``).
- F8-M and F8-V, written here before the port's seeds 4-7 ran: the
  ``ft_mlp`` arm over training seeds. P is the port's eight f32 members,
  the ``ft_mlp`` row of ``results/torch_images_features_seed{0..7}/
  images_features_errors.csv`` (``run_experiment images_features --cycles
  150 --seqs-per-d 256 --in-order --checkpoint-last 0 --seed S`` on the
  card, one seed at a time); J is JAX's four, the same row of
  ``results/images_features_seed{0..3}/images_features_errors.csv``. The
  render does not reach this arm, so each row is that seed's member of the
  seed ensemble. No seed is added or swapped after the runs.

  - F8-M: |mean_P − mean_J| ≤ max(0.02, 3·sqrt(sd_P²/8 + sd_J²/4)).
  - F8-V: sd_P²/sd_J² inside the two-sided F(7, 3) band at level 0.05,
    [0.170, 14.62].

It reads only the JSON and CSV reports. Writes
``results/rescore_outcome/verdict.json`` and exits 1 when a rule misses.

Usage: ``python3 rescore_outcome.py [--out results/rescore_outcome]``.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
RESULTS = ROOT / "results"
OUT = RESULTS / "rescore_outcome"
PORT_SEEDS = range(4)
RENDER_SEEDS = range(5)
ARMS = ("im_ft_early_tr", "im_tr", "im_resnet", "im_ft_resnet", "im_ft_late_tr", "ft_mlp")
IMAGE_ARMS = ARMS[:5]
FUSION = ("im_ft_early_tr", "im_ft_late_tr")
BELOW_FUSION = ("im_ft_resnet", "im_tr", "im_resnet")
TTA_ROWS = {"im_tr_rot": "im_tr", "im_res_rot": "im_resnet", "im_ft_res_rot": "im_ft_resnet",
            "im_ft_tr_rot": "im_ft_early_tr"}
# the two-sided F bands at level 0.05 (scipy's quantiles, as
# sim2real_outcome.spread_band): (4, 4) for the render σ, (3, 3) for the seed σ
F_BAND_4_4 = (0.10411753745392764, 9.604529884722858)
F_BAND_3_3 = (0.06477026927128882, 15.43918237874729)
# (7, 3) for F8-V: the port's eight ft_mlp members against JAX's four
F_BAND_7_3 = (0.16978449959353228, 14.624395022241258)
F8_PORT_SEEDS = range(8)
F8_JAX_SEEDS = range(4)
MSD_RTOL = 1e-5
CLOSEST_SUITE = "regenerated,    100 D (0.1-10.0), 300 steps [reference val_d_in_order]"
CONTRAST_RTOL = 0.05


def _load(path: Path):
    return json.loads(path.read_text())


def ft_mlp_row(run: Path) -> float:
    """The ``ft_mlp`` in-order MSE of a run's ``images_features_errors.csv``."""
    with open(run / "images_features_errors.csv") as f:
        return next(float(row["mse"]) for row in csv.DictReader(f) if row["model"] == "ft_mlp")


def load() -> dict:
    """Every report the rules read, the port's and JAX's."""
    with open(RESULTS / "images_features_reconciled_scaled" / "tta_errors.csv") as f:
        jax_tta = {row["model"]: float(row["mse"]) for row in csv.DictReader(f)}
    return {
        "render_noise": _load(RESULTS / "torch_render_noise" / "render_noise_report_full.json"),
        "jax_render_noise": _load(RESULTS / "render_noise" / "render_noise_report.json"),
        "seed_ensemble": [_load(RESULTS / "torch_seed_ensemble" / f"seed{r}" / "seed_ensemble_report_full.json")
                          for r in RENDER_SEEDS],
        "jax_seed_ensemble": _load(RESULTS / "seed_ensemble" / "seed_ensemble_report.json"),
        "tta": [_load(RESULTS / f"torch_images_features_seed{s}" / "tta_report.json") for s in PORT_SEEDS],
        "jax_tta": jax_tta,
        "msd": _load(RESULTS / "torch_msd_protocol" / "msd_protocol_report.json"),
        "jax_msd": _load(RESULTS / "torch_msd_protocol" / "jax_rows.json"),
        "simval": _load(RESULTS / "torch_simulator_validation" / "simulator_validation.json"),
        "jax_simval": _load(RESULTS / "simulator_validation" / "jax_report.json"),
        "f8_port": [ft_mlp_row(RESULTS / f"torch_images_features_seed{s}") for s in F8_PORT_SEEDS],
        "f8_jax": [ft_mlp_row(RESULTS / f"images_features_seed{s}") for s in F8_JAX_SEEDS],
    }


def _spread(values, record, floor) -> dict:
    """A record's one draw inside the port's spread over n draws:
    |mean P − J| ≤ max(floor, 3·sd_P·sqrt(1 + 1/n))."""
    p = np.asarray(values, dtype=np.float64)
    limit = max(floor, 3.0 * float(p.std(ddof=1)) * math.sqrt(1.0 + 1.0 / len(p)))
    delta = float(p.mean()) - record
    return {"port": p.tolist(), "mean_p": float(p.mean()), "sd_p": float(p.std(ddof=1)), "record": record,
            "delta": delta, "limit": limit, "held": abs(delta) <= limit}


def judge_render_noise(port: dict, jax: dict) -> dict:
    """R1 and R2."""
    n = len(port["per_render_seed_mean"])
    out = {}
    for name, mean_key, sd_key in (("R1_grand_mean", "grand_mean", "render_sigma_of_seed_mean"),
                                   ("R1_ensemble", "ensemble_render_mean", "ensemble_render_std")):
        s_p, s_j = port[sd_key], jax[sd_key]
        limit = max(0.02, 3.0 * math.sqrt(s_p**2 / n + s_j**2 / n))
        delta = port[mean_key] - jax[mean_key]
        out[name] = {"port": port[mean_key], "record": jax[mean_key], "sd_p": s_p, "sd_j": s_j,
                     "delta": delta, "limit": limit, "held": abs(delta) <= limit}
    render, seed = port["render_sigma_of_seed_mean"], port["seed_sigma_at_fixed_render"]
    r_ratio = render**2 / jax["render_sigma_of_seed_mean"] ** 2
    s_ratio = seed**2 / jax["seed_sigma_at_fixed_render"] ** 2
    out["R2"] = {"render_sigma": render, "seed_sigma": seed, "render_above_seed": render > seed,
                 "render_ratio": r_ratio, "render_band": list(F_BAND_4_4),
                 "seed_ratio": s_ratio, "seed_band": list(F_BAND_3_3),
                 "held": bool(render > seed and F_BAND_4_4[0] <= r_ratio <= F_BAND_4_4[1]
                              and F_BAND_3_3[0] <= s_ratio <= F_BAND_3_3[1])}
    out["matrix"] = port["mse_matrix_seed_x_render"]
    out["ensemble_mse_per_render"] = port["ensemble_mse_per_render"]
    return out


def judge_seed_ensemble(renders: list, jax: dict) -> dict:
    """S1 and S2 over the port's shared renders."""
    s1 = {f"{arm}/{kind}": _spread([r["arms"][arm][kind]["ensemble_mse"] for r in renders],
                                   jax[arm][kind]["ensemble_mse"], 0.02)
          for arm in ARMS for kind in ("plain", "tta")}
    s2 = []
    for r in renders:
        for kind in ("plain", "tta"):
            ens = {arm: r["arms"][arm][kind]["ensemble_mse"] for arm in ARMS}
            below = {arm: ens[arm] <= float(np.mean(r["arms"][arm][kind]["member_mses"])) for arm in IMAGE_ARMS}
            ranked = all(ens[f] < ens[o] for f in FUSION for o in BELOW_FUSION)
            last = all(ens["ft_mlp"] > ens[a] for a in IMAGE_ARMS)
            s2.append({"seed": r["seed"], "kind": kind, "ensemble": ens, "ensemble_below_members": below,
                       "fusion_ranked_above": ranked, "ft_mlp_last": last,
                       "held": all(below.values()) and ranked and last})
    # reported, not judged: ft_mlp reads no image, so only its members
    # (the training seeds) vary; its spread over renders is 0
    port_m = np.asarray(renders[0]["arms"]["ft_mlp"]["plain"]["member_mses"])
    jax_m = np.asarray(jax["ft_mlp"]["plain"]["member_mses"])
    se = math.sqrt(port_m.var(ddof=1) / len(port_m) + jax_m.var(ddof=1) / len(jax_m))
    members = {"port": port_m.tolist(), "jax": jax_m.tolist(), "mean_p": float(port_m.mean()),
               "mean_j": float(jax_m.mean()), "pooled_se": se, "delta_in_se": float(port_m.mean() - jax_m.mean()) / se}
    return {"S1": {"rows": s1, "held": all(v["held"] for v in s1.values())},
            "S2": {"renders": s2, "held": all(v["held"] for v in s2)},
            "ft_mlp_members_reported": members}


def judge_f8(port: list, jax: list) -> dict:
    """F8-M and F8-V on the ``ft_mlp`` members: ``port`` the port's eight
    in-order MSEs, ``jax`` JAX's four."""
    p, j = np.asarray(port, dtype=np.float64), np.asarray(jax, dtype=np.float64)
    sd_p, sd_j = float(p.std(ddof=1)), float(j.std(ddof=1))
    limit = max(0.02, 3.0 * math.sqrt(sd_p**2 / len(p) + sd_j**2 / len(j)))
    delta = float(p.mean() - j.mean())
    ratio = sd_p**2 / sd_j**2
    return {"f8_M": {"port": p.tolist(), "jax": j.tolist(), "mean_p": float(p.mean()), "mean_j": float(j.mean()),
                     "sd_p": sd_p, "sd_j": sd_j, "delta": delta, "limit": limit, "held": abs(delta) <= limit},
            "f8_V": {"sd_p": sd_p, "sd_j": sd_j, "variance_ratio": ratio, "band": list(F_BAND_7_3),
                     "held": F_BAND_7_3[0] <= ratio <= F_BAND_7_3[1]}}


def judge_tta(seeds: list, jax: dict) -> dict:
    """T1 and T2 over the port's seeds."""
    t1 = {row: _spread([s["tta"][row]["mse"] for s in seeds], jax[row], 0.03) for row in TTA_ROWS}
    per_seed = [{row: s["tta"][row]["mse"] - s["plain"][arm]["mse"] for row, arm in TTA_ROWS.items()}
                for s in seeds]
    lowered = {row: sum(d[row] < 0 for d in per_seed) for row in ("im_res_rot", "im_ft_res_rot")}
    early = [abs(d["im_ft_tr_rot"]) for d in per_seed]
    return {"T1": {"rows": t1, "held": all(v["held"] for v in t1.values())},
            "T2": {"tta_minus_plain": per_seed, "seeds_lowered": lowered, "early_abs_change": early,
                   "held": all(n >= 3 for n in lowered.values()) and all(e <= 0.01 for e in early)}}


def judge_msd(port: dict, jax: dict) -> dict:
    """M1: the four regenerated suites' deterministic rows, and the closest
    suite per arm."""
    rows = []
    for p, j in zip(port["suites"][1:], jax["suites"][1:]):
        for arm in ("MSD_Perfect", "MSD_Frame"):
            for stat in ("mse", "std"):
                rel = abs(p["tables"][arm][stat] / j["tables"][arm][stat] - 1.0)
                rows.append({"suite": p["suite"], "arm": arm, "stat": stat, "port": p["tables"][arm][stat],
                             "jax": j["tables"][arm][stat], "rel": rel, "held": rel <= MSD_RTOL})
    closest = {arm: b["suite"] for arm, b in port["closest"].items()}
    closest_held = all(s == CLOSEST_SUITE for s in closest.values()) and len(closest) == 3
    committed = {arm: {"port": port["suites"][0]["tables"][arm]["mse"], "jax": jax["suites"][0]["tables"][arm]["mse"]}
                 for arm in port["suites"][0]["tables"]}
    return {"M1": {"rows": rows, "closest": closest, "closest_held": closest_held,
                   "committed_reported": committed,
                   "held": all(r["held"] for r in rows) and closest_held}}


def judge_simval(port: dict, jax: dict) -> dict:
    """V1."""
    exact = {k: port[k] == jax[k] for k in ("check1_label_layout", "check5_pixel_shift")}
    means = {}
    for k in ("check2_loop_closure", "check3_coarse_sampling", "check4_localization_noise"):
        p, j = port[k], jax[k]
        limit = 3.0 * math.sqrt(p["se"] ** 2 + j["se"] ** 2)
        means[k] = {"port": p["mean"], "jax": j["mean"], "delta": p["mean"] - j["mean"], "limit": limit,
                    "held": abs(p["mean"] - j["mean"]) <= limit}
    contrast_p = [row["contrast"] for row in port["check6_snr"]]
    contrast_j = [row["contrast"] for row in jax["check6_snr"]]
    falls = all(a > b for a, b in zip(contrast_p, contrast_p[1:]))
    rel = [abs(p / j - 1.0) for p, j in zip(contrast_p, contrast_j)]
    snr = {"port": contrast_p, "jax": contrast_j, "rel": rel, "falls": falls,
           "held": falls and all(r <= CONTRAST_RTOL for r in rel)}
    return {"V1": {"exact": exact, "means": means, "snr": snr,
                   "held": all(exact.values()) and all(m["held"] for m in means.values()) and snr["held"]}}


def judge(reports: dict) -> dict:
    """Every rule on ``reports`` (``load()``'s layout)."""
    verdict = {
        **judge_render_noise(reports["render_noise"], reports["jax_render_noise"]),
        **judge_seed_ensemble(reports["seed_ensemble"], reports["jax_seed_ensemble"]),
        **judge_tta(reports["tta"], reports["jax_tta"]),
        **judge_msd(reports["msd"], reports["jax_msd"]),
        **judge_simval(reports["simval"], reports["jax_simval"]),
        **judge_f8(reports["f8_port"], reports["f8_jax"]),
    }
    rules = ("R1_grand_mean", "R1_ensemble", "R2", "S1", "S2", "T1", "T2", "M1", "V1", "f8_M", "f8_V")
    verdict["held"] = {k: bool(verdict[k]["held"]) for k in rules}
    verdict["ok"] = all(verdict["held"].values())
    verdict["cards"] = sorted({r["card"] for r in [reports["render_noise"], *reports["seed_ensemble"],
                                                   *reports["tta"], reports["msd"], reports["simval"]]})
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    verdict = judge(load())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "verdict.json").write_text(json.dumps(verdict, indent=1) + "\n")
    print(json.dumps({k: verdict[k] for k in ("held", "ok")}, indent=1))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
