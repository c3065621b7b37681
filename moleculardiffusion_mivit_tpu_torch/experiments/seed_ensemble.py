"""Seed ensemble of independently trained images-features runs, scored on
ONE shared in-order render.

Port of ``examples/seed_ensemble_rescore.py``. One ``images_features``
experiment built with ``--seed`` provides the shared render of the published
in-order suite (its ``in_order_data``, from the stream ``(seed + 99)``); every
checkpoint is restored into it in turn (``utils.restore_experiment``), and
each of the six learned arms' predictions are averaged across the runs,
plain and with the rotation TTA (``images_features.arm_predictions``: the
mean over the videos rotated by 0, 90, 180 and 270°, the features
unrotated; ``ft_mlp`` has no images and gives its plain prediction for
both). Scoring is the poster's ``error_table`` (mse of pred − true, std / 4).

Run: python -m moleculardiffusion_mivit_tpu_torch.experiments.seed_ensemble
     RUN_DIR [RUN_DIR ...] [--seed 0] [--seqs-per-d 256]
     [--out results/torch_seed_ensemble] [--device cuda|cpu]

It writes ``<out>/seed_ensemble_report.json`` with the example's keys and
rounding (per arm, ``plain`` and ``tta``: ``member_mses``,
``ensemble_mse``, ``ensemble_std``) and, unrounded beside it,
``seed_ensemble_report_full.json`` with the seconds, the card and the K1
launches.

The outcome rules S1-S2, written before the runs on the card;
``rescore_outcome.py`` at the repository's root applies them to the committed
reports. The record is ``results/seed_ensemble`` (JAX, four seeds on one
shared render, ``--seed 0``): ensembles 0.4563 (``im_ft_early_tr``), 0.5669
(``im_tr``), 0.6274 (``im_resnet``), 0.4833 (``im_ft_resnet``), 0.4535
(``im_ft_late_tr``), 0.8267 (``ft_mlp``); with the TTA 0.4563, 0.5658,
0.6253, 0.4772, 0.4532, 0.8267.

- Runs: over ``results/torch_images_features_seed0-3`` at ``--seed 0, 1, 2,
  3, 4`` (five shared renders), ``--out
  results/torch_seed_ensemble/seedR``, one call on the H100.
- S1: for each of the six arms, plain and TTA, the record's one
  shared-render draw J lies inside the port's spread over its five shared
  renders: |mean_P − J| ≤ max(0.02, 3·sd_P·sqrt(1 + 1/5)), mean_P and sd_P
  (``ddof=1``) of the port's five ``ensemble_mse``.
- S2, the findings, on every port render: the ensemble's MSE is ≤ its
  members' mean MSE for every image arm (all but ``ft_mlp``), plain and TTA;
  the two fusion transformers (``im_ft_early_tr``, ``im_ft_late_tr``) have a
  lower ``ensemble_mse`` than each of ``im_ft_resnet``, ``im_tr`` and
  ``im_resnet``, and ``ft_mlp`` the highest of the six, plain and TTA.
- A miss is logged as F8 or later in ROADMAP.md section 3, with its test. It
  is not tuned away, and no seed or render is added or swapped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.evaluation import error_table
from moleculardiffusion_mivit_tpu_torch.experiments import images_features
from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line

ARMS = ("im_ft_early_tr", "im_tr", "im_resnet", "im_ft_resnet", "im_ft_late_tr", "ft_mlp")


def member_predictions(exp, data, run_dirs: Sequence[str]) -> Dict[str, Dict[str, List[np.ndarray]]]:
    """Each run's checkpoint restored into ``exp`` in turn: per arm, the
    members' ``(N,)`` predictions on ``data``, plain and TTA (float32
    numpy)."""
    preds = {a: {"plain": [], "tta": []} for a in ARMS}
    for run_dir in run_dirs:
        restore_experiment(exp, os.path.join(run_dir, "final"))
        for name in ARMS:
            for kind in ("plain", "tta"):
                p = images_features.arm_predictions(exp, data, name, kind == "tta")
                preds[name][kind].append(p.cpu().numpy())
        print(f"restored + evaluated {run_dir}", file=sys.stderr, flush=True)
    return preds


def tables(preds, d_values) -> Tuple[dict, dict]:
    """The example's per-arm rows (rounded to 1e-4) and, beside them, the
    same unrounded."""
    n_d = len(d_values)
    rounded, full = {}, {}
    for name in ARMS:
        rounded[name], full[name] = {}, {}
        for kind in ("plain", "tta"):
            member_mses = [error_table(p.reshape(n_d, -1), d_values)["mse"] for p in preds[name][kind]]
            ens = error_table(np.mean(preds[name][kind], axis=0).reshape(n_d, -1), d_values)
            full[name][kind] = {"member_mses": member_mses, "ensemble_mse": ens["mse"], "ensemble_std": ens["std"]}
            rounded[name][kind] = {"member_mses": [round(m, 4) for m in member_mses],
                                   "ensemble_mse": round(ens["mse"], 4), "ensemble_std": round(ens["std"], 4)}
    return rounded, full


def main(argv=None) -> dict:
    """Score the ensemble; returns ``seed_ensemble_report_full.json``'s
    content (the written report under ``report``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dirs", nargs="+", help="run directories containing final/")
    ap.add_argument("--seed", type=int, default=0, help="eval-render seed (shared across members)")
    ap.add_argument("--seqs-per-d", type=int, default=256)
    ap.add_argument("--out", default="results/torch_seed_ensemble")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    k1 = launch_counts()["render_frames"]
    exp = images_features.build(seed=args.seed, sequences_per_d=args.seqs_per_d, with_in_order=True, device=dev)
    exp.build()
    data = exp.in_order_data
    rounded, full = tables(member_predictions(exp, data, args.run_dirs), data["d_values"])

    report = {"members": len(args.run_dirs), "run_dirs": args.run_dirs, "seqs_per_d": args.seqs_per_d,
              "suite": "imft (reconciled 100-value)", **rounded}
    for name in ARMS:
        row = rounded[name]
        print(f"{name:16s} members {row['plain']['member_mses']} -> ensemble {row['plain']['ensemble_mse']} "
              f"(TTA {row['tta']['ensemble_mse']})", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"report": report, "arms": full, "seed": args.seed, "seconds": time.perf_counter() - t0,
           "card": card_line(dev), "k1_launches": launch_counts()["render_frames"] - k1}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "seed_ensemble_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    with open(os.path.join(args.out, "seed_ensemble_report_full.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(f"report -> {args.out}/seed_ensemble_report.json", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
