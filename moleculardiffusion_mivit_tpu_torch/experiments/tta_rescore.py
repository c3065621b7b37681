"""Rotation-TTA rescore of a trained images-features checkpoint.

Port of ``examples/tta_rescore.py``. The poster's image-arm rows are the
test-time-augmented variants (the mean prediction over 0/90/180/270°
rotations of the videos). This restores ``<RESULT_DIR>/final`` into an
``images_features`` experiment built with ``--seed`` and the in-order suite,
and scores the TTA tables of its four image arms on that suite's render
(``images_features.tta_error_tables``).

Run: python -m moleculardiffusion_mivit_tpu_torch.experiments.tta_rescore
     RESULT_DIR [--seed 0] [--seqs-per-d 64] [--device cuda|cpu]

It writes ``<RESULT_DIR>/tta_errors.csv`` with the example's columns
(``model,mse,std``; rows ``im_tr_rot``, ``im_res_rot``, ``im_ft_res_rot``,
``im_ft_tr_rot``) and, beside it, ``tta_report.json``: the TTA tables and the
plain tables of the same arms on the same render, unrounded, with the
seconds, the card and the K1 launches.

The outcome rules T1-T2, written before the runs on the card;
``rescore_outcome.py`` at the repository's root applies them to the committed
reports. The record is ``results/images_features_reconciled_scaled/
tta_errors.csv`` (JAX, one run): 0.5678 / 0.6406 / 0.4966 / 0.4554 for
``im_tr_rot`` / ``im_res_rot`` / ``im_ft_res_rot`` / ``im_ft_tr_rot``.

- Runs: ``RESULT_DIR`` = ``results/torch_images_features_seedS`` with
  ``--seed S`` (the run's own in-order render), S = 0…3, on the H100.
- T1: for each of the four rows, the record's draw J lies inside the four
  seeds' spread: |mean_P − J| ≤ max(0.03, 3·sd_P·sqrt(1 + 1/4)), sd_P with
  ``ddof=1``.
- T2, the TTA finding (``tta_report.json``, plain and TTA on one render):
  the TTA lowers ``im_resnet``'s and ``im_ft_resnet``'s MSE in at least 3 of
  the 4 seeds each, and |TTA − plain| ≤ 0.01 for ``im_ft_early_tr`` in every
  seed.
- A miss is logged as F8 or later in ROADMAP.md section 3, with its test. It
  is not tuned away, and no seed or render is added or swapped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.evaluation import error_table, save_error_table_csv
from moleculardiffusion_mivit_tpu_torch.experiments import images_features
from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line


def main(argv=None) -> dict:
    """Restore and rescore; returns ``tta_report.json``'s content."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("result_dir", help="run directory containing final/")
    ap.add_argument("--seed", type=int, default=0, help="the experiment's seed: its in-order render")
    ap.add_argument("--seqs-per-d", type=int, default=64)
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    k1 = launch_counts()["render_frames"]
    exp = images_features.build(seed=args.seed, sequences_per_d=args.seqs_per_d, with_in_order=True, device=dev)
    exp.build()
    restore_experiment(exp, os.path.join(args.result_dir, "final"))

    data = exp.in_order_data
    d_values = data["d_values"]
    tables = images_features.tta_error_tables(exp, data, d_values)
    plain = {name: error_table(images_features.arm_predictions(exp, data, name, False)
                               .reshape(len(d_values), -1).cpu().numpy(), d_values)
             for name, _ in images_features.TTA_ARMS}
    csv_path = os.path.join(args.result_dir, "tta_errors.csv")
    save_error_table_csv(tables, csv_path)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    report = {"tta": tables, "plain": plain, "seed": args.seed, "result_dir": args.result_dir,
              "seconds": time.perf_counter() - t0, "card": card_line(dev),
              "k1_launches": launch_counts()["render_frames"] - k1}
    with open(os.path.join(args.result_dir, "tta_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(tables, indent=2))
    print(f"TTA tables written to {csv_path}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
