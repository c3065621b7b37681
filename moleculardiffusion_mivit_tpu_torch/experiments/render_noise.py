"""How much of an in-order score is the render draw?

Port of ``examples/render_noise_study.py``. The published in-order suite's
trajectories are fixed (``evaluation.generate_in_order_imft``, the JAX
package's own array), but every run renders them with fresh optics noise. This
study restores K trained ``images_features`` checkpoints and scores ONE arm on
R distinct renders of the identical trajectories: the K×R MSE matrix and its
variance decomposition (the σ across seeds at a fixed render against the σ
across renders of the seed mean), and the K-seed prediction ensemble scored
per render.

Renders: R renders of the suite ``(1,000, 300, 2)`` divided by
``traj_div_factor``, render ``r`` made as ``images_features.make_dataset``
makes one from the generator ``(0, RENDER_STREAM + r)``, ``RENDER_STREAM`` =
2**21 (JAX: ``fold_in(key(0), 2**21 + r)``). That namespace is apart from
every training, validation and in-order stream of the experiment
(``tests/test_torch_rescore.py`` checks it). All R renders go through K1 in
one launch (``images_features.make_datasets``), each with its own draws;
their features are computed once (they depend on the trajectories alone).

Run: python -m moleculardiffusion_mivit_tpu_torch.experiments.render_noise
     RUN_DIR [RUN_DIR ...] [--arm im_ft_early_tr] [--renders 5]
     [--seqs-per-d 256] [--out results/torch_render_noise] [--device cuda|cpu]

It writes ``<out>/render_noise_report.json`` with the example's keys and
rounding (``mse_matrix_seed_x_render``, ``per_render_seed_mean``,
``seed_sigma_at_fixed_render``, ``render_sigma_of_seed_mean``,
``grand_mean``, ``ensemble_mse_per_render``, ``ensemble_render_mean``,
``ensemble_render_std``; σs with ``ddof=1``) and, unrounded beside it,
``render_noise_report_full.json`` with the seconds, the card and the K1
launches.

The outcome rules R1-R2, written before the runs on the card;
``rescore_outcome.py`` at the repository's root applies them to the committed
reports. The record is ``results/render_noise`` (JAX, four seeds × five
renders: grand mean 0.4803, render σ of the seed mean 0.011, seed σ at a fixed
render 0.0022, ensemble 0.4768 ± 0.011).

- Run: ``--renders 5`` over ``results/torch_images_features_seed0-3``
  (``run_experiment images_features --seed S --cycles 150 --seqs-per-d 256
  --in-order``, f32, on the H100), one call on the card.
- R1, the grand mean: |grand_P − 0.4803| ≤ max(0.02, 3·sqrt(s_P²/5 +
  0.011²/5)), s_P the port's ``render_sigma_of_seed_mean``. The same for the
  ensemble: |``ensemble_render_mean``_P − 0.4768| ≤ max(0.02,
  3·sqrt(e_P²/5 + 0.011²/5)), e_P the port's ``ensemble_render_std``.
- R2, the decomposition: in the port ``render_sigma_of_seed_mean`` >
  ``seed_sigma_at_fixed_render``; render_σ_P² / 0.011² inside the two-sided
  F(4, 4) band at level 0.05, [0.1041, 9.6045]; seed_σ_P² / 0.0022² inside
  the F(3, 3) band at level 0.05, [0.06477, 15.439] (scipy's quantiles, as
  ``sim2real_outcome.spread_band``).
- A miss is logged as F8 or later in ROADMAP.md section 3, with its test. It
  is not tuned away, and no seed or render is added or swapped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Sequence

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.evaluation import IN_ORDER_IMFT_D_VALUES, error_table, generate_in_order_imft
from moleculardiffusion_mivit_tpu_torch.experiments import images_features
from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

RENDER_STREAM = 2**21


def render_generators(device, renders: int) -> List[torch.Generator]:
    """Render ``r``'s generator: the stream ``(0, RENDER_STREAM + r)``."""
    return [seeded_generator(device, 0, RENDER_STREAM + r) for r in range(renders)]


def make_renders(exp, renders: int) -> list:
    """``renders`` renders of the published suite for ``exp``'s
    configuration (``images_features.make_datasets``: one K1 launch), without
    labels."""
    cfg = exp.train_cfg
    arr = generate_in_order_imft(t_steps=cfg.n_frames * cfg.n_pos_per_frame)
    flat = torch.as_tensor(arr, dtype=torch.float32, device=exp.device)
    flat = flat.reshape((-1,) + tuple(flat.shape[2:])) / cfg.traj_div_factor
    out = images_features.make_datasets(render_generators(exp.device, renders), flat, cfg, exp.optics)
    for data in out:
        data["labels"] = None
    return out


def score(exp, renders: Sequence[dict], run_dirs: Sequence[str], arm: str, d_values) -> dict:
    """The K×R matrix of ``arm``'s MSEs (checkpoints × renders), the
    variance decomposition and the per-render K-seed ensemble, unrounded,
    with the example's formulas."""
    n_d = len(d_values)
    mse = np.zeros((len(run_dirs), len(renders)))
    preds = np.zeros((len(run_dirs), len(renders), len(renders[0]["videos"])), dtype=np.float32)
    for i, run_dir in enumerate(run_dirs):
        restore_experiment(exp, os.path.join(run_dir, "final"))
        for r, data in enumerate(renders):
            preds[i, r] = images_features.arm_predictions(exp, data, arm, False).cpu().numpy()
            mse[i, r] = error_table(preds[i, r].reshape(n_d, -1), d_values)["mse"]
        print(f"{run_dir}: {np.round(mse[i], 4).tolist()}", flush=True)
    ens = [error_table(preds[:, r].mean(axis=0).reshape(n_d, -1), d_values)["mse"] for r in range(len(renders))]
    return {
        "mse_matrix_seed_x_render": mse.tolist(),
        "per_render_seed_mean": mse.mean(axis=0).tolist(),
        # across seeds at a fixed render, then across renders of the seed mean
        "seed_sigma_at_fixed_render": float(mse.std(axis=0, ddof=1).mean()),
        "render_sigma_of_seed_mean": float(mse.mean(axis=0).std(ddof=1)),
        "grand_mean": float(mse.mean()),
        # the K-seed prediction ensemble scored per render
        "ensemble_mse_per_render": ens,
        "ensemble_render_mean": float(np.mean(ens)),
        "ensemble_render_std": float(np.std(ens, ddof=1)),
    }


def rounded(full: dict) -> dict:
    """The example's rounding: every number to 1e-4."""
    def r(v):
        return [r(x) for x in v] if isinstance(v, list) else round(v, 4)

    return {k: r(v) for k, v in full.items()}


def main(argv=None) -> dict:
    """Run the study; returns ``render_noise_report_full.json``'s content
    (the written report under ``report``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dirs", nargs="+")
    ap.add_argument("--arm", default="im_ft_early_tr")
    ap.add_argument("--renders", type=int, default=5)
    ap.add_argument("--seqs-per-d", type=int, default=256)
    ap.add_argument("--out", default="results/torch_render_noise")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    exp = images_features.build(seed=0, sequences_per_d=args.seqs_per_d, device=dev)
    exp.build()
    k1 = launch_counts()["render_frames"]
    renders = make_renders(exp, args.renders)
    k1 = launch_counts()["render_frames"] - k1
    full = score(exp, renders, args.run_dirs, args.arm, IN_ORDER_IMFT_D_VALUES)
    report = {"arm": args.arm, "run_dirs": args.run_dirs, **rounded(full)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = {"report": report, **full, "renders": args.renders, "seconds": time.perf_counter() - t0,
           "card": card_line(dev), "k1_launches_renders": k1}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "render_noise_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    with open(os.path.join(args.out, "render_noise_report_full.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(report, indent=2))
    print(f"report -> {args.out}/render_noise_report.json", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
