"""MSD-baseline protocol reconciliation: which in-order suite gives the
published MSD rows.

Port of ``examples/msd_protocol_reconciliation.py``. The poster's classical
MSD rows (MSD Frame 1.326 ± 0.288, MSD Localized 1.385 ± 0.292, MSD Perfect
0.115 ± 0.085) train nothing: they are MSD(τ=1) × the calibration (250 on raw
sub-positions, 37.5 frame-averaged) × D_max, scored on an in-order D sweep.
This scores the estimator on five suites and reports which reproduces the
published rows: the 70-value ``committed`` set (300 steps, D ≤ 7.0), the
100-value ``imft`` suite at 300 steps (and its first 70 D values), and its
200-step variant (and its first 70). The ``imft`` suites are the JAX
package's own arrays (``evaluation.generate_in_order_imft``, t_steps 300 or
200); the ``committed`` set is the port's own draw
(``load_validation_trajectories``), so its row is reported and not judged.
``MSD_Localized`` adds N(0, 0.01) localisation noise from the stream
``fold_in((4242), i)`` of suite ``i``: a torch draw, equal to JAX's in
distribution only.

Run: python -m moleculardiffusion_mivit_tpu_torch.evaluation.msd_protocol
     [--out results/torch_msd_protocol] [--device cuda|cpu]

It prints the example's table and its "closest protocol per arm" lines, and
writes ``<out>/msd_protocol_report.json``: each suite's label and three rows
(mse, std, mae) unrounded, the closest suite per arm with its |Δ|, the
seconds and the card.

The outcome rule M1, written before the runs on the card;
``rescore_outcome.py`` applies it to the committed report against JAX's rows
(``results/torch_msd_protocol/jax_rows.json``, made by the command in
``tests/test_torch_rescore.py``):

- M1: on the four regenerated suites, ``MSD_Perfect`` and ``MSD_Frame``
  (mse and std) equal JAX's to 1e-5 (relative), and the closest protocol of
  each of the three arms is the 100-value 300-step suite.
- A miss is logged as F8 or later in ROADMAP.md section 3, with its test.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.evaluation.validation import (
    IN_ORDER_D_VALUES,
    IN_ORDER_IMFT_D_VALUES,
    error_table,
    generate_in_order_imft,
    load_validation_trajectories,
)
from moleculardiffusion_mivit_tpu_torch.features import d_from_msd_tau1
from moleculardiffusion_mivit_tpu_torch.sim.trajectory import average_trajectories_frames
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

P = 10  # sub-positions a frame
DIV = 100.0  # traj_div_factor
DMAX = 10.0  # D_max_normalization
PUBLISHED = {
    "MSD_Perfect": (0.1148, 0.0847),
    "MSD_Frame": (1.3263, 0.2879),
    "MSD_Localized": (1.3853, 0.2922),
}
# the example's tag on a row within this distance of the published mse
MATCH = 0.12
NOISE_STREAM = 4242


def msd_tables(trajs_grid: np.ndarray, d_values: np.ndarray, generator: torch.Generator) -> Dict[str, dict]:
    """The three MSD arms scored the poster way on one trajectory suite
    ``(n_d, n_p, T, 2)`` (trajectory units), on the generator's device; the
    localisation noise is drawn from ``generator``."""
    n_d, n_p, t, _ = trajs_grid.shape
    flat = torch.as_tensor(np.asarray(trajs_grid).reshape(n_d * n_p, t, 2), dtype=torch.float32,
                           device=generator.device) / DIV
    avg = average_trajectories_frames(flat, P)
    noise = 0.01 * torch.randn(avg.shape, generator=generator, device=generator.device)
    out = {}
    for name, trajs, fact in (("MSD_Perfect", flat, 250.0), ("MSD_Frame", avg, 37.5),
                              ("MSD_Localized", avg + noise, 37.5)):
        preds = d_from_msd_tau1(trajs) * fact * DMAX
        out[name] = error_table(preds.reshape(n_d, n_p).cpu().numpy(), d_values)
    return out


def suites(device) -> list:
    """The five suites ``(label, grid, d_values)``, in the example's order."""
    committed = load_validation_trajectories(device=device)["valTrajsInOrder"]  # (70, 10, 300, 2)
    regen_300 = generate_in_order_imft(t_steps=300)  # (100, 10, 300, 2), D 0.1..10
    regen_200 = generate_in_order_imft(t_steps=200)  # the 20-frame variant
    return [
        ("committed asset, 70 D (0.1-7.0), 300 steps [RESULTS.md round-1 protocol]", committed, IN_ORDER_D_VALUES),
        ("regenerated,     70 D (0.1-7.0), 300 steps [generator sanity check]", regen_300[:70],
         IN_ORDER_IMFT_D_VALUES[:70]),
        ("regenerated,    100 D (0.1-10.0), 300 steps [reference val_d_in_order]", regen_300, IN_ORDER_IMFT_D_VALUES),
        ("regenerated,     70 D (0.1-7.0), 200 steps (20 frames)", regen_200[:70], IN_ORDER_IMFT_D_VALUES[:70]),
        ("regenerated,    100 D (0.1-10.0), 200 steps (20 frames)", regen_200, IN_ORDER_IMFT_D_VALUES),
    ]


def main(argv=None) -> dict:
    """Score every suite; returns the written report."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_msd_protocol")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    key = seeded_generator(dev, NOISE_STREAM)

    print(f"{'suite':68s}  {'arm':14s} {'mse':>7s} {'std':>6s}   published")
    rows, best = [], {}
    for i, (label, grid, d_values) in enumerate(suites(dev)):
        tables = msd_tables(np.asarray(grid), np.asarray(d_values), fold_in(key, i))
        rows.append({"suite": label, "tables": tables})
        for arm, tab in tables.items():
            pub_mse, pub_std = PUBLISHED[arm]
            delta = abs(tab["mse"] - pub_mse)
            tag = " <-- matches published" if delta < MATCH else ""
            if arm not in best or delta < best[arm]["delta"]:
                best[arm] = {"delta": delta, "suite": label, "mse": tab["mse"]}
            print(f"{label:68s}  {arm:14s} {tab['mse']:7.3f} {tab['std']:6.3f}   {pub_mse:.3f}±{pub_std:.3f}{tag}")
        print()
    print("closest protocol per arm:")
    for arm, b in best.items():
        print(f"  {arm:14s}: {b['suite']}  (mse {b['mse']:.3f}, |Δ| {b['delta']:.3f})")
    report = {"suites": rows, "closest": best, "published": PUBLISHED,
              "seconds": time.perf_counter() - t0, "card": card_line(dev)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "msd_protocol_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
