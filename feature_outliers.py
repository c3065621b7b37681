#!/usr/bin/env python3
"""The 25 trajectory features of the images-features experiment's training
cycles, searched for outliers, on one NVIDIA GPU.

Usage: ``python3 feature_outliers.py [--seed 0] [--cycles 90 100]
[--out PATH]`` from the root of a checkout with a CUDA card. For each cycle
in ``[first, last)`` it regenerates the cycle's data exactly as
``Experiment.run`` does (the stream ``(seed + 1, cycle, 0)``), without
training, and prints one JSON line: the number of non-finite features, and
every feature whose value lies more than ``Z`` median absolute deviations
(or, for a feature that is mostly one value, standard deviations) from the
cycle's median, with the
sequence, its value, the median and the sequence's true D. ``--out`` saves
the cycles' trajectories, features and labels (``.npz``) so the same rows
can be put through the JAX package's features on another machine.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXPERIMENT = "images_features"
Z = 50.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cycles", type=int, nargs=2, default=(90, 100), metavar=("FIRST", "END"))
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("feature_outliers: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    from moleculardiffusion_mivit_tpu_torch.experiments import get_experiment
    from moleculardiffusion_mivit_tpu_torch.features import FEATURE_NAMES
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    exp = get_experiment(EXPERIMENT, seed=args.seed, device="cuda")
    d_max = exp.train_cfg.d_max_normalization
    saved = {}
    for cycle in range(*args.cycles):
        data = exp.generate_fn(seeded_generator("cuda", args.seed + 1, cycle, 0))
        f = data["features"].cpu().numpy()
        d_true = data["labels"].cpu().numpy()[:, 0] * d_max
        med = np.nanmedian(f, axis=0)
        mad = np.nanmedian(np.abs(f - med), axis=0)
        far = {}
        for i, name in enumerate(FEATURE_NAMES):
            # a feature that is mostly one value (MAD 0) is scaled by its spread
            scale = float(mad[i]) or float(np.nanstd(f[:, i]))
            if scale == 0.0:
                continue
            for row in np.flatnonzero(np.abs(f[:, i] - med[i]) / scale > Z):
                far.setdefault(name, []).append({"sequence": int(row), "value": float(f[row, i]),
                                                 "median": float(med[i]), "d_true": float(d_true[row])})
        print(json.dumps({"experiment": EXPERIMENT, "seed": args.seed, "cycle": cycle,
                          "non_finite": int((~np.isfinite(f)).sum()), "beyond_z": far}), flush=True)
        saved.update({f"trajs_avg_{cycle}": data["trajs_avg"].cpu().numpy(), f"features_{cycle}": f,
                      f"d_true_{cycle}": d_true})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.out, **saved)


if __name__ == "__main__":
    main()
