#!/usr/bin/env python3
"""The port's C1 seeds of the change-point demo scored on JAX's own
evaluation set as well as on the port's.

Each side of C1 (the docstring of
``moleculardiffusion_mivit_tpu_torch/evaluation/changepoint_study.py``)
scores every one of its seeds on one evaluation set, its own draw from the
stream 777, so that draw is shared within a side and differs between them.
This script takes it out of the comparison: for each curriculum and seed
S it trains the demo as C1 does (``changepoint_study demo --cycles 10
--seqs-per-d 64 --seed S [--continuous 0.1,8]``), scores the port's own set
as the demo does, then scores the videos and labels that the JAX example
predicted (``build/jax_eval_set_key777.npz``, written by
``changepoint_jax_seeds.py``: its planted set, controls and calibration
split) with the same ``score_planted``. JAX's seeds on that set are
``results/changepoint_outcome/jax_cut10_*_seed*.json``.

Writes ``port_cut10_{continuous,discrete}_seedS.json`` under ``--out``: the
seed, the card, both sets' example fields, ``const_frame_sd`` on both
sets' controls, the JAX set's SHA-256, the seconds. ``changepoint_outcome.py``
reports them beside JAX's seeds.

Usage: ``python3 changepoint_shared_eval.py [--seeds 0-7]
[--out results/changepoint_outcome/shared_eval] [--device cuda|cpu]``.
Without ``--device`` it runs on the card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from changepoint_outcome import CURRICULA, CUT_CYCLES, OUT, eval_set_digest

ROOT = Path(__file__).resolve().parent
EVAL_SET = ROOT / "build" / "jax_eval_set_key777.npz"
SEQS_PER_D = 64
CONTINUOUS = "0.1,8"


def _seeds(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def score_on(exp, model: str, eval_set: dict, d_max: float, device) -> dict:
    """``score_planted`` of ``model``'s per-frame predictions on a set of
    ``changepoint_jax_seeds.PRED_SETS`` arrays, with ``const_frame_sd``."""
    import torch

    from moleculardiffusion_mivit_tpu_torch.evaluation.changepoint import score_planted
    from moleculardiffusion_mivit_tpu_torch.evaluation.changepoint_study import const_frame_sd

    def predict(name):
        data = {k: torch.as_tensor(eval_set[f"{name}_{k}"], device=device) for k in ("videos", "labels")}
        return exp.predict(model, data)[..., 0]

    mixed, const, cal = (predict(n) for n in ("mixed", "const", "cal"))
    mixed_labels = torch.as_tensor(eval_set["mixed_labels"], device=device)
    return {"scored": score_planted(mixed, const, cal, mixed_labels * d_max), "const_frame_sd": const_frame_sd(const)}


def shared_seed(curriculum: str, seed: int, eval_set: dict, device=None, cycles: int = CUT_CYCLES,
                seqs_per_d: int = SEQS_PER_D) -> dict:
    """One C1 run of the port's demo, scored on its own set and on
    ``eval_set``."""
    from moleculardiffusion_mivit_tpu_torch.evaluation.changepoint import DEMO_FIELDS, select_fields
    from moleculardiffusion_mivit_tpu_torch.evaluation.changepoint_study import main as study

    argv = ["demo", "--cycles", str(cycles), "--seqs-per-d", str(seqs_per_d), "--seed", str(seed)]
    argv += ["--continuous", CONTINUOUS] if curriculum == "continuous" else []
    argv += ["--device", device] if device else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run = study(argv + ["--out", tmp])
    exp = run["experiment"]
    model = run["report"]["model"]
    shared = score_on(exp, model, eval_set, exp.train_cfg.d_max_normalization, exp.device)
    return {"curriculum": curriculum, "seed": seed, "model": model, "card": run["card"],
            "own_set": run["report"], "own_set_const_frame_sd": run["const_frame_sd"],
            "jax_set": select_fields(shared["scored"], DEMO_FIELDS), "jax_set_const_frame_sd": shared["const_frame_sd"],
            "jax_set_sha256": eval_set_digest(eval_set), "train_s": run["train_s"],
            "seconds": time.perf_counter() - t0,
            "command": f"python3 changepoint_shared_eval.py --seeds {seed}" + (f" --device {device}" if device else "")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0-7", help="a seed or a range LO-HI")
    ap.add_argument("--out", default=str(OUT / "shared_eval"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    with np.load(EVAL_SET) as f:
        eval_set = dict(f)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for seed in _seeds(args.seeds):
        for curriculum in CURRICULA:
            r = shared_seed(curriculum, seed, eval_set, args.device)
            path = out / f"port_cut{CUT_CYCLES}_{curriculum}_seed{seed}.json"
            path.write_text(json.dumps(r, indent=1) + "\n")
            print(f"{path.name}: roc_auc own {r['own_set']['roc_auc']} jax set {r['jax_set']['roc_auc']} "
                  f"train {r['train_s']:.1f}s all {r['seconds']:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
