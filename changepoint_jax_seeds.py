#!/usr/bin/env python3
"""JAX's seeds of the continuous-curriculum change-point demo (C1 in the
docstring of ``moleculardiffusion_mivit_tpu_torch/evaluation/changepoint_study.py``),
on the CPU.

For each seed k, ``examples/sequence_changepoint_demo.py`` under JAX with
its model, ``deepcnn_2layer_s``, the experiment's only arm (an arm's result
depends only on its own keys and the cycle's shared data, so this is one
fair draw of that arm's distribution), built at seed k (k = 0 gives the
example's keys), then the example's own training loop and evaluation (key
777, 64 a class). Writes under ``--out``:

- ``jax_cut{cycles}_{continuous,discrete}_seed{k}.json``: the example's
  report, the seed, the seconds, ``const_frame_sd`` of the predictions on
  the constant-D controls and the SHA-256 of the evaluation set;
- ``…_seed{k}_preds.npz``: the example's three predictions, ``(N, 30)`` in
  D units: ``mixed`` (the planted set), ``const`` (its controls), ``cal``
  (the calibration split);
- ``build/jax_eval_set_key777.npz`` (not committed), once: the example's evaluation set, the videos and labels
  of those three calls, so that the port can score JAX's own set
  (``changepoint_shared_eval.py``). A seed whose set differs from the file
  stops.

``changepoint_outcome.py`` judges the seed files.

Usage: ``python3 changepoint_jax_seeds.py --jax-seeds N [--first-jax-seed K]
[--cycles 10] [--continuous 0.1,8] [--out results/changepoint_outcome]``.
One process a seed runs seeds side by side, each under ``taskset`` on two
cores. ``--eval-set-only`` writes the evaluation set from a one-cycle run
at 2 sequences a class (the set does not depend on the training).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from changepoint_outcome import eval_set_digest

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "results" / "changepoint_outcome"
DEMO_MODEL = "deepcnn_2layer_s"
DEMO_FILE = "changepoint_metrics.json"
EVAL_SET_DIR = ROOT / "build"
EVAL_SET = "jax_eval_set_key777.npz"
PRED_SETS = ("mixed", "const", "cal")  # the order in which the example predicts


def _demo_example():
    spec = importlib.util.spec_from_file_location("changepoint_demo_example",
                                                  ROOT / "examples" / "sequence_changepoint_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def const_frame_sd(preds) -> float:
    """The mean over constant-D sequences of the sd (ddof 1) of each one's
    per-frame predictions ``(N, F)``, in D units."""
    p = np.asarray(preds, dtype=np.float64).reshape(len(preds), -1)
    return float(p.std(axis=1, ddof=1).mean())


def jax_demo_seed(k: int, cycles: int, continuous: str | None, seqs_per_d: int = 64) -> dict:
    """``examples/sequence_changepoint_demo.py`` under JAX with its model
    (``deepcnn_2layer_s``) the experiment's only arm, at seed ``k``: the
    baseline experiment built with ``seed=k`` and ``exp.build(key(k))`` (k =
    0 gives the example's keys), then the example's own ``main`` (its
    ``--cycles``, ``--seqs-per-d``, ``--continuous``, its training loop and
    its evaluation: key 777, 64 a class) on that experiment. Returns the
    example's report with the seed, the seconds (build, training, all),
    each validation's time, ``const_frame_sd`` of its predictions on the
    constant-D controls and the evaluation set's digest; under
    ``"arrays"``, not for JSON, the three predictions and the evaluation
    set.

    Only the example's own three ``predict`` calls, after ``run`` returns,
    are recorded: ``run`` itself predicts the validation set through
    ``self.predict`` at its last cycle."""
    import jax

    import moleculardiffusion_mivit_tpu.experiments as jexperiments
    from moleculardiffusion_mivit_tpu.experiments import baseline

    ex = _demo_example()
    t0 = time.perf_counter()
    d_range = tuple(float(x) for x in continuous.split(",")) if continuous else None
    exp = baseline.build(seed=k, sequences=True, continuous_d=d_range, sequences_per_d=seqs_per_d)
    exp.arms = {DEMO_MODEL: exp.arms[DEMO_MODEL]}
    exp.build(jax.random.key(k))
    built_s = time.perf_counter() - t0
    exp.build = lambda key=None: None
    marks, calls = [], []
    run, predict = exp.run, exp.predict

    def recording(name, data):
        out = predict(name, data)
        calls.append((np.asarray(out)[..., 0], {key: np.asarray(v) for key, v in data.items()}))
        return out

    def timed_run(*a, callback=None, **kw):
        def mark(c, avgs):
            marks.append({"cycle": c, "t": time.perf_counter() - t0, "val_avg": avgs})
            if callback:
                callback(c, avgs)

        t_run = time.perf_counter()
        out = run(*a, callback=mark, **kw)
        marks.append({"train_s": time.perf_counter() - t_run})
        exp.predict = recording
        return out

    exp.run = timed_run

    def get_experiment(name, **kw):
        if name != "baseline" or kw != dict(sequences=True, continuous_d=d_range, sequences_per_d=seqs_per_d):
            raise RuntimeError(f"the example asked for {name} {kw}, not the experiment built here")
        return exp

    argv = ["sequence_changepoint_demo.py", "--cycles", str(cycles), "--seqs-per-d", str(seqs_per_d)]
    argv += ["--continuous", continuous] if continuous else []
    saved = jexperiments.get_experiment, sys.argv
    with tempfile.TemporaryDirectory() as tmp:
        jexperiments.get_experiment, sys.argv = get_experiment, argv + ["--out", tmp]
        try:
            ex.main()
        finally:
            jexperiments.get_experiment, sys.argv = saved
        report = json.loads((Path(tmp) / DEMO_FILE).read_text())
    if len(calls) != len(PRED_SETS):
        raise RuntimeError(f"the example predicted {len(calls)} sets after training, not {len(PRED_SETS)}")
    preds = {name: p for name, (p, _) in zip(PRED_SETS, calls)}
    eval_set = {f"{name}_{key}": v for name, (_, data) in zip(PRED_SETS, calls) for key, v in data.items()}
    command = ["python3 changepoint_jax_seeds.py --jax-seeds 1 --first-jax-seed", str(k), "--cycles", str(cycles)]
    return {"report": report, "seed": k, "const_frame_sd": const_frame_sd(preds["const"]),
            "eval_set_sha256": eval_set_digest(eval_set), "built_s": built_s,
            "train_s": marks[-1]["train_s"], "validations": marks[:-1], "seconds": time.perf_counter() - t0,
            "command": " ".join(command + (["--continuous", continuous] if continuous else [])),
            "arrays": {"preds": preds, "eval_set": eval_set}}


def keep_eval_set(eval_set: dict, directory: Path) -> Path:
    """Write the evaluation set to ``directory/EVAL_SET`` if it is not there;
    if it is, raise unless it holds the same arrays."""
    path = directory / EVAL_SET
    if path.exists():
        with np.load(path) as kept:
            if eval_set_digest(dict(kept)) != eval_set_digest(eval_set):
                raise RuntimeError(f"this run's evaluation set differs from {path}")
    else:
        directory.mkdir(parents=True, exist_ok=True)
        np.savez(path, **eval_set)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--jax-seeds", type=int, default=1, help="run this many seeds of the demo's arm alone")
    ap.add_argument("--first-jax-seed", type=int, default=1, help="the first seed (0 is the record's key)")
    ap.add_argument("--cycles", type=int, default=10, help="training cycles")
    ap.add_argument("--continuous", default=None, metavar="LO,HI", help="the continuous curriculum")
    ap.add_argument("--eval-set-only", action="store_true",
                    help="write the evaluation set from one cycle at 2 sequences a class, and no seed file")
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    curriculum = "continuous" if args.continuous else "discrete"
    if args.eval_set_only:
        seed = jax_demo_seed(args.first_jax_seed, 1, args.continuous, seqs_per_d=2)
        path = keep_eval_set(seed["arrays"]["eval_set"], EVAL_SET_DIR)
        print(f"{path}: sha256 {seed['eval_set_sha256']}", flush=True)
        return 0
    for k in range(args.first_jax_seed, args.first_jax_seed + args.jax_seeds):
        seed = jax_demo_seed(k, args.cycles, args.continuous)
        arrays = seed.pop("arrays")
        keep_eval_set(arrays["eval_set"], EVAL_SET_DIR)
        stem = out / f"jax_cut{args.cycles}_{curriculum}_seed{k}"
        np.savez_compressed(f"{stem}_preds.npz", **arrays["preds"])
        Path(f"{stem}.json").write_text(json.dumps(seed, indent=1) + "\n")
        print(f"{stem}.json: roc_auc {seed['report']['roc_auc']} in {seed['seconds']:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
