"""The continuous-D training curriculum: one early-fusion MiViT on D ~
U(0.1, 8) a sequence.

Port of ``examples/continuous_d_training.py``. Instead of the reference's
few discrete D classes, every cycle draws ``--n`` sequences at D ~
U(d_low, d_high) each (``experiments.ensemble.generate`` with one member:
its streams, its one K1 launch a cycle) and trains the headline MiViT
(``ensemble.mivit``; ``--embed-dim`` and ``--layers`` change its width and
depth, the FFN at twice the width) through ``train.loop``'s step,
``make_train_impls(..., with_features=True)``, one ``Experiment`` arm: a
captured CUDA graph a step on the card, eager on the CPU. The schedule is
the example's (``ensemble.train_config``).

Evaluation: the example's line on the ``committed`` suite (the 70-value
``valTrajsInOrder`` set, the port's own draw) and the ``imft`` suite (JAX's
array, D = 0.1 … 10.0), both rendered from the stream ``(seed, 777)``;
the outcome rule C1 (in ``experiments/ensemble.py``'s docstring) reads
``imft``.

Run: python -m moleculardiffusion_mivit_tpu_torch.experiments.continuous_d
     [--cycles 150] [--n 256] [--d-low 0.1] [--d-high 8] [--embed-dim E]
     [--layers L] [--seed 0] [--out results/torch_continuous_d]
     [--device cuda|cpu]

Writes ``<out>/continuous_d_report.json`` (``committed`` and ``imft``:
``mse``, ``std``, ``mae``; ``imft``'s ``per_d_mse``; ``train_seconds``, the
seed, the card, the K1/K2/K3 launches) and ``<out>/continuous_d_full_report.json``
(unrounded per-D MSEs, each cycle's loss and end). Without ``--device`` it
runs on the card and raises on a machine without one.
"""

from __future__ import annotations

import argparse
import sys
import time

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.experiments import ensemble
from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line

EVAL_STREAM = 777


def main(argv=None) -> dict:
    """Train and score the model; returns ``{"report": the written report,
    ...}`` with the unrounded per-D MSEs, losses and seconds as in
    ``continuous_d_full_report.json``, and the trained ``experiment``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=150)
    ap.add_argument("--n", type=int, default=256, help="sequences per cycle")
    ap.add_argument("--d-low", type=float, default=0.1)
    ap.add_argument("--d-high", type=float, default=8.0)
    ap.add_argument("--embed-dim", type=int, default=None, help="override model width")
    ap.add_argument("--layers", type=int, default=None, help="override encoder depth")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/torch_continuous_d")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t_start = time.perf_counter()
    model_cfg = ensemble.MODEL_CONFIG
    if args.embed_dim:
        model_cfg = model_cfg.replace(embed_dim=args.embed_dim, hidden_dim=2 * args.embed_dim)
    if args.layers:
        model_cfg = model_cfg.replace(num_layers=args.layers)
    exp = ensemble.build(args.seed, 0, args.n, "continuous", (args.d_low, args.d_high), model_cfg=model_cfg,
                         device=dev)
    exp.build()
    counts0 = launch_counts()
    marks, train_s = ensemble.train(exp, args.cycles, dev)
    print(f"trained in {train_s:.0f}s", flush=True)
    trained = ensemble.launches_since(counts0, [exp.engine])

    t0 = time.perf_counter()
    counts0 = launch_counts()
    report = {"cycles": args.cycles, "n": args.n, "d_range": [args.d_low, args.d_high],
              "embed_dim": model_cfg.embed_dim, "layers": model_cfg.num_layers,
              "train_seconds": round(train_s, 1), "seed": args.seed}
    per_d = {}
    for suite, (data, d_values) in ensemble.suites(exp.train_cfg, exp.optics, dev, ("committed", "imft"),
                                                   EVAL_STREAM).items():
        table, full = ensemble.suite_tables(ensemble.member_preds(exp, data["videos"], data["features"], False),
                                            d_values)
        report[suite] = {"mse": table["ensemble_mse"], "std": table["ensemble_std"], "mae": table["ensemble_mae"],
                         "per_d_mse": table["per_d_mse"], "d_values": table["d_values"]}
        per_d[suite] = full["per_d_mse"]
    eval_s = time.perf_counter() - t0
    c = report["committed"]
    print(f"in-order MiViT (continuous-D curriculum): mse={c['mse']:.4f} std={c['std']:.4f} mae={c['mae']:.4f}")
    print(f"imft suite: mse={report['imft']['mse']:.4f}", flush=True)
    report.update(card=card_line(dev), launches={"train": trained, "eval": ensemble.launches_since(counts0)})
    full = {"seed": args.seed, "per_d_mse": per_d, "train_loss": [float(v) for v in exp.train_loss["mivit"]],
            "cycle_end_s": marks, "train_s": train_s, "eval_s": eval_s, "seconds": time.perf_counter() - t_start,
            "argv": list(sys.argv[1:] if argv is None else argv)}
    ensemble.write(args.out, "continuous_d", report, full)
    return {"report": report, **full, "experiment": exp}


if __name__ == "__main__":
    main()
