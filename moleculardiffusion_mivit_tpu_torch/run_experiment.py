"""CLI experiment runner.

Usage:
    python -m moleculardiffusion_mivit_tpu_torch.run_experiment baseline \
        --cycles 100 --out results/baseline [--seed 0] [--seqs-per-d 64] [--device cuda]
    python -m moleculardiffusion_mivit_tpu_torch.run_experiment images_features \
        --cycles 100 --in-order [--in-order-suite imft|committed]
    python -m moleculardiffusion_mivit_tpu_torch.run_experiment modular \
        --cycles 100 --in-order [--with-hybrid]
    python -m moleculardiffusion_mivit_tpu_torch.run_experiment embeddings|framerate --cycles 100
    python -m moleculardiffusion_mivit_tpu_torch.run_experiment psfnoise --cycles 100 --in-order
    python -m moleculardiffusion_mivit_tpu_torch.run_experiment denoising --cycles 100 --seqs-per-d 128
    python -m moleculardiffusion_mivit_tpu_torch.run_experiment baseline --cycles 100 --plots
    torchrun --nproc-per-node 4 -m moleculardiffusion_mivit_tpu_torch.run_experiment psfnoise \
        --mesh data=2,model=2 --cycles 100

Port of ``moleculardiffusion_mivit_tpu/run_experiment.py``: runs the named
experiment on ``--device`` (CUDA by default; without a card it raises unless
``--device cpu`` is given), streams events to ``<out>/metrics.jsonl`` and
stderr (``start``, ``built``, ``resumed``, ``cycle``, ``trained``,
``final_val_avg``, ``error_tables``), checkpoints the last cycles, and writes
``history.json``, ``final/``, and, where the experiment has an in-order
sweep, ``<experiment>_errors.csv`` and ``in_order_predictions.npz``.
``--plots`` renders ``evaluation.plots.render_all`` into ``<out>/figures``
after the run and logs a ``figures`` event; it needs matplotlib, and the
command line raises when it parses ``--plots`` on a machine where
matplotlib does not import, before anything is built.
``--in-order`` applies to the experiments that offer the option; framerate
is rescored on the in-order suite from its checkpoint, by
``python -m moleculardiffusion_mivit_tpu_torch.experiments.framerate --ckpt
<out>/final``.

``--mesh data=D,model=M`` trains on a mesh of ``D · M`` ranks
(``Experiment.use_mesh``), one process a rank started by ``torchrun``
(``python -m torch.distributed.run``), which gives each its address, world
size and rank: on the card each rank takes ``cuda:LOCAL_RANK`` and NCCL,
with ``--device cpu`` gloo. Rank 0 alone writes the files and the events.

Not offered: ``--no-aot-cache`` and ``--unroll`` (TPU-only).
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time


def main(argv=None):
    """Run the command line ``argv``; returns the trained ``Experiment``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("experiment",
                    help="baseline | images_features | modular | embeddings | framerate | psfnoise | denoising")
    ap.add_argument("--cycles", type=int, default=None, help="override num_cycles")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seqs-per-d", type=int, default=64)
    ap.add_argument("--out", type=str, default=None, help="output directory")
    ap.add_argument("--checkpoint-last", type=int, default=5)
    ap.add_argument("--eval-every", type=int, default=1)
    ap.add_argument("--in-order", action="store_true",
                    help="build the in-order D sweep where the experiment makes it optional")
    ap.add_argument("--in-order-suite", choices=("imft", "committed"), default=None,
                    help="(images_features, modular, psfnoise) the in-order sweep to score: imft, the published 100-value "
                         "D=0.1..10.0 protocol (default), or committed, the 70-value valTrajsInOrder set; "
                         "implies --in-order")
    ap.add_argument("--in-order-renders", type=int, default=1,
                    help="score the in-order sweep on K render-noise draws of the same trajectories")
    ap.add_argument("--with-hybrid", action="store_true",
                    help="(modular) add HybridFusionTransformer (per-frame feature tokens and the global "
                         "features in one model, fused by concat_proj and by add) and its early-fusion "
                         "GeneralTransformer parent, trained on the same data as the five modular arms")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default=None,
                    help="forward/backward precision (TrainConfig.compute_dtype): bfloat16 casts the parameters and "
                         "inputs inside each step and keeps f32 master parameters, AdamW state, BatchNorm statistics "
                         "and evaluation; the deep-ResNet arms then run K2-bf16/K3-bf16. Default float32")
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint directory (e.g. <out>/final) to restore and continue from")
    ap.add_argument("--no-stack-pairs", action="store_true",
                    help="step the activation-slope pairs as separate units (Experiment.stack_pairs)")
    ap.add_argument("--plots", action="store_true",
                    help="render the figures (val-MSE curves, error bars and violins, prediction-vs-D, PSF×noise "
                         "heatmaps) into <out>/figures after the run; needs matplotlib")
    ap.add_argument("--mesh", type=str, default=None,
                    help="train on a mesh of ranks under torchrun, e.g. 'data=2,model=4': grid arms split their "
                         "members over 'model' and each member's batch over 'data'; single-model arms keep every "
                         "parameter and split the batch over every rank")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.plots:
        from moleculardiffusion_mivit_tpu_torch.evaluation.plots import require_matplotlib

        require_matplotlib()  # raise now, not after the run

    import numpy as np
    import torch

    from moleculardiffusion_mivit_tpu_torch import resolve_device
    from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, get_experiment
    from moleculardiffusion_mivit_tpu_torch.utils import MetricsLogger, restore_experiment, save_experiment

    device = resolve_device(args.device)
    if args.experiment not in REGISTRY:
        ap.error(f"unknown experiment {args.experiment!r}; available: {sorted(REGISTRY)}")
    mesh = None
    if args.mesh:
        from moleculardiffusion_mivit_tpu_torch.config import MeshConfig
        from moleculardiffusion_mivit_tpu_torch.parallel import initialize_distributed, make_mesh

        try:
            layout = MeshConfig.parse(args.mesh)
        except ValueError as e:
            ap.error(f"--mesh: {e}")
        if device.type == "cuda":  # torchrun's rank on this host: its card
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        initialize_distributed("nccl" if device.type == "cuda" else "gloo")
        mesh = make_mesh(layout.data_parallel, layout.model_parallel)
    writes = mesh is None or mesh.rank == 0
    out_dir = args.out or f"results/{args.experiment}"
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(os.path.join(out_dir, "metrics.jsonl") if writes else None, stdout=writes)

    kwargs = dict(seed=args.seed, sequences_per_d=args.seqs_per_d, device=device)
    build_params = inspect.signature(REGISTRY[args.experiment]).parameters
    if (args.in_order or args.in_order_suite) and "with_in_order" in build_params:
        kwargs["with_in_order"] = True  # an explicit suite implies the sweep
    if args.in_order_suite is not None:
        if "in_order_suite" not in build_params:
            ap.error(f"experiment {args.experiment!r} does not support --in-order-suite")
        kwargs["in_order_suite"] = args.in_order_suite
    if args.with_hybrid:
        if "with_hybrid" not in build_params:
            ap.error(f"experiment {args.experiment!r} does not support --with-hybrid")
        kwargs["with_hybrid"] = True
    exp = get_experiment(args.experiment, **kwargs)
    if args.compute_dtype:
        exp.set_compute_dtype(args.compute_dtype)
    if args.no_stack_pairs:
        exp.stack_pairs = False
    if mesh is not None:
        exp.use_mesh(mesh)
    n_cycles = args.cycles or exp.train_cfg.num_cycles

    logger.log(
        "start",
        experiment=args.experiment,
        compute_dtype=exp.train_cfg.compute_dtype,
        devices=[torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)],
        num_cycles=n_cycles,
        sequences_per_d=args.seqs_per_d,
        training_ds=list(map(list, exp.train_cfg.training_ds)),
        lr=exp.train_cfg.lr,
        loss=exp.train_cfg.loss,
        models=exp.model_names,
        **({} if mesh is None else {"mesh": mesh.shape}),
    )

    t0 = time.time()
    exp.build()
    logger.log("built", seconds=round(time.time() - t0, 1))

    start_cycle = 0
    if args.resume:
        restore_experiment(exp, args.resume)
        start_cycle = len(next(iter(exp.history.values()))["val_avg"])
        n_cycles = max(n_cycles - start_cycle, 0)
        logger.log("resumed", checkpoint=args.resume, cycles_done=start_cycle, cycles_left=n_cycles)

    t0 = time.time()
    exp.run(
        num_cycles=n_cycles,
        callback=logger.cycle_callback(),
        eval_every=args.eval_every,
        checkpoint_last=args.checkpoint_last,
        checkpoint_dir=out_dir,
        start_cycle=start_cycle,
    )
    logger.log("trained", seconds=round(time.time() - t0, 1))

    save_experiment(exp, os.path.join(out_dir, "final"))
    final = {name: h["val_avg"][-1] for name, h in exp.history.items() if h["val_avg"]}
    logger.log("final_val_avg", values=final)

    if exp.in_order_data is not None:  # every rank predicts (collectives); rank 0 writes
        from moleculardiffusion_mivit_tpu_torch.evaluation import error_table, save_error_table_csv

        d_values = exp.in_order_data["d_values"]
        preds = exp.in_order_predictions()
        tables = {name: error_table(p, d_values) for name, p in preds.items()}
        if args.in_order_renders > 1:
            tables = exp.in_order_error_tables(n_renders=args.in_order_renders)
        csv_path = os.path.join(out_dir, f"{args.experiment}_errors.csv")
        if writes:
            save_error_table_csv(tables, csv_path)
            np.savez_compressed(
                os.path.join(out_dir, "in_order_predictions.npz"), d_values=np.asarray(d_values), **preds
            )
        logger.log("error_tables", path=csv_path, tables=tables)

    if not writes:
        logger.close()
        return exp
    with open(os.path.join(out_dir, "history.json"), "w") as f:
        json.dump(exp.history, f)
    if args.plots:
        from moleculardiffusion_mivit_tpu_torch.evaluation.plots import render_all

        made = render_all(out_dir)
        logger.log("figures", paths=list(made.values()))
    logger.close()
    print(f"results in {out_dir}", file=sys.stderr)
    return exp


if __name__ == "__main__":
    main()
