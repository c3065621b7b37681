#!/usr/bin/env python3
"""The constrained-diffusion demo's outcome: the port's card seeds against
JAX's own spread, by the rule in the docstring of
``moleculardiffusion_mivit_tpu_torch/sim/mitochondria_demo.py`` (written
before the runs).

- ``--jax-msd N``: JAX's evaluation draw of ``examples/mitochondria_demo.py``
  over keys 42 … 42+N−1 on the CPU (key 42 is the example's own, the
  record's): ``geo.simulate`` of 50 molecules at D = 4 from the example's
  ``fold_in(split(key, 3)[0], 99)``, then MSD(τ=1)/4 (naive) and /2
  (confined). No training. Writes ``jax_msd.json``.
- ``--jax-seeds K``: the example's whole demo (15 cycles × 64 steps of the
  full-width deep-ResNet transformer, JAX on the CPU) at keys 42 … 42+K−1,
  each timed; the example's ``main`` with the key as a parameter (its
  ``build_skeleton`` and ``constrained_batch``, its training loop). Writes
  ``jax_mivit.json``.
- Without either it judges the written files against the port's seeds
  (``results/torch_mitochondria_demo_seed{0,1,2,3}/mitochondria_report.json``,
  card runs of ``python -m moleculardiffusion_mivit_tpu_torch.sim.mitochondria_demo
  --cycles 15 --seed S``) and exits 1 when a held rule misses.

Usage: ``python3 mitochondria_outcome.py [--jax-msd 16] [--jax-seeds 2]
[--out results/mitochondria_outcome] [PORT_DIR ...]``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "results" / "mitochondria_outcome"
PORT_DIRS = [ROOT / "results" / f"torch_mitochondria_demo_seed{s}" for s in range(4)]
RECORD = {"msd_naive": 1.98, "msd_confined": 3.96, "mivit": 4.70, "mivit_sd": 1.07}  # RESULTS.md, JAX on a TPU
FIRST_KEY = 42
JAX_SEED_LIMIT_S = 15 * 60


def _example():
    spec = importlib.util.spec_from_file_location("mitochondria_example", ROOT / "examples" / "mitochondria_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_msd(key: int) -> dict:
    """The example's MSD columns at one key (its evaluation trajectories)."""
    import jax

    ex = _example()
    geo = ex.build_skeleton()
    k_eval = jax.random.split(jax.random.key(key), 3)[0]
    trajs = geo.simulate(jax.random.fold_in(k_eval, 99), 50, 300, D=4.0, initial_distance=geo.total_length / 2.0)
    msd1 = float((np.diff(np.asarray(trajs), axis=1) ** 2).sum(-1).mean())
    return {"key": key, "msd_naive": msd1 / 4.0, "msd_confined": msd1 / 2.0}


def jax_seed(key: int, cycles: int = 15) -> dict:
    """The example's demo at one key: its main with ``jax.random.key(key)``
    in place of ``key(42)``, no figure."""
    import jax
    import jax.numpy as jnp

    from moleculardiffusion_mivit_tpu.config import ModelConfig, TrainConfig
    from moleculardiffusion_mivit_tpu.models import GeneralTransformer
    from moleculardiffusion_mivit_tpu.train.loop import make_train_fns

    ex = _example()
    t0 = time.perf_counter()
    geo = ex.build_skeleton()
    cfg = TrainConfig(num_cycles=cycles)
    n_frames, n_pos = cfg.n_frames, cfg.n_pos_per_frame
    k_eval, k_train_data, k_init = jax.random.split(jax.random.key(key), 3)
    eval_videos, _ = ex.constrained_batch(k_eval, geo, 50, n_frames, n_pos, [4.0])
    model = GeneralTransformer(ModelConfig(), embedding="deep_resnet")
    init_state, train_cycle, evaluate = make_train_fns(model, cfg)
    state = init_state(k_init, eval_videos[:1])
    losses = []
    for cycle in range(cycles):
        k_c = jax.random.fold_in(k_train_data, cycle)
        videos, labels = ex.constrained_batch(k_c, geo, 16, n_frames, n_pos, [1.0, 3.0, 5.0, 7.0])
        state, loss = train_cycle(state, videos, labels / cfg.d_max_normalization, None, jax.random.fold_in(k_c, 7),
                                  jnp.float32(cfg.lr_for_cycle(cycle)), cfg.batch_size_for_cycle(cycle))
        losses.append(float(loss))
        print(f"key {key} cycle {cycle}: loss {losses[-1]:.4f}", flush=True)
    preds = np.asarray(evaluate(state, eval_videos))[:, 0]
    return {"key": key, "mivit": float(preds.mean()), "mivit_sd": float(preds.std()), "train_loss": losses,
            "seconds": time.perf_counter() - t0}


def judge(msd: list, mivit: list, port: list) -> dict:
    """The rule of the demo's docstring on JAX's keys and the port's seeds."""
    out = {"port_seeds": [p["seed"] for p in port], "record": RECORD, "held": {}}
    for col in ("msd_naive", "msd_confined"):
        j = np.asarray([k[col] for k in msd])
        p = np.asarray([s[col] for s in port])
        limit = 2 * j.std(ddof=1) * np.sqrt(1 / len(p) + 1 / len(j))
        out[col] = {"jax_keys": len(j), "jax_mean": float(j.mean()), "jax_sd": float(j.std(ddof=1)),
                    "jax_min": float(j.min()), "jax_max": float(j.max()), "port": p.tolist(),
                    "port_mean": float(p.mean()), "mean_limit": float(limit)}
        out["held"][f"{col}_every_seed_within_jax_range"] = bool(((p >= j.min()) & (p <= j.max())).all())
        out["held"][f"{col}_mean_within_limit"] = bool(abs(p.mean() - j.mean()) <= limit)
    p = np.asarray([s["mivit"] for s in port])
    col = {"port": p.tolist(), "port_mean": float(p.mean()), "port_sd": float(p.std(ddof=1)),
           "port_per_molecule_sd": [s["mivit_sd"] for s in port]}
    if mivit:
        j = np.asarray([k["mivit"] for k in mivit])
        col.update(jax=j.tolist(), jax_keys=[k["key"] for k in mivit], jax_seconds=[k["seconds"] for k in mivit])
        if mivit[0]["seconds"] <= JAX_SEED_LIMIT_S and len(j) >= 2:
            se = np.sqrt(p.var(ddof=1) / len(p) + j.var(ddof=1) / len(j))
            col.update(jax_mean=float(j.mean()), jax_sd=float(j.std(ddof=1)), limit=float(2 * se))
            out["held"]["mivit_mean_within_2_pooled_se"] = bool(abs(p.mean() - j.mean()) <= 2 * se)
        else:
            col["not_held"] = "one JAX CPU seed took over 15 min or fewer than two JAX seeds ran"
    out["mivit"] = col
    out["ok"] = all(out["held"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jax-msd", type=int, default=0, help="JAX's MSD columns over this many keys")
    ap.add_argument("--jax-seeds", type=int, default=0, help="JAX's whole demo at this many keys")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("port_dirs", nargs="*", default=[str(p) for p in PORT_DIRS])
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.jax_msd or args.jax_seeds:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.jax_msd:
        keys = [jax_msd(k) for k in range(FIRST_KEY, FIRST_KEY + args.jax_msd)]
        (out / "jax_msd.json").write_text(json.dumps(
            {"keys": keys, "command": f"python3 mitochondria_outcome.py --jax-msd {args.jax_msd}"}, indent=1) + "\n")
    if args.jax_seeds:
        seeds = [jax_seed(k) for k in range(FIRST_KEY, FIRST_KEY + args.jax_seeds)]
        (out / "jax_mivit.json").write_text(json.dumps(
            {"seeds": seeds, "command": f"python3 mitochondria_outcome.py --jax-seeds {args.jax_seeds}"},
            indent=1) + "\n")
    if args.jax_msd or args.jax_seeds:
        return 0
    msd = json.loads((out / "jax_msd.json").read_text())["keys"]
    mivit_path = out / "jax_mivit.json"
    mivit = json.loads(mivit_path.read_text())["seeds"] if mivit_path.exists() else []
    port = [json.loads((Path(d) / "mitochondria_report.json").read_text()) for d in args.port_dirs]
    verdict = judge(msd, mivit, port)
    print(json.dumps(verdict, indent=1))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
