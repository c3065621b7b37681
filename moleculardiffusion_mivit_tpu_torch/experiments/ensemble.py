"""Deep ensembles of the flagship MiViT, trained as one model grid.

Port of ``examples/ensemble_training.py``. ``--members`` copies of the
early-fusion MiViT (``GeneralTransformer`` with the deep-ResNet embedding and
the 25 trajectory features added to the regression token; embed 64, 4 heads,
FFN 128, 6 layers, no positional encoding) train as one ``GridArm``
(``train.grid``, ``with_features``), each member on its own freshly drawn
data every cycle, through ``Experiment`` (on the card every epoch is a
captured CUDA graph, ``train.capture``; on the CPU it runs eagerly). The
schedule is the example's: batch 1 doubling every 20 cycles up to 64, the
learning rate 1e-4 × 0.9 every 5 cycles.

Cycle data (``generate``), member-major, all members in one call: member
``m`` draws from ``fold_in(g, 0, m)`` (its D from ``(0)``, its walks from
``(1)``; per class ``i`` of the discrete curriculum ``single_state`` from
``(i)``), then every member's sequences render in one K1 launch, member
``m``'s render and localisation noise from ``fold_in(g, 1, m)``, and get
their 25 features in one call (on a mesh, a rank's members alone:
``parallel.mesh.GenerationPart``). ``continuous``: D ~ U(d_low, d_high) a sequence, Brownian walks with
``dt`` = sub-positions a frame (a sub-step's sd is sqrt(2·D)), labels D /
``d_max_normalization``. ``discrete``: ``--n`` split over ``--classes``, D ~
N(c, 1) truncated at 0 a sequence, labels the simulator's.

Evaluation (``member_preds``): every member on the in-order suites,
``--eval-chunk`` sequences at a time, the features broadcast over the
members, optionally the mean over 0/90/180/270° rotations of the videos
(features unrotated). The suites render from the stream ``(seed,
1_000_000)``, apart from every training stream: ``imft`` (JAX's own array,
D = 0.1 … 10.0, ``evaluation.generate_in_order_imft``) and ``committed``
(the 70-value ``valTrajsInOrder`` set, D ≤ 7.0; the port's own draw, F1:
reported, not judged).

Run: python -m moleculardiffusion_mivit_tpu_torch.experiments.ensemble
     [--members 8] [--cycles 150] [--n 256] [--d-low 0.1] [--d-high 10.5]
     [--curriculum continuous|discrete] [--classes 1,3,5,7,9]
     [--eval-chunk 100] [--seed 0] [--out results/torch_ensemble]
     [--device cuda|cpu]

It writes ``<out>/ensemble_report.json`` with the example's keys (for
``imft``, ``imft_tta``, ``committed``, ``committed_tta``:
``member_mse_mean/min/max``, ``ensemble_mse/std/mae``, ``per_d_mse``,
``d_values``) plus ``train_seconds``, the seed, the card and the K1/K2/K3
launches, and ``<out>/ensemble_full_report.json``, unrounded: each member's
MSE of each suite, the per-D MSEs, each cycle's member losses and its end in
seconds. Without ``--device`` it runs on the card and raises on a machine
without one. ``experiments.continuous_d`` is the one-model curriculum run.

The outcome rules, written before the runs on the card;
``ensemble_outcome.py`` at the repository's root applies them. The JAX
records keep only the mean, min and max of their 8 members' MSEs, so their
sd is estimated from the range: sd_J = (max − min) / 2.847 (d₂ for 8 normal
draws).

- Runs: ``--members 8 --cycles 150 --n 256 --curriculum continuous
  --d-high 10.5 --seed S --out results/torch_ensemble_seedS``, S = 0…3, one
  after another in one call on the H100, against ``results/ensemble_150``
  (JAX on a TPU, one draw of 8 members).
- E1, members: the port's 32 ``imft`` member MSEs pooled (P) against the
  record's 8 (mean 0.5051, range 0.4965-0.5134, sd_J 0.00595). Held when
  |mean P − 0.5051| ≤ max(0.02, 3·sqrt(sd_P²/32 + sd_J²/8)). The members of
  a seed share one evaluation render and one run, so they are not
  independent draws and the pooled standard error is optimistic: the rule
  is stricter than its nominal level.
- E2, ensemble: the record's one draw inside the port's spread over its 4
  seeds: |mean P − 0.4933| ≤ max(0.02, 3·sd_P·sqrt(1 + 1/4)) on ``imft``'s
  ``ensemble_mse``, and the same against 0.4909 on ``imft_tta``'s.
- E3, the finding: in every port seed ``imft``'s ``ensemble_mse`` <
  ``member_mse_mean`` ("averaging buys 2-3 %"; the record's 2.3 %). By
  convexity the mean's MSE is never above the members' mean MSE, so the
  rule says that the members differ; each seed's gain is reported beside
  the record's.
- C1, the continuous-D curriculum: ``python -m
  moleculardiffusion_mivit_tpu_torch.experiments.continuous_d --cycles 150
  --n 256 --d-high 8 --seed S --out results/torch_continuous_d_seedS``, S =
  0…3, its ``imft`` MSE (P) against the 8 ``imft`` members of
  ``results/ensemble_d8`` (the same model, curriculum and budget, trained as
  grid members; mean 0.9178, range 0.8930-0.9395, sd_J 0.01630). Held when
  |mean P − 0.9178| ≤ max(0.03, 3·sqrt(sd_P²/4 + sd_J²/8)).
- Reported, not held: the ``committed`` columns, ``imft_tta``'s members,
  the per-D profiles, the continuous runs' ``committed`` line beside
  RESULTS.md's 0.314.
- A miss is logged as F8 or later in ROADMAP.md section 3, with its run and
  the file:line on both sides. It is not tuned away, and no seed is added
  or swapped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import (
    IN_ORDER_D_VALUES,
    IN_ORDER_IMFT_D_VALUES,
    error_table,
    generate_in_order_imft,
    load_validation_trajectories,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, GridArm, ModelEntry, rotate_videos
from moleculardiffusion_mivit_tpu_torch.experiments.images_features import make_dataset
from moleculardiffusion_mivit_tpu_torch.features import N_FEATURES
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import GenerationPart
from moleculardiffusion_mivit_tpu_torch.sim import brownian_motion, single_state
from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

MODEL_CONFIG = ModelConfig(use_pos_encoding=False)
EVAL_STREAM = 1_000_000
# every EVAL_D_EVERY-th D value of each in-order suite, EVAL_PARTICLES
# sequences of each (None: all 10); the tests cut both
EVAL_D_EVERY = 1
EVAL_PARTICLES: Optional[int] = None
KERNELS = {"render_frames": "k1", "deep_resnet_embed_fwd": "k2", "deep_resnet_embed_bwd": "k3"}


def train_config(seed: int = 0) -> TrainConfig:
    """The examples' schedule: batch 1 doubling every 20 cycles (to 64)."""
    return TrainConfig(seed=seed, adaptive_batch_size=20, initial_batch_size=1)


def mivit(model_cfg: Optional[ModelConfig] = None) -> GeneralTransformer:
    """The early-fusion MiViT: deep-ResNet embedding, the 25 features added
    to the regression token."""
    return GeneralTransformer(model_cfg or MODEL_CONFIG, embedding="deep_resnet", use_global_features=True,
                              fusion_type="early", global_feature_dim=N_FEATURES)


def generate(generator: torch.Generator, train_cfg: TrainConfig, optics, members: int, n: int,
             curriculum: str = "continuous", d_range: Tuple[float, float] = (0.1, 10.5),
             classes: Sequence[float] = (), part: Optional[GenerationPart] = None) -> Optional[Dict[str, torch.Tensor]]:
    """One cycle's data of every member on the generator's device (see the
    module docstring for the streams): ``{"videos" (M, n, F, S, S),
    "features" (M, n, 25), "labels" (M, n, 1)}``, rendered in one call.
    With ``part`` (``parallel.mesh.GenerationPart``) the members of its
    block alone (of its ``members`` if it names a grid's), bitwise the whole
    call's; ``None`` for a part with none."""
    p, f = train_cfg.n_pos_per_frame, train_cfg.n_frames
    ids = range(members)
    if part is not None:
        ids = ids[part.members or slice(None)]
        mine = part.units(len(ids))
        ids = ids[mine.start:mine.stop]
    if not ids:
        return None
    trajs, labels = [], []
    for m in ids:
        gm = fold_in(generator, 0, m)
        if curriculum == "continuous":
            lo, hi = d_range
            gd = fold_in(gm, 0)
            d = lo + (hi - lo) * torch.rand(n, generator=gd, device=gd.device)
            trajs.append(brownian_motion(fold_in(gm, 1), n, f, p, d, float(p)))
            labels.append(d[:, None])
        elif curriculum == "discrete":
            if n % len(classes):
                raise ValueError(f"--n {n} must divide by {len(classes)} classes")
            for i, c in enumerate(classes):
                t, lab = single_state(fold_in(gm, i), n // len(classes), f * p, Ds=(float(c), 1.0))
                trajs.append(t)
                labels.append(lab[:, :1, 1])
        else:
            raise ValueError(f"unknown curriculum {curriculum!r}; expected 'continuous' or 'discrete'")
    data = make_dataset([fold_in(generator, 1, m) for m in ids], torch.cat(trajs) / train_cfg.traj_div_factor,
                        train_cfg, optics)

    def member_major(t):
        return t.reshape((len(ids), n) + tuple(t.shape[1:]))

    return {"videos": member_major(data["videos"]), "features": member_major(data["features"]),
            "labels": member_major(torch.cat(labels) / train_cfg.d_max_normalization)}


def build(seed: int, members: int, n: int, curriculum: str = "continuous",
          d_range: Tuple[float, float] = (0.1, 10.5), classes: Sequence[float] = (),
          model_cfg: Optional[ModelConfig] = None, device=None) -> Experiment:
    """The ensemble's ``Experiment`` (no validation sets): one ``GridArm``
    ``ensemble`` of ``members`` MiViTs, member ``m`` named ``member_m``; with
    ``members = 0`` a single model, arm ``mivit`` (``continuous_d``)."""
    dev = resolve_device(device)
    train_cfg = train_config(seed)
    optics = BASELINE_OPTICS

    def generate_fn(g, part=None):
        return generate(g, train_cfg, optics, max(members, 1), n, curriculum, d_range, classes, part)

    if members:
        arms = {"ensemble": GridArm(model=mivit(model_cfg), names=[f"member_{m}" for m in range(members)],
                                    slice_fn=lambda d: (d["videos"], d["features"], d["labels"]),
                                    with_features=True)}
    else:
        arms = {"mivit": ModelEntry(model=mivit(model_cfg), with_features=True,
                                    slice_fn=lambda d: (d["videos"][0], d["features"][0], d["labels"][0]))}
    return Experiment("ensemble" if members else "continuous_d", train_cfg, optics, arms, generate_fn, {},
                      device=dev)


def suites(train_cfg: TrainConfig, optics, device, names: Sequence[str] = ("imft", "committed"),
           stream: int = EVAL_STREAM) -> Dict[str, Tuple[Dict[str, torch.Tensor], np.ndarray]]:
    """The in-order suites ``name → (data, d_values)`` through
    ``make_dataset`` from the stream ``(seed, stream)``: every
    ``EVAL_D_EVERY``-th D value, ``EVAL_PARTICLES`` sequences of each (all
    by default)."""
    f, p = train_cfg.n_frames, train_cfg.n_pos_per_frame
    out = {}
    for name in names:
        if name == "imft":
            arr, d_values = generate_in_order_imft(t_steps=f * p), IN_ORDER_IMFT_D_VALUES
        else:
            arr, d_values = load_validation_trajectories(length=f, device=device)["valTrajsInOrder"], IN_ORDER_D_VALUES
        arr, d_values = arr[::EVAL_D_EVERY, :EVAL_PARTICLES], np.asarray(d_values)[:len(arr):EVAL_D_EVERY]
        flat = torch.as_tensor(arr.reshape((-1,) + arr.shape[2:]), dtype=torch.float32, device=device)
        data = make_dataset(seeded_generator(device, train_cfg.seed, stream), flat / train_cfg.traj_div_factor,
                            train_cfg, optics)
        out[name] = ({"videos": data["videos"], "features": data["features"]}, d_values)
    return out


def member_preds(exp: Experiment, videos: torch.Tensor, features: torch.Tensor, tta: bool,
                 chunk: int = 100) -> np.ndarray:
    """Every member's predictions ``(M, N)`` in D units (a single model's
    ``(1, N)``), ``chunk`` sequences at a time, the features broadcast over
    the members; with ``tta`` the mean over the videos rotated by 0, 90, 180
    and 270° (the features unrotated)."""
    (arm_name, arm), = exp.arms.items()
    evaluate, state = exp._impls[arm_name].evaluate, exp.states[arm_name]
    m = len(arm.names) if isinstance(arm, GridArm) else 0
    outs = []
    for i in range(0, videos.shape[0], chunk):
        v, ft = videos[i:i + chunk], features[i:i + chunk]
        if m:
            ft = ft.expand((m,) + ft.shape)
        preds = []
        for k in range(4) if tta else (0,):
            vk = rotate_videos(v, k)
            preds.append(evaluate(state, vk.expand((m,) + vk.shape) if m else vk, ft))
        outs.append(torch.stack(preds).mean(dim=0)[..., 0].reshape(max(m, 1), -1))
    return torch.cat(outs, dim=1).cpu().numpy()


def suite_tables(preds: np.ndarray, d_values: np.ndarray) -> Tuple[dict, dict]:
    """The example's table of one suite from ``(M, N)`` predictions (in
    float64): member MSEs' mean, min and max, the ensemble mean's
    ``error_table`` and its per-D MSE (rounded to 1e-5, as the example's),
    and the D values; and beside it the unrounded member MSEs and per-D
    MSEs."""
    n_d = len(d_values)
    preds = np.asarray(preds, dtype=np.float64)
    mses = [error_table(pm.reshape(n_d, -1), d_values)["mse"] for pm in preds]
    grid = preds.mean(axis=0).reshape(n_d, -1)
    ens = error_table(grid, d_values)
    per_d = ((grid - d_values[:, None]) ** 2).mean(axis=1)
    table = {"member_mse_mean": float(np.mean(mses)), "member_mse_min": float(np.min(mses)),
             "member_mse_max": float(np.max(mses)), "ensemble_mse": ens["mse"], "ensemble_std": ens["std"],
             "ensemble_mae": ens["mae"], "per_d_mse": [round(float(x), 5) for x in per_d],
             "d_values": [float(d) for d in d_values]}
    return table, {"member_mse": mses, "per_d_mse": per_d.tolist()}


def train(exp: Experiment, cycles: int, dev) -> Tuple[list, float]:
    """Run the experiment's cycles; returns each cycle's end (host seconds
    from the start) and the seconds of the whole, synchronised."""
    marks = []
    t0 = time.perf_counter()

    def progress(c, _):
        marks.append(time.perf_counter() - t0)
        if (c + 1) % 25 == 0 or c == cycles - 1:
            lo = torch.stack(exp.train_loss[next(iter(exp.arms))][-1:]).cpu().numpy()
            print(f"cycle {c + 1}/{cycles} losses [{lo.min():.5f} .. {lo.max():.5f}]", flush=True)

    exp.run(num_cycles=cycles, callback=progress)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return marks, time.perf_counter() - t0


def launches_since(counts0: dict, engines=()) -> dict:
    """K1/K2/K3 launches since ``counts0``, the ``engines``' replays
    counted (``train.capture.kernel_launches``)."""
    got = kernel_launches(counts0, engines)
    return {short: got[name] for name, short in KERNELS.items()}


def write(out: str, stem: str, report: dict, full: dict) -> None:
    """``<out>/<stem>_report.json`` and, unrounded beside it,
    ``<out>/<stem>_full_report.json``."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{stem}_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    with open(os.path.join(out, f"{stem}_full_report.json"), "w") as f:
        json.dump({"report": report, **full}, f, indent=1)
    print(f"report -> {out}/{stem}_report.json", flush=True)


def main(argv=None) -> dict:
    """Train and score the ensemble; returns ``{"report": the written
    report, ...}`` with the unrounded tables, losses and seconds as in
    ``ensemble_full_report.json``, and the trained ``experiment``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=150)
    ap.add_argument("--n", type=int, default=256, help="sequences per member per cycle")
    ap.add_argument("--d-low", type=float, default=0.1)
    ap.add_argument("--d-high", type=float, default=10.5, help="the continuous curriculum's upper bound")
    ap.add_argument("--curriculum", choices=("continuous", "discrete"), default="continuous")
    ap.add_argument("--classes", default="1,3,5,7,9", help="discrete-curriculum class means (sd 1 each)")
    ap.add_argument("--eval-chunk", type=int, default=100, help="sequences per eval call")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/torch_ensemble")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.members < 1:
        raise SystemExit("--members must be at least 1")
    t_start = time.perf_counter()
    classes = tuple(float(c) for c in args.classes.split(",")) if args.curriculum == "discrete" else ()
    exp = build(args.seed, args.members, args.n, args.curriculum, (args.d_low, args.d_high), classes, device=dev)
    exp.build()
    counts0 = launch_counts()
    print(f"training {args.members} members, {args.cycles} cycles × {args.n} sequences each", flush=True)
    marks, train_s = train(exp, args.cycles, dev)
    print(f"{args.members}-member ensemble trained in {train_s:.0f}s", flush=True)
    trained = launches_since(counts0, [exp.engine])

    t0 = time.perf_counter()
    counts0 = launch_counts()
    report = {"members": args.members, "cycles": args.cycles, "n_per_member": args.n,
              "curriculum": args.curriculum, "classes": args.classes if classes else None,
              "d_range": [args.d_low, args.d_high], "train_seconds": round(train_s, 1), "seed": args.seed}
    members = {}
    for suite, (data, d_values) in suites(exp.train_cfg, exp.optics, dev).items():
        for tta in (False, True):
            tag = f"{suite}{'_tta' if tta else ''}"
            table, members[tag] = suite_tables(
                member_preds(exp, data["videos"], data["features"], tta, args.eval_chunk), d_values)
            report[tag] = table
            print(f"[{tag}] single-member MSE {table['member_mse_mean']:.4f} (range {table['member_mse_min']:.4f}"
                  f"-{table['member_mse_max']:.4f}) -> {args.members}-member ensemble {table['ensemble_mse']:.4f}"
                  f" ± {table['ensemble_std']:.4f}", flush=True)
    eval_s = time.perf_counter() - t0
    report.update(card=card_line(dev), launches={"train": trained, "eval": launches_since(counts0)})
    full = {"seed": args.seed, "suites": members, "train_loss": [v.tolist() for v in exp.train_loss["ensemble"]],
            "cycle_end_s": marks, "train_s": train_s, "eval_s": eval_s,
            "seconds": time.perf_counter() - t_start, "argv": list(sys.argv[1:] if argv is None else argv)}
    write(args.out, "ensemble", report, full)
    return {"report": report, **full, "experiment": exp}


if __name__ == "__main__":
    main()
