"""Sequence-mode change-point detection, quantified: the two studies.

Port of ``examples/sequence_changepoint_demo.py`` (``demo``) and
``examples/sequence_changepoint_modular.py`` (``modular``). Both train
per-frame D predictors on four D classes (D ~ N(1, 1), N(3, 1), N(5, 1),
N(7, 1) a sequence, 30 frames of 10 sub-positions, 9×9) whose trajectory
tails are swapped across classes (the first half of each class, at a split
in frames [10, 20)), then score change points on a held-out set:

- planted transitions: constant-D sequences of the four classes with the
  same tail swaps (``mix_tails_multi``) at known splits, and the same
  sequences unswapped as controls;
- ``detect_change_points`` on each sequence's per-frame predictions; ROC
  AUC of planted against control scores (ties 0.5), the detection and
  false-positive rates at a threshold set at the 95th percentile of an
  independent constant-D calibration split (Wilson 95 % intervals), the
  split error of the detected transitions, and the rates by |ΔD|
  (``evaluation.changepoint.score_planted``).

The held-out sets come from the stream ``777``, whatever ``--seed`` is,
as the examples' fixed key 777: controls from ``(777, 0)``, the planted
splits from ``(777, 1)``, the calibration split from ``(777, 2)``.

``demo``: the baseline experiment in sequence mode (``experiments.baseline.
build(sequences=True)``, seven arms, validation every 10 cycles), scored on
64 sequences a class with ``--model``'s predictions (``deepcnn_2layer_s``).
Writes ``changepoint_metrics.json`` with the example's keys.

``modular``: three arms trained on the same data each cycle, each with its
own permutation stream, through ``Experiment`` (CUDA graphs on the card):

- ``mod_images``: ``ModularTransformer`` on the images only;
- ``mod_both_concat``: ``ModularTransformer`` with the per-frame kinematic
  tokens (``features.compute_per_frame_features`` of the frame-averaged
  trajectory) embedded by an MLP, concatenated and projected;
- with ``--with-hybrid``, ``mod_hybrid``: ``HybridFusionTransformer``
  (``concat_proj``) with those tokens and the 25 global features of the
  spliced frame-averaged trajectory in its regression token.

Videos, per-frame labels, tokens and averaged trajectories swap tails at the
same splits. ``--continuous LO,HI`` trains on D ~ U(LO, HI) a sequence with
sequence i swapped against n−1−i (the first half) instead; the evaluation
stays the discrete one. Predictions run 256 sequences at a time. Writes
``changepoint_modular.json`` with the example's keys.

Both also write ``<name>_report.json``: the seed, the card, the run's
seconds, each arm's per-cycle mean training loss and (demo) validation
history and ``const_frame_sd`` of the scored arm's predictions on the
constant-D controls.

Run: python -m moleculardiffusion_mivit_tpu_torch.evaluation.changepoint_study
     {demo,modular} [--cycles C] [--seqs-per-d N] [--continuous LO,HI]
     [--seed S] [--out DIR] [--device cuda|cpu]
     demo: [--model deepcnn_2layer_s] [--score-threshold T]
     modular: [--eval-per-class 64] [--with-hybrid]
Without ``--device`` it runs on the card and raises on a machine without
one.

The outcome rules, written before the runs on the card;
``changepoint_outcome.py`` at the repository's root applies them.

- Modular study. Runs: ``modular --with-hybrid --cycles 150 --seqs-per-d 256
  --eval-per-class 384 --seed S --out results/torch_changepoint_modular_seedS``,
  S = 0…3, on the H100. JAX: ``results/changepoint_modular_r5`` (seed 0),
  ``_seed1`` and ``_seed2``, the same protocol. For each arm (mod_images,
  mod_both_concat, mod_hybrid) and statistic s (``roc_auc``,
  ``detection_rate``), held when |mean P − mean J| ≤ max(f_s,
  3·sqrt(sd_P²/4 + sd_J²/3)), f = 0.02 for the AUC and 0.05 for the
  detection rate. Held in every port seed: mod_images' AUC below both
  feature-token arms' (the study's conclusion; JAX shows it in 3 of 3
  seeds by ≥ 0.08). Reported, not held: false-positive rates, median split
  errors, the rates by |ΔD| with their intervals.
- Demo. Runs: ``demo --cycles 150 --seqs-per-d 256 --seed S --out
  results/torch_changepoint_demo_seedS``, S = 0…3. Against
  ``results/changepoint_scaled`` (one JAX draw, the same protocol: AUC
  0.865): the AUC is held when |mean P − record| ≤ max(0.03,
  3·sd_P·sqrt(1 + 1/4)). The detection rate (128 transitions) and
  ``results/changepoint_demo`` (100 cycles × 64, AUC 0.845) are reported.
- Continuous curriculum: each study once with ``--continuous 0.1,8`` at
  seed 0, reported beside ``results/changepoint_continuous`` (demo AUC
  0.767) and ``results/changepoint_modular_continuous`` (0.836 / 0.890),
  not held.
- A miss is logged as F8 in ROADMAP.md section 3, with its run and the
  file:line on both sides. It is not tuned away, and no seed is added or
  swapped.

The continuous-curriculum demo against the JAX package (C1, C2), written
before any of its runs. The demo scores ``deepcnn_2layer_s`` alone, and an
arm's result depends only on its own keys and the cycle's shared data, so
JAX's side trains that arm alone: one fair draw of its distribution a seed.

- C1, at the cut, both curricula. Port: ``demo --cycles 10 --seqs-per-d 64
  --seed S [--continuous 0.1,8] --out
  results/torch_changepoint_demo_cut10_{discrete,continuous}_seedS``, S =
  0…7, on the H100 (~35 s of training a run). JAX: ``python3
  changepoint_outcome.py --jax-seeds 1 --first-jax-seed K --cycles 10
  [--continuous 0.1,8]``, K = 1…4 a curriculum (key 0 is the record's):
  the example ``examples/sequence_changepoint_demo.py`` with its arm alone,
  its training loop and its evaluation (key 777, 64 a class), on the CPU,
  each under ``taskset`` on two cores, four at once. Budget, measured
  first: one such JAX cycle at 64 a class on two cores took 278 s of
  training, its compile included, and 328 s in all
  (``results/changepoint_outcome/jax_cost_single_cyc.json``), so a seed of ten
  cycles takes at most ~50 min and the eight ~2 h; the port's sixteen
  ~15 min on one H100. Held, per curriculum: the AUC when |mean P − mean J| ≤
  max(0.03, 3·sqrt(sd_P²/n_P + sd_J²/n_J)), n_P = 8, n_J = 4. Held: the
  sign of (discrete − continuous) of the mean AUC is the same on both
  sides.
- C2, at the records' protocol, the port alone: ``demo --cycles 100
  --seqs-per-d 64 --seed S [--continuous 0.1,8] --out
  results/torch_changepoint_demo_{discrete,continuous}_seedS``, S = 0…3
  (~342 s a run on the H100: ~46 min on one H100 for the eight). Continuous
  seed 0 (AUC 0.873) runs again with the same command, so that its report
  carries the field below; a rerun that differs is reported beside it.
  Held: ``results/changepoint_continuous`` (JAX, 0.767) within max(0.03,
  3·sd_P·sqrt(1 + 1/n_P)) of the continuous mean, and
  ``results/changepoint_demo`` (JAX, discrete, 0.845) within the same of
  the discrete mean, n_P = 4.
- Reported per seed, both sides: the detection rate, ``mean_score_mixed``,
  ``mean_score_const`` and ``const_frame_sd`` (the mean over the constant-D
  controls of the sd of each one's per-frame predictions, D units).
- What the outcomes mean. C1 and C2 hold: the port reproduces the JAX
  package's demo on both curricula. C1 holds and C2 misses: the record
  differs from the JAX package's code run on the CPU (the record ran on a
  TPU, at its default f32 matmul precision, from one draw), not the port.
  C1 misses while the trainer witness (``tests/test_torch_changepoint_study.py``,
  one cycle of the arm step by step against JAX's ``train_step``) holds: the
  difference lies outside one cycle, in the evaluation or in the
  cycle-to-cycle keys and data. C1 misses with the witness missing: the
  trainer.
- A miss is logged as F9 in ROADMAP.md section 3. No seed is added, swapped
  or re-keyed after this rule, and no bound is tuned.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation.changepoint import (
    DEMO_FIELDS,
    MODULAR_FIELDS,
    score_planted,
    select_fields,
)
from moleculardiffusion_mivit_tpu_torch.experiments.base import Experiment, ModelEntry
from moleculardiffusion_mivit_tpu_torch.features import (
    N_FEATURES,
    N_PER_FRAME_FEATURES,
    compute_features_for_multiple_trajectories,
    compute_per_frame_features,
)
from moleculardiffusion_mivit_tpu_torch.models import HybridFusionTransformer, ModularTransformer
from moleculardiffusion_mivit_tpu_torch.parallel.mesh import GenerationPart, part_units
from moleculardiffusion_mivit_tpu_torch.sim import (
    average_trajectories_frames,
    brownian_motion,
    render_videos,
    single_state,
)
from moleculardiffusion_mivit_tpu_torch.train.loop import (
    generate_cycle_data,
    mix_tails_multi,
    mix_tails_uniform,
    mix_trajectory_tails,
)
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

TRAINING_DS = ((1, 1), (3, 1), (5, 1), (7, 1))
EVAL_STREAM = 777
DEMO_EVAL_PER_CLASS = 64  # the demo's planted set, pinned as in the example
PREDICT_CHUNK = 256
# sequence mode as the baseline experiment's: positional encoding on, a
# prediction per frame token
MODEL_CONFIG = ModelConfig(use_pos_encoding=True, use_regression_token=False, single_prediction=False)
MIX_STREAM = 999  # the training data's tail-swap splits: fold_in(cycle stream, 999)


def study_train_config(seqs_per_d: int, seed: int = 0) -> TrainConfig:
    """The modular study's training configuration (the example's)."""
    return TrainConfig(seed=seed, sequences_per_d=seqs_per_d, training_ds=TRAINING_DS, sequence_mode=True,
                       mix_trajectories=True)


def generate(generator: torch.Generator, train_cfg: TrainConfig, optics, seqs_per_d: int,
             mix: bool, part: Optional[GenerationPart] = None) -> Optional[Dict[str, torch.Tensor]]:
    """The example's ``generate`` on the generator's device: per class ``i``,
    ``single_state`` from ``fold_in(generator, i, 0)``, rendered (K1) from
    ``fold_in(generator, i, 1)`` and normalised; the frame-averaged
    trajectories, their per-frame tokens and the per-frame labels (D over
    ``d_max_normalization``). With ``mix``, videos, labels, tokens and
    averaged trajectories swap tails at the same splits (``mix_classes``).
    Returns ``{"videos" (N, F, S, S), "labels" (N, F), "pf_features" (N, F,
    6), "avg" (N, F, 2)}``. With ``part`` (``parallel.mesh.GenerationPart``)
    its classes alone and unmixed (``None`` for none): the cross-class swap
    runs on the gathered cycle."""
    p, f = train_cfg.n_pos_per_frame, train_cfg.n_frames
    classes = part_units(part, len(train_cfg.training_ds))
    if not classes:
        return None
    videos, labels, avgs = [], [], []
    for i in classes:
        trajs, labs = single_state(fold_in(generator, i, 0), seqs_per_d, f * p, Ds=tuple(train_cfg.training_ds[i]))
        trajs = trajs / train_cfg.traj_div_factor
        videos.append(render_videos(fold_in(generator, i, 1), trajs, train_cfg, optics))
        avgs.append(average_trajectories_frames(trajs, p))
        labels.append(labs[:, :, 1].reshape(seqs_per_d, f, p).mean(dim=2) / train_cfg.d_max_normalization)
    avg = torch.cat(avgs)
    data = {"videos": torch.cat(videos), "labels": torch.cat(labels), "pf_features": compute_per_frame_features(avg),
            "avg": avg}
    return mix_classes(generator, data, train_cfg) if mix and part is None else data


def mix_classes(generator: torch.Generator, data: Dict[str, torch.Tensor], train_cfg: TrainConfig):
    """``generate``'s tail swap across classes: videos, labels, tokens and
    averaged trajectories at the same splits (``mix_tails_multi`` from
    ``fold_in(generator, 999)``)."""
    keys = ("videos", "labels", "pf_features", "avg")
    mixed = mix_tails_multi(fold_in(generator, MIX_STREAM), tuple(data[k] for k in keys), len(train_cfg.training_ds),
                            train_cfg.n_frames)
    return dict(data, **dict(zip(keys, mixed)))


def generate_continuous(generator: torch.Generator, train_cfg: TrainConfig, optics, seqs_per_d: int,
                        d_range: Tuple[float, float], part: Optional[GenerationPart] = None
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """The example's continuous curriculum: ``4·seqs_per_d`` sequences at D ~
    U(lo, hi) each (from ``fold_in(generator, 0)``), Brownian from ``(1)``,
    block ``b`` of ``seqs_per_d`` sequences rendered from ``(2, b)``;
    sequence i swaps its tail with sequence n−1−i for the first ``(n // 2)
    // 2``, videos, labels, tokens and averaged trajectories at the same
    splits (``mix_uniform``). With ``part`` its blocks alone and unmixed."""
    lo, hi = d_range
    p, f = train_cfg.n_pos_per_frame, train_cfg.n_frames
    n_blocks = len(train_cfg.training_ds)
    n = seqs_per_d * n_blocks
    blocks = part_units(part, n_blocks)
    if not blocks:
        return None
    gd = fold_in(generator, 0)
    d = lo + (hi - lo) * torch.rand(n, generator=gd, device=gd.device)
    trajs = brownian_motion(fold_in(generator, 1), n, f, p, d, float(p)) / train_cfg.traj_div_factor
    rows = slice(blocks.start * seqs_per_d, blocks.stop * seqs_per_d)
    videos = torch.cat([render_videos(fold_in(generator, 2, b), trajs[b * seqs_per_d:(b + 1) * seqs_per_d], train_cfg,
                                      optics) for b in blocks])
    avg = average_trajectories_frames(trajs[rows], p)
    labels = (d[rows] / train_cfg.d_max_normalization)[:, None].expand(rows.stop - rows.start, f).contiguous()
    data = {"videos": videos, "labels": labels, "pf_features": compute_per_frame_features(avg), "avg": avg}
    return mix_uniform(generator, data, train_cfg) if part is None else data


def mix_uniform(generator: torch.Generator, data: Dict[str, torch.Tensor], train_cfg: TrainConfig):
    """``generate_continuous``'s tail swap (``mix_tails_uniform`` from
    ``fold_in(generator, 3)``)."""
    keys = ("videos", "labels", "pf_features", "avg")
    mixed = mix_tails_uniform(fold_in(generator, 3), tuple(data[k] for k in keys), train_cfg.n_frames)
    return dict(data, **dict(zip(keys, mixed)))


def pack_hybrid(data: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``HybridFusionTransformer``'s packed features: the per-frame tokens
    flattened, then the 25 global features of the (possibly spliced)
    frame-averaged trajectory."""
    pf = data["pf_features"]
    gf = compute_features_for_multiple_trajectories(data["avg"], dt=1.0)
    return torch.cat([pf.reshape(pf.shape[0], -1), gf], dim=-1)


def modular_arms(with_hybrid: bool, model_cfg: Optional[ModelConfig] = None) -> Dict[str, ModelEntry]:
    """The study's arms, each called as ``model(videos, features)`` (the
    example's ``with_features=True`` for all three; ``mod_images`` reads
    no features)."""
    cfg = model_cfg or MODEL_CONFIG

    def modular(mode):
        return ModularTransformer(cfg, mode=mode, image_embedding="deep_resnet", features_dim=N_PER_FRAME_FEATURES,
                                  feature_embedding_type="mlp", fusion_method="concat_proj")

    def pf_slice(data):
        return data["videos"], data["pf_features"], data["labels"]

    def packed_slice(data):
        return data["videos"], data["hybrid_features"], data["labels"]

    arms = {"mod_images": ModelEntry(model=modular("images_only"), slice_fn=pf_slice, with_features=True),
            "mod_both_concat": ModelEntry(model=modular("both"), slice_fn=pf_slice, with_features=True)}
    if with_hybrid:
        arms["mod_hybrid"] = ModelEntry(
            model=HybridFusionTransformer(cfg, image_embedding="deep_resnet", per_frame_dim=N_PER_FRAME_FEATURES,
                                          global_dim=N_FEATURES, fusion_method="concat_proj"),
            slice_fn=packed_slice, with_features=True)
    return arms


def build_modular(seed: int, seqs_per_d: int, with_hybrid: bool, continuous=None, device=None) -> Experiment:
    """The modular study's ``Experiment`` (no validation sets): each cycle's
    data from the experiment's per-cycle stream, with the hybrid's packed
    features when the hybrid arm is there."""
    dev = resolve_device(device)
    train_cfg = study_train_config(seqs_per_d, seed)
    optics = BASELINE_OPTICS

    def finish(generator, data):
        """The cross-class steps: the tail swap, then the hybrid's packed
        features of the swapped trajectories."""
        data = mix_classes(generator, data, train_cfg) if continuous is None else mix_uniform(generator, data,
                                                                                              train_cfg)
        if with_hybrid:
            data["hybrid_features"] = pack_hybrid(data)
        return data

    def generate_fn(generator, part=None):
        if continuous is None:
            data = generate(generator, train_cfg, optics, seqs_per_d, mix=False, part=part)
        else:
            data = generate_continuous(generator, train_cfg, optics, seqs_per_d, continuous, part=part)
        return finish(generator, data) if part is None else data

    return Experiment("changepoint_modular", train_cfg, optics, modular_arms(with_hybrid), generate_fn, {},
                      device=dev, finish_fn=finish)


def planted_sets(train_cfg: TrainConfig, optics, per_class: int, device, with_hybrid: bool = False):
    """The held-out sets of the modular study from the stream 777: controls
    (``generate`` from ``(777, 0)``, unmixed), the same sequences with
    planted tail swaps (``mix_tails_multi`` from ``(777, 1)``) and a
    calibration split (``(777, 2)``). Returns ``{"planted", "control",
    "calibration"}`` data dicts; with ``with_hybrid`` each has its packed
    features (the planted set's of its spliced trajectories)."""
    g = seeded_generator(device, EVAL_STREAM)
    control = generate(fold_in(g, 0), train_cfg, optics, per_class, mix=False)
    keys = ("videos", "labels", "pf_features", "avg")
    planted = dict(zip(keys, mix_tails_multi(fold_in(g, 1), tuple(control[k] for k in keys),
                                             len(train_cfg.training_ds), train_cfg.n_frames)))
    calibration = generate(fold_in(g, 2), train_cfg, optics, per_class, mix=False)
    sets = {"planted": planted, "control": control, "calibration": calibration}
    if with_hybrid:
        for data in sets.values():
            data["hybrid_features"] = pack_hybrid(data)
    return sets


def predict_per_frame(exp: Experiment, name: str, data: Dict[str, torch.Tensor],
                      chunk: int = PREDICT_CHUNK) -> torch.Tensor:
    """Arm ``name``'s per-frame predictions ``(N, F)`` in D units, ``chunk``
    sequences at a time."""
    n = data["videos"].shape[0]
    out = []
    for start in range(0, n, chunk):
        part = {k: (v[start:start + chunk] if torch.is_tensor(v) else v) for k, v in data.items()}
        out.append(exp.predict(name, part)[..., 0])
    return torch.cat(out)


def const_frame_sd(preds: torch.Tensor) -> float:
    """The mean over sequences of the sd (correction 1) of each one's
    per-frame predictions ``(N, F)``."""
    return float(preds.double().std(dim=1).mean())


def _curriculum(continuous) -> str:
    return f"continuous U({continuous[0]}, {continuous[1]})" if continuous else "discrete 4-class"


def _parse_range(text: Optional[str]):
    if not text:
        return None
    lo, hi = (float(x) for x in text.split(","))
    return lo, hi


def _train(exp: Experiment, cycles: int, eval_every: int, dev) -> Tuple[list, float]:
    """Run the experiment; returns each cycle's end (host seconds from the
    start) and the seconds of the whole, synchronised."""
    marks = []
    t0 = time.perf_counter()

    def progress(c, avgs):
        marks.append(time.perf_counter() - t0)
        if (c + 1) % 25 == 0 or c == cycles - 1:
            losses = {n: round(float(v[-1]), 5) for n, v in exp.train_loss.items()}
            print(f"cycle {c + 1}/{cycles} loss {losses}"
                  + (f" val_avg { {k: round(v, 3) for k, v in avgs.items()} }" if avgs else ""), flush=True)

    exp.run(num_cycles=cycles, eval_every=eval_every, callback=progress)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return marks, time.perf_counter() - t0


def run_modular(args, dev) -> dict:
    t_start = time.perf_counter()
    continuous = _parse_range(args.continuous)
    exp = build_modular(args.seed, args.seqs_per_d, args.with_hybrid, continuous, dev)
    exp.build()
    print(f"training {len(exp.arms)} sequence-mode arms, {args.cycles} cycles × {4 * args.seqs_per_d} sequences",
          flush=True)
    marks, train_s = _train(exp, args.cycles, 1, dev)
    print(f"trained in {train_s:.0f}s", flush=True)

    t0 = time.perf_counter()
    sets = planted_sets(exp.train_cfg, exp.optics, args.eval_per_class, dev, args.with_hybrid)
    planted_labels = sets["planted"]["labels"] * exp.train_cfg.d_max_normalization
    scored = {}
    for name in exp.arms:
        preds = {k: predict_per_frame(exp, name, data) for k, data in sets.items()}
        scored[name] = score_planted(preds["planted"], preds["control"], preds["calibration"], planted_labels)
        print(name, json.dumps(select_fields(scored[name], MODULAR_FIELDS)), flush=True)
    eval_s = time.perf_counter() - t0
    first = next(iter(scored.values()))
    report = {"cycles": args.cycles, "seqs_per_d": args.seqs_per_d, "seed": args.seed,
              "eval_per_class": args.eval_per_class, "curriculum": _curriculum(continuous),
              "n_mixed": first["n_mixed"], "n_controls": first["n_controls"],
              **{name: select_fields(s, MODULAR_FIELDS) for name, s in scored.items()}}
    extra = {"seed": args.seed, "scored": scored, "train_loss": {n: [float(v) for v in ls]
                                                                  for n, ls in exp.train_loss.items()},
             "cycle_end_s": marks, "train_s": train_s, "eval_s": eval_s}
    return {**_write(args, dev, "changepoint_modular", report, extra, t_start), "experiment": exp}


def run_demo(args, dev) -> dict:
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline

    t_start = time.perf_counter()
    continuous = _parse_range(args.continuous)
    exp = baseline.build(seed=args.seed, sequences=True, continuous_d=continuous, sequences_per_d=args.seqs_per_d,
                         device=dev)
    exp.build()
    print(f"training {len(exp.model_names)} sequence-mode models, {args.cycles} cycles", flush=True)
    marks, train_s = _train(exp, args.cycles, 10, dev)

    t0 = time.perf_counter()
    cfg = exp.train_cfg.replace(sequences_per_d=DEMO_EVAL_PER_CLASS)
    g = seeded_generator(dev, EVAL_STREAM)
    videos, labels = generate_cycle_data(fold_in(g, 0), cfg, exp.optics)
    mixed, mixed_labels = mix_trajectory_tails(fold_in(g, 1), videos, labels, len(cfg.training_ds), cfg.n_frames)
    cal_videos, cal_labels = generate_cycle_data(fold_in(g, 2), cfg, exp.optics)
    preds = [exp.predict(args.model, {"videos": v, "labels": y})[..., 0]
             for v, y in ((mixed, mixed_labels), (videos, labels), (cal_videos, cal_labels))]
    scored = score_planted(*preds, mixed_labels * cfg.d_max_normalization, threshold=args.score_threshold)
    eval_s = time.perf_counter() - t0
    report = {"model": args.model, "curriculum": _curriculum(continuous), "cycles": args.cycles,
              "seqs_per_d": args.seqs_per_d, **select_fields(scored, DEMO_FIELDS)}
    print(json.dumps(report, indent=2), flush=True)
    extra = {"seed": args.seed, "scored": scored, "const_frame_sd": const_frame_sd(preds[1]),
             "train_loss": {n: [float(v) for v in ls] for n, ls in exp.train_loss.items()},
             "val_avg": {n: h["val_avg"] for n, h in exp.history.items()},
             "cycle_end_s": marks, "train_s": train_s, "eval_s": eval_s}
    return {**_write(args, dev, "changepoint_metrics", report, extra, t_start), "experiment": exp}


def _write(args, dev, stem: str, report: dict, extra: dict, t_start: float) -> dict:
    extra.update(seconds=time.perf_counter() - t_start, command=args.command,
                 device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev), card=card_line(dev))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{stem}.json"), "w") as f:
        json.dump(report, f, indent=2)
    with open(os.path.join(args.out, f"{stem}_report.json"), "w") as f:
        json.dump({"report": report, **extra}, f, indent=1)
    print(f"report -> {args.out}/{stem}.json", flush=True)
    return {"report": report, **extra}


def main(argv=None) -> dict:
    """Run one study; returns ``{"report": the example's fields, ...}`` with
    the unrounded scores, losses and seconds as in ``<stem>_report.json``,
    and the trained ``experiment``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    demo = sub.add_parser("demo", help="the baseline experiment in sequence mode")
    demo.add_argument("--cycles", type=int, default=60)
    demo.add_argument("--seqs-per-d", type=int, default=64)
    demo.add_argument("--model", type=str, default="deepcnn_2layer_s")
    demo.add_argument("--score-threshold", type=float, default=None)
    demo.add_argument("--out", type=str, default="results/torch_changepoint_demo")
    modular = sub.add_parser("modular", help="per-frame feature tokens against images only")
    modular.add_argument("--cycles", type=int, default=150)
    modular.add_argument("--seqs-per-d", type=int, default=256)
    modular.add_argument("--eval-per-class", type=int, default=64)
    modular.add_argument("--with-hybrid", action="store_true")
    modular.add_argument("--out", type=str, default="results/torch_changepoint_modular")
    for p in (demo, modular):
        p.add_argument("--continuous", type=str, default=None, metavar="LO,HI")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return (run_demo if args.command == "demo" else run_modular)(args, dev)


if __name__ == "__main__":
    main()
