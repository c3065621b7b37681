#!/usr/bin/env python3
"""Where a training cycle's device time goes, on one NVIDIA GPU.

Usage: ``python3 profile_cycle.py [--arm NAME ...] [--batch 1 16] [--out PATH]``
from the root of a checkout with a CUDA card. For each arm of the baseline
experiment named (``deepcnn_2layer_s`` unless told otherwise; ``all`` for
the seven) and each batch size it runs the baseline cycle of that model at
full width and full data (generate 256 sequences, one AdamW epoch, validate
on 4 × 50 sequences), the same body as ``train.loop.run_training``: one
cycle to warm up, one timed cycle, then one cycle under ``torch.profiler``.
It prints one JSON line per arm and batch size: the timed cycle's wall time and sequences/s, the
profiled cycle's wall time (the profiler slows the host), the device's
busy share (union of kernel intervals over the profiled wall time, and
kernel time over the unprofiled wall time), device time by layer (K1
render, K2/K3 embedding, everything else), the top kernels, and the top
host operators by self CPU time under the profiler (with their call
counts). ``--out`` also appends each line to a file as it is measured. A
batch-1 cycle runs slowly under the profiler: all seven arms at batch 1 and
16 took 24 minutes on an H100.

``--experiment captured eager`` instead runs the whole baseline experiment
(``experiments.baseline.build`` + ``Experiment.run``: all seven arms, one
generation and validation per cycle) at each ``--batch``, its learned arms'
epochs as captured CUDA graphs and/or eagerly: a first cycle (which captures),
a timed one and a profiled one, with the same device breakdown.
``--experiment images_features [captured] [eager]`` does the same for the
images-features experiment (nine arms; generation computes the 25 features
of 320 sequences), ``--experiment modular`` for the modular experiment as
``run_experiment modular --with-hybrid --in-order`` builds it (eight arms,
seven of them deep-ResNet transformers; generation computes the per-frame
tokens and the 25 features of 320 sequences), ``--experiment psfnoise`` for
the PSF × noise grid (two grid arms of 30 models each, stepped as one
program; generation renders 352 sequences at 5 PSF × 6 noise settings),
``--experiment denoising`` for the denoising grids (two grid arms of 7;
generation renders 256 sequences in four noise variants and RL-TV-
deconvolves one); an experiment's name with no mode runs it captured.

``--compute-dtype bfloat16`` takes every mode at bf16
(``TrainConfig.compute_dtype``; the deep-ResNet arms then run
K2-bf16/K3-bf16, which the layer split counts as the embedding too).

``--embedding B T S [B T S ...]`` instead profiles the embedding kernels
alone: for each shape, device time by kernel over 5 calls of K2
(``deep_resnet_embed_fwd``) and of K3 (``deep_resnet_embed_bwd``) on random
inputs, in ms per call, with each kernel's launches per call, and the wall
ms per call of 20 calls without the profiler; with
``--compute-dtype bfloat16``, of K2-bf16 and K3-bf16 on the same inputs
rounded to bf16; with ``--members M``, over M members in one launch (the
grids' member axis). Each line also carries a hash of K2's and K3's outputs
on its inputs, so two builds of the kernels, each profiled from its own
checkout, can be compared bitwise.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EMBEDDING_KERNELS = ("conv_rows", "wgrad_rows", "sum_chunks", "bn_stats", "bn_act", "bn_bwd",
                     "colsum_final", "pool_fc", "pack_weights", "conv0_", "fc_wgrad")


def _layer(name: str) -> str:
    if "render_frames_kernel" in name:
        return "k1_render"
    if any(k in name for k in EMBEDDING_KERNELS):
        return "k2_k3_embedding"
    return "other"


def _busy_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile(torch, arm: str, batch: int, val, dtype: str = "float32"):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from chip_smoke import baseline_arms
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.train.loop import generate_cycle_data, make_train_impls
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    cfg = TrainConfig(adaptive_batch_size=-1, fixed_batch_size=batch, compute_dtype=dtype)
    model = baseline_arms()[arm]
    init_state, train_cycle, evaluate, _ = make_train_impls(model, cfg, "cuda")
    state = init_state(seeded_generator("cpu", 0, 0))

    def cycle(c):
        videos, labels = generate_cycle_data(seeded_generator("cuda", 0, 1, c), cfg, BASELINE_OPTICS)
        loss = train_cycle(state, videos, labels, seeded_generator("cuda", 0, 2, c), cfg.lr_for_cycle(c), batch)
        mses = [float(torch.mean((evaluate(state, v)[:, 0] - d) ** 2)) for d, v in val.items()]
        return float(loss), mses

    cycle(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cycle(1)
    torch.cuda.synchronize()
    plain_wall_s = time.perf_counter() - t0
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, mses = cycle(2)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    by_name, by_layer, intervals = defaultdict(float), defaultdict(float), []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue  # user annotations (e.g. the optimizer step's range) are not kernels
        a, b = evt.time_range.start, evt.time_range.end
        intervals.append((a, b))
        by_name[evt.name] += b - a
        by_layer[_layer(evt.name)] += b - a
    device_ms = sum(by_name.values()) / 1e3
    busy_ms = _busy_us(intervals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()),
                  key=lambda kv: -kv[1])[:12]
    n_seq = cfg.sequences_per_d * len(cfg.training_ds)
    return {
        "arm": arm, "batch": batch, "compute_dtype": dtype, "steps": n_seq // batch,
        "wall_s": plain_wall_s, "seq_per_s": n_seq / plain_wall_s, "profiled_wall_s": wall_s,
        "device_kernel_ms": device_ms, "device_busy_share_profiled": busy_ms / (wall_s * 1e3) if intervals else None,
        "device_busy_share_est": device_ms / (plain_wall_s * 1e3) if intervals else None,
        "by_layer_ms": {k: v / 1e3 for k, v in sorted(by_layer.items())},
        "top_kernels_ms": [[name[:90], t / 1e3] for name, t in top],
        "top_host_self_ms": [[name[:60], t / 1e3, n] for name, t, n in host],
        "train_loss": loss, "val_mse": mses,
    }


def profile_experiment(torch, name: str, batch: int, fused: bool, dtype: str = "float32"):
    """An experiment's cycle (``name``: baseline, images_features,
    modular, the last with its hybrid arms and the in-order suite's
    training classes, psfnoise or denoising) at full width through ``Experiment.run``,
    at a fixed batch size, captured (``fused``) or eager: one cycle to warm
    up (and capture), one timed, one under the profiler. A grid arm's
    training losses are its members' (a list a cycle)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from chip_smoke import device_kernels
    from moleculardiffusion_mivit_tpu_torch.experiments import get_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments.base import class_sequence_counts

    options = dict(with_hybrid=True, with_in_order=True) if name == "modular" else {}
    exp = get_experiment(name, seed=0, device="cuda", **options).set_compute_dtype(dtype)
    exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
    exp.fused_cycles = fused
    exp.build()
    t0 = time.perf_counter()
    exp.run(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp.run(1, start_cycle=1)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.run(1, start_cycle=2)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    by_name, by_layer, intervals = defaultdict(float), defaultdict(float), []
    for kernel, a, b in device_kernels(torch, prof):  # the raw trace: ~10^6 kernels at batch 1
        intervals.append((a / 1e3, b / 1e3))
        by_name[kernel] += (b - a) / 1e3
        by_layer[_layer(kernel)] += (b - a) / 1e3
    device_ms = sum(by_name.values()) / 1e3
    n_seq = sum(class_sequence_counts(exp.train_cfg.training_ds, exp.train_cfg.sequences_per_d))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "experiment": name, "arms": len(exp.arms), "batch": batch, "compute_dtype": dtype,
        "mode": "captured" if fused else "eager", "steps_per_arm": n_seq // batch,
        "first_cycle_s": first_s, "wall_s": wall_s, "seq_per_s": n_seq / wall_s, "profiled_wall_s": prof_s,
        "device_kernel_ms": device_ms, "kernels": len(intervals),
        "device_busy_share_profiled": _busy_us(intervals) / (prof_s * 1e6) if intervals else None,
        "device_busy_share_est": device_ms / (wall_s * 1e3) if intervals else None,
        "by_layer_ms": {k: v / 1e3 for k, v in sorted(by_layer.items())},
        "top_kernels_ms": [[name[:90], t / 1e3] for name, t in top],
        "captures": exp.engine.captures, "replays": exp.engine.replays,
        "train_loss": {n: [v.tolist() for v in ls] for n, ls in exp.train_loss.items()},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
    }


def _digest(torch, fe, tensors, members: int) -> str:
    """A hash of a K2 or K3 result's bytes: its tensors in order, each
    (7, ., 128) per-BN row cut to its layer's channels (the kernels never
    write the rest)."""
    axis = 1 if members > 1 else 0
    h = hashlib.sha256()
    for v in tensors:
        if v.ndim >= 2 + axis and v.shape[axis] == 7 and v.shape[-1] == 128:
            parts = [v.select(axis, i)[..., :c] for i, (_, c) in enumerate(fe.BN_LAYOUT)]
        else:
            parts = [v]
        for p in parts:
            h.update(p.contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def profile_embedding(torch, b: int, t: int, s: int, calls: int = 5, dtype: str = "float32", members: int = 1):
    """Device ms per call, by kernel, of K2 and of K3 (K2-bf16 and K3-bf16
    with ``dtype`` bfloat16) at one shape, over ``members`` members."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe

    dt = getattr(torch, dtype)
    fwd, bwd = fe.kernels_for(dt)
    gen = torch.Generator(device="cuda").manual_seed(b + t + s)
    lead = (members,) if members > 1 else ()
    rand = lambda *shape: torch.randn(lead + shape, generator=gen, device="cuda").to(dt)  # noqa: E731
    weights = tuple(rand(*shape) / shape[0] ** 0.5 for _, shape in fe.WEIGHT_SHAPES)
    sc, bi = 1.0 + 0.1 * rand(7, 128), 0.1 * rand(7, 128)
    wfc, bfc = rand(128, 64) / 128 ** 0.5, 0.1 * rand(64)
    x, g = 0.3 * rand(b * t, s, s) + 0.1, rand(b * t, 64)
    emb, stats, saved = fwd(x, weights, sc, bi, wfc, bfc)
    grads = bwd(x, weights, sc, bi, wfc, bfc, saved, g)
    torch.cuda.synchronize()
    row = {"embedding_shape": [b, t, s], "members": members, "rows": members * b * t * s * s,
           "compute_dtype": dtype,
           "output_sha256": {
               "k2": _digest(torch, fe, [emb, stats, *(saved[k] for k, _ in fe.SAVED), saved["pooled"]], members),
               "k3": _digest(torch, fe, [grads[0], *grads[1], *grads[2:]], members)}}
    passes = {
        "k2": lambda: fwd(x, weights, sc, bi, wfc, bfc),
        "k3": lambda: bwd(x, weights, sc, bi, wfc, bfc, saved, g),
    }
    for name, fn in passes.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(4 * calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (4 * calls)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name, count, span = defaultdict(float), defaultdict(int), []
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
                continue
            by_name[evt.name] += evt.time_range.end - evt.time_range.start
            count[evt.name] += 1
            span.append((evt.time_range.start, evt.time_range.end))
        row[name] = {
            "wall_ms_per_call": wall_ms,
            "device_ms_per_call": sum(by_name.values()) / 1e3 / calls,
            "busy_ms_per_call": _busy_us(span) / 1e3 / calls,
            "kernels": [[k[:70], v / 1e3 / calls, count[k] / calls]
                        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])],
        }
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", nargs="+", default=["deepcnn_2layer_s"], metavar="NAME",
                    help="arms of the baseline experiment to profile, by its names "
                         "(chip_smoke.baseline_arms; 'all' for the seven)")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--embedding", type=int, nargs="+", default=None, metavar="B_T_S",
                    help="profile K2/K3 alone at these (B, T, S) shapes")
    ap.add_argument("--members", type=int, default=1,
                    help="with --embedding: members in each launch (the grids' member axis)")
    ap.add_argument("--experiment", nargs="+", default=None,
                    choices=("captured", "eager", "baseline", "images_features", "modular", "psfnoise",
                             "denoising"),
                    help="profile an experiment's cycle (Experiment.run) at each --batch, captured "
                         "and/or eager: modes and experiment names (default baseline; a name alone "
                         "runs captured)")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the cycles' compute dtype (TrainConfig.compute_dtype)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_cycle: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.evaluation import (
        generate_frozen_validation,
        render_validation_videos,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("")

    def emit(row) -> None:
        """Print the line and append it to ``--out`` at once, so a run that
        is cut keeps what it had measured."""
        line = json.dumps({"card": card, **row})
        print(line, flush=True)
        if args.out:
            with args.out.open("a") as fh:
                fh.write(line + "\n")

    if args.embedding:
        if len(args.embedding) % 3:
            ap.error("--embedding takes B T S triples")
        for i in range(0, len(args.embedding), 3):
            emit(profile_embedding(torch, *args.embedding[i:i + 3], dtype=args.compute_dtype,
                                   members=args.members))
        return
    if args.experiment:
        names = [e for e in args.experiment if e not in ("captured", "eager")] or ["baseline"]
        modes = [e for e in args.experiment if e in ("captured", "eager")] or ["captured"]
        for name in names:
            for b in args.batch:
                for mode in modes:
                    emit(profile_experiment(torch, name, b, mode == "captured", args.compute_dtype))
        return
    from chip_smoke import baseline_arms

    names = list(baseline_arms())
    arms = names if "all" in args.arm else args.arm
    if set(arms) - set(names):
        ap.error(f"--arm takes {names} or 'all'")
    trajs = generate_frozen_validation(d_values=(1, 3, 5, 7), device="cuda")
    trajs.pop("valTrajsInOrder")
    rendered = render_validation_videos(trajs, TrainConfig(), BASELINE_OPTICS, device="cuda")
    val = {float(k[3:]): v for k, v in rendered.items()}
    for arm in arms:
        for b in args.batch:
            emit(profile(torch, arm, b, val, args.compute_dtype))


if __name__ == "__main__":
    main()
