#!/usr/bin/env python3
"""Where a training cycle's device time goes, on one NVIDIA GPU.

Usage: ``python3 profile_cycle.py [--batch 1 16] [--out PATH]`` from the
root of a checkout with a CUDA card. For each batch size it runs the
baseline cycle of GeneralTransformer(deep_resnet) at full width and full
data (generate 256 sequences, one AdamW epoch, validate on 4 × 50
sequences), the same body as ``train.loop.run_training``: one cycle to warm
up, one timed cycle, then one cycle under ``torch.profiler``. It prints one
JSON line per batch size: the timed cycle's wall time and sequences/s, the
profiled cycle's wall time (the profiler slows the host), the device's
busy share (union of kernel intervals over the profiled wall time, and
kernel time over the unprofiled wall time), device time by layer (K1
render, K2/K3 embedding, everything else), the top kernels, and the top
host operators by self CPU time under the profiler (with their call
counts). ``--out`` also writes the lines to a file.

``--embedding B T S [B T S ...]`` instead profiles the embedding kernels
alone: for each shape, device time by kernel over 5 calls of K2
(``deep_resnet_embed_fwd``) and of K3 (``deep_resnet_embed_bwd``) on random
inputs, in ms per call, with each kernel's launches per call.
"""

from __future__ import annotations

import argparse
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


def profile(torch, batch: int, val):
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
    from moleculardiffusion_mivit_tpu_torch.train.loop import generate_cycle_data, make_train_impls
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    cfg = TrainConfig(adaptive_batch_size=-1, fixed_batch_size=batch)
    model = GeneralTransformer(ModelConfig(use_pos_encoding=True), embedding="deep_resnet")
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
        "batch": batch, "steps": n_seq // batch,
        "wall_s": plain_wall_s, "seq_per_s": n_seq / plain_wall_s, "profiled_wall_s": wall_s,
        "device_kernel_ms": device_ms, "device_busy_share_profiled": busy_ms / (wall_s * 1e3) if intervals else None,
        "device_busy_share_est": device_ms / (plain_wall_s * 1e3) if intervals else None,
        "by_layer_ms": {k: v / 1e3 for k, v in sorted(by_layer.items())},
        "top_kernels_ms": [[name[:90], t / 1e3] for name, t in top],
        "top_host_self_ms": [[name[:60], t / 1e3, n] for name, t, n in host],
        "train_loss": loss, "val_mse": mses,
    }


def profile_embedding(torch, b: int, t: int, s: int, calls: int = 5):
    """Device ms per call, by kernel, of K2 and of K3 at one shape."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe

    gen = torch.Generator(device="cuda").manual_seed(b + t + s)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    weights = tuple(rand(*shape) / shape[0] ** 0.5 for _, shape in fe.WEIGHT_SHAPES)
    sc, bi = 1.0 + 0.1 * rand(7, 128), 0.1 * rand(7, 128)
    wfc, bfc = rand(128, 64) / 128 ** 0.5, 0.1 * rand(64)
    x, g = 0.3 * rand(b * t, s, s) + 0.1, rand(b * t, 64)
    _, _, saved = fe.deep_resnet_embed_fwd(x, weights, sc, bi, wfc, bfc)
    fe.deep_resnet_embed_bwd(x, weights, sc, bi, wfc, bfc, saved, g)
    torch.cuda.synchronize()
    row = {"embedding_shape": [b, t, s], "rows": b * t * s * s}
    passes = {
        "k2": lambda: fe.deep_resnet_embed_fwd(x, weights, sc, bi, wfc, bfc),
        "k3": lambda: fe.deep_resnet_embed_bwd(x, weights, sc, bi, wfc, bfc, saved, g),
    }
    for name, fn in passes.items():
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
            "device_ms_per_call": sum(by_name.values()) / 1e3 / calls,
            "busy_ms_per_call": _busy_us(span) / 1e3 / calls,
            "kernels": [[k[:70], v / 1e3 / calls, count[k] / calls]
                        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])],
        }
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--embedding", type=int, nargs="+", default=None, metavar="B_T_S",
                    help="profile K2/K3 alone at these (B, T, S) shapes")
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
    if args.embedding:
        if len(args.embedding) % 3:
            ap.error("--embedding takes B T S triples")
        lines = []
        for i in range(0, len(args.embedding), 3):
            lines.append(json.dumps({"card": card, **profile_embedding(torch, *args.embedding[i:i + 3])}))
            print(lines[-1], flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("\n".join(lines) + "\n")
        return
    trajs = generate_frozen_validation(d_values=(1, 3, 5, 7), device="cuda")
    trajs.pop("valTrajsInOrder")
    rendered = render_validation_videos(trajs, TrainConfig(), BASELINE_OPTICS, device="cuda")
    val = {float(k[3:]): v for k, v in rendered.items()}
    lines = []
    for b in args.batch:
        row = {"card": card, **profile(torch, b, val)}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
