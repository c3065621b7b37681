"""Inference (serving) throughput of the flagship MiViT on the card.

Port of ``examples/serving_benchmark.py``: the eval-mode forward of the
poster architecture (``GeneralTransformer`` with the deep-ResNet embedding,
``ModelConfig()``: embed 64, 4 heads, FFN 128, 6 layers, 30 frames of 9×9)
under ``torch.inference_mode()``, swept over serving batch sizes, from
weights initialised from ``--seed`` (``models.init_model``).

- The sweep prints one JSON row a batch (``batch``, ``latency_ms``,
  ``seqs_per_sec``) and then ``{"peak_seqs_per_sec", "at_batch"}``; the
  card's ``nvidia-smi`` line goes to stderr.
- ``--tta`` adds ``tta_latency_ms`` and ``tta_cost_factor``: the mean of
  the predictions over the videos rotated by 0, 90, 180 and 270°.
- ``--bf16`` serves in bfloat16: the parameters, the BatchNorm running
  statistics and the videos cast once, the predictions returned in f32; it
  adds ``max_pred_delta_d_units``, max |bf16 − f32| × 10 on the same batch.
- ``--per-arm OUT.json`` times the five poster arms' forwards (MSD_Frame,
  ft_mlp, im_resnet, im_tr, im_ft_early_tr), each on its own kind of input,
  at ``--batches[0]``, and writes ``{arm: [mean_ms, std_ms]}`` per 10k
  sequences, floored at 0: beside a run's ``*_errors.csv`` as
  ``inference_times.json`` it is what ``evaluation.plots.render_all``
  draws ``accuracy_vs_cost.png`` from. Costs are the arms' forwards only.
- ``--cold-start`` reports the wall time from a process-fresh model to its
  first prediction at ``--batches[0]``, in the example's keys. The port has
  no AOT executable cache, so ``source`` is ``"none"`` and ``lower_s``,
  ``compile_s`` and ``deserialize_s`` are null; ``capture_s`` is the CUDA
  graph's warm-up calls (the first pays cuDNN's and cuBLAS's set-up) and
  capture.

Timing on the card: every forward is captured in a CUDA graph (one per arm
and batch size, static input buffers, after a warm-up on a side stream) and
timed by CUDA events around ``--iters`` replays; the captured forward must
equal the eager one bitwise (``RuntimeError`` otherwise). The MSD_Frame and
ft_mlp forwards take microseconds, near one replay's launch cost: they are
timed as the slope between graphs of ``n`` and ``4n`` forwards back to back
(``n = --iters``). ``--per-arm`` reports the mean and sd over five repeats.
On the CPU (``--device cpu``) the same rows come from the host clock around
eager calls; they are CPU numbers.

No kernel of the port runs here: the eval-mode deep-ResNet embedding runs
cuDNN convolutions in f32 (``ops.fused_embedding.f32_convolutions``), as the
JAX package routes it to XLA at ``train=False``.

Run: python -m moleculardiffusion_mivit_tpu_torch.evaluation.serving
     [--batches 256 1024 4096] [--iters 20] [--tta] [--bf16]
     [--per-arm OUT.json] [--cold-start] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
from typing import Callable, Dict, Sequence

import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.experiments.base import rotate_videos
from moleculardiffusion_mivit_tpu_torch.experiments.images_features import MSD_MULT_FACTOR_AVG, FeatureMLP
from moleculardiffusion_mivit_tpu_torch.features import N_FEATURES, d_from_msd_tau1
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet, init_model
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

FRAMES = 30
ARMS = ("MSD_Frame", "ft_mlp", "im_resnet", "im_tr", "im_ft_early_tr")
SLOPE_ARMS = ("MSD_Frame", "ft_mlp")  # microseconds a forward: timed by the slope
REPEATS = 5
WARMUP = 3
# the poster model's width and depth (the tests shrink it here)
MODEL_CONFIG = ModelConfig()


def flagship() -> GeneralTransformer:
    """The poster's MiViT: ``GeneralTransformer`` with the deep-ResNet
    embedding, at ``MODEL_CONFIG``."""
    return GeneralTransformer(MODEL_CONFIG, embedding="deep_resnet")


def arm_models() -> Dict[str, torch.nn.Module]:
    """The four learned poster arms, as the example builds them."""
    cfg = MODEL_CONFIG
    return {
        "ft_mlp": FeatureMLP(),
        "im_resnet": MultiImageResNet(),
        "im_tr": GeneralTransformer(cfg, embedding="deep_resnet"),
        "im_ft_early_tr": GeneralTransformer(cfg, embedding="deep_resnet", use_global_features=True,
                                             fusion_type="early", global_feature_dim=N_FEATURES),
    }


def initialised(model: torch.nn.Module, seed: int, device, *keys: int) -> torch.nn.Module:
    """``model`` initialised from the CPU stream ``(seed, *keys)`` (the
    same weights on every device), on ``device``, in eval mode."""
    return init_model(model, seeded_generator("cpu", seed, *keys)).to(device).eval()


def make_videos(seed: int, batch: int, device) -> torch.Tensor:
    """``(batch, 30, S, S)`` standard-normal videos from the CPU stream
    ``(seed, batch)``, as the example draws them from ``fold_in(key, b)``."""
    shape = (batch, FRAMES, MODEL_CONFIG.patch_size, MODEL_CONFIG.patch_size)
    return torch.randn(shape, generator=seeded_generator("cpu", seed, batch)).to(device)


def arm_inputs(seed: int, batch: int, device) -> Dict[str, torch.Tensor]:
    """The per-arm inputs: videos, the 25 features, and ``(batch, 30, 2)``
    random-walk trajectories, each from its own CPU stream."""
    g = lambda k: seeded_generator("cpu", seed, batch, k)  # noqa: E731
    s = MODEL_CONFIG.patch_size
    return {
        "videos": torch.randn((batch, FRAMES, s, s), generator=g(0)).to(device),
        "features": torch.randn((batch, N_FEATURES), generator=g(1)).to(device),
        "trajs": torch.cumsum(torch.randn((batch, FRAMES, 2), generator=g(2)), dim=1).to(device),
    }


def bf16_forward(model: torch.nn.Module) -> Callable:
    """The serving cast: a copy of ``model`` with every parameter and float
    buffer (the BatchNorm running statistics) in bfloat16, fed bfloat16
    videos; its predictions come back in f32."""
    half = copy.deepcopy(model).to(torch.bfloat16)
    return lambda videos: half(videos.to(torch.bfloat16)).float()


def tta(forward: Callable) -> Callable:
    """The 4-rotation test-time augmentation of ``forward``: the mean of its
    predictions over the videos rotated by 0, 90, 180 and 270°."""
    return lambda videos: torch.stack([forward(rotate_videos(videos, k)) for k in range(4)]).mean(dim=0)


def msd_frame(trajs: torch.Tensor) -> torch.Tensor:
    """The MSD_Frame arm: MSD(τ=1) of frame-averaged trajectories × 37.5."""
    return d_from_msd_tau1(trajs) * MSD_MULT_FACTOR_AVG


def per_arm_forwards(models: Dict[str, torch.nn.Module]) -> Dict[str, tuple]:
    """``{arm: (forward, names of its inputs)}`` for the five poster arms,
    the learned ones ``models`` (``arm_models()``'s names)."""
    return {
        "MSD_Frame": (msd_frame, ("trajs",)),
        "ft_mlp": (models["ft_mlp"], ("features",)),
        "im_resnet": (models["im_resnet"], ("videos",)),
        "im_tr": (models["im_tr"], ("videos",)),
        "im_ft_early_tr": (models["im_ft_early_tr"], ("videos", "features")),
    }


class Served:
    """``reps`` calls of ``fn`` back to back on ``inputs``, timed by
    ``seconds``. On the card: one CUDA graph over static copies of the
    inputs, captured after a warm-up on a side stream, its replays timed by
    CUDA events. On the CPU: eager calls timed by the host clock."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], reps: int = 1):
        self.fn, self.inputs, self.reps = fn, tuple(inputs), reps
        self.graph = None
        if self.inputs[0].device.type != "cuda":
            return
        self.static = tuple(x.clone() for x in self.inputs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*self.static)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(reps):
                self.out = fn(*self.static)

    def __call__(self) -> torch.Tensor:
        if self.graph is None:
            for _ in range(self.reps):
                out = self.fn(*self.inputs)
            return out
        self.graph.replay()
        return self.out

    def seconds(self, iters: int) -> float:
        """Seconds for one call (``reps`` forwards), the mean over
        ``iters`` after one untimed."""
        self()
        if self.graph is None:
            t0 = time.perf_counter()
            for _ in range(iters):
                self()
            return (time.perf_counter() - t0) / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            self.graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters


def _release(device) -> None:
    """Give the memory of graphs just dropped back to the card."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def served(fn: Callable, inputs: Sequence[torch.Tensor], reps: int = 1) -> Served:
    """``Served(fn, inputs, reps)``, raising where the graph's output is not
    bitwise the eager call's. The eager call runs first and its memory goes
    back before the capture: at batch 4096 one f32 forward peaks at ~39 GB,
    so a graph and an eager forward do not fit on the card together."""
    want = fn(*inputs)
    _release(want.device)
    s = Served(fn, inputs, reps)
    if s.graph is not None and not torch.equal(s(), want):
        raise RuntimeError("the captured forward differs from the eager forward")
    return s


def arm_seconds(fn: Callable, inputs: Sequence[torch.Tensor], iters: int, slope: bool) -> list:
    """Seconds a forward, one value a repeat: with ``slope`` the slope
    between calls of ``iters`` and ``4·iters`` forwards back to back."""
    if not slope:
        s = served(fn, inputs)
        return [s.seconds(iters) for _ in range(REPEATS)]
    lo, hi = served(fn, inputs, iters), served(fn, inputs, 4 * iters)
    return [(hi.seconds(iters) - lo.seconds(iters)) / (3 * iters) for _ in range(REPEATS)]


def per_arm(out_path: str, batch: int, iters: int, seed: int, device) -> Dict[str, list]:
    """Time each poster arm's forward at ``batch`` and write ``{arm:
    [mean_ms, std_ms]}`` per 10k sequences (floored at 0) to ``out_path``."""
    inputs = arm_inputs(seed, batch, device)
    models = {name: initialised(m, seed, device, 1000 + i) for i, (name, m) in enumerate(arm_models().items())}
    scale = 10_000 / batch * 1e3  # seconds a forward -> ms per 10k sequences
    times = {}
    for name, (fn, keys) in per_arm_forwards(models).items():
        runs = arm_seconds(fn, [inputs[k] for k in keys], iters, name in SLOPE_ARMS)
        mean, sd = statistics.fmean(runs), statistics.stdev(runs)
        times[name] = [round(max(mean, 0.0) * scale, 4), round(sd * scale, 4)]
        print(json.dumps({name: times[name]}), flush=True)
    with open(out_path, "w") as fh:
        json.dump(times, fh, indent=1)
    print(f"wrote {out_path}", file=sys.stderr)
    return times


def cold_start(batch: int, seed: int, device) -> dict:
    """A fresh flagship model to its first prediction at ``batch``, every
    phase timed on the host clock (the first use of the card, its context,
    is inside ``model_init_s``)."""
    t_start = time.perf_counter()
    model = initialised(flagship(), seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_init = time.perf_counter()
    videos = make_videos(seed, batch, device)
    row = {"batch": batch, "source": "none", "model_init_s": round(t_init - t_start, 2), "lower_s": None,
           "compile_s": None, "deserialize_s": None}
    s = Served(model, (videos,))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        row["capture_s"] = round(time.perf_counter() - t_init, 2)
    out = s()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    row["first_prediction_s"] = round(time.perf_counter() - t_start, 2)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("the first prediction is not finite")
    print(json.dumps(row), flush=True)
    return row


def sweep(batches: Sequence[int], iters: int, seed: int, device, with_tta: bool, bf16: bool) -> dict:
    """The example's default mode; returns its rows, the peak and the
    ``(batch, forward)`` pairs whose CUDA graph was held bitwise against
    the eager call (the sweep raises where one differs; none on the
    CPU)."""
    model = initialised(flagship(), seed, device)
    forward = bf16_forward(model) if bf16 else model
    rows, held = [], []
    for b in batches:
        videos = make_videos(seed, b, device)
        if bf16:  # the f32 predictions first: at batch 4096 one f32 forward peaks at ~39 GB
            reference = model(videos)
            _release(device)
        plain = served(forward, (videos,))
        if plain.graph is not None:
            held.append((b, "plain"))
        sec = plain.seconds(iters)
        row = {"batch": b, "latency_ms": round(sec * 1e3, 2), "seqs_per_sec": round(b / sec)}
        if bf16:
            delta = float((plain() - reference).abs().max())
            row["max_pred_delta_d_units"] = round(delta * 10.0, 5)
        # one graph alive at a time: a graph at batch 4096 holds ~33-39 GB
        del plain
        _release(device)
        if with_tta:
            rotated = served(tta(forward), (videos,))
            if rotated.graph is not None:
                held.append((b, "tta"))
            tta_sec = rotated.seconds(iters)
            row["tta_latency_ms"] = round(tta_sec * 1e3, 2)
            row["tta_cost_factor"] = round(tta_sec / sec, 2)
            del rotated
            _release(device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    best = max(rows, key=lambda r: r["seqs_per_sec"])
    peak = {"peak_seqs_per_sec": best["seqs_per_sec"], "at_batch": best["batch"]}
    print(json.dumps(peak), flush=True)
    return {"rows": rows, "peak": peak, "captured_equals_eager": held}


def main(argv=None) -> dict:
    """Run the mode the arguments name; returns what it printed, with the
    card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[256, 1024, 4096])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tta", action="store_true",
                    help="also time the 4-rotation test-time-augmentation forward to pin its cost factor")
    ap.add_argument("--bf16", action="store_true",
                    help="serve in bfloat16 (parameters, running statistics and videos cast once; predictions "
                         "returned in f32) and report the max prediction delta against the f32 forward")
    ap.add_argument("--per-arm", metavar="OUT_JSON", default=None,
                    help="time the five poster arms instead and write {arm: [mean_ms, std_ms]} per 10k sequences "
                         "(feeds evaluation.plots.plot_accuracy_vs_cost)")
    ap.add_argument("--cold-start", action="store_true",
                    help="measure the wall time from a fresh model to its first prediction instead")
    ap.add_argument("--seed", type=int, default=0, help="the weights' and inputs' seed")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    print(json.dumps({"card": card}), file=sys.stderr, flush=True)
    with torch.inference_mode():
        if args.per_arm:
            return {"card": card, "per_arm": per_arm(args.per_arm, args.batches[0], args.iters, args.seed, dev)}
        if args.cold_start:
            return {"card": card, "cold_start": cold_start(args.batches[0], args.seed, dev)}
        return {"card": card, **sweep(args.batches, args.iters, args.seed, dev, args.tta, args.bf16)}


if __name__ == "__main__":
    main(sys.argv[1:])
