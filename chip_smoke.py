#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MiViT on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with a CUDA card, ``nvcc`` and PyTorch built for CUDA. Phases, one JSON
line each on stdout:

1. device: the card's name and power limit; build every kernel under
   ``moleculardiffusion_mivit_tpu_torch/csrc/`` with ``nvcc`` (in parallel).
2. k1: the render kernel against its plain version at the main-path shape
   (7680 frames of 10 sub-positions, 9×9, u=5) and at 13×13.
3. k2_k3: the deep-ResNet embedding forward (K2) and backward (K3)
   against autograd through the plain version, TF32 off, at five shapes
   (among them both batch sizes of the main path, and every conv tile);
   two calls on the same inputs must agree bitwise; the kernel launches
   inside one forward and one backward are counted by kind.
4. slice: the training cycle of GeneralTransformer(deep_resnet) at full
   width and full data through ``train.loop.run_training`` for 2 cycles
   (batch 8, then 16), after rendering the validation suite; launch
   counters reset just before and read just after.

Then a ``kernels`` line with each kernel's launches on the main path, error,
times (``ms`` around the wrapper, ``device_ms`` of its launches alone) and
bound, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Without a CUDA device, or without the package beside this file,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "moleculardiffusion_mivit_tpu_torch"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12  # H100 SXM dense TF32 on the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, device_only: bool = False) -> float:
    """Median time of one call between two CUDA events, after warm-up. The
    card idles while the host prepares and launches, so this includes the
    wrapper's host time wherever the host is the slower side. With
    ``device_only`` the card is first kept busy for ~1 ms, the call's
    launches queue up behind that, and the events bracket their execution
    alone (for calls whose host time is below that millisecond)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, flops: float, flops_3xtf32: float = 0.0):
    """Least time (ms) for ``nbytes`` moved, ``flops`` f32 operations outside
    the tensor cores and ``flops_3xtf32`` f32-grade operations that the
    kernel runs as three TF32 tensor-core operations each; and what bounds
    it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOP_PER_S + 3 * flops_3xtf32 / PEAK_TF32_FLOP_PER_S) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations (3xTF32)" if flops_3xtf32 else "operations"


def phase_k1(torch):
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS
    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames, render_frames_reference

    sigma, u, p, b = BASELINE_OPTICS.gaussian_sigma_hr, BASELINE_OPTICS.upsampling_factor, 10, 256 * 30
    g = torch.Generator(device="cuda").manual_seed(0)
    x = 4.0 * torch.randn((b, p), generator=g, device="cuda")
    y = 4.0 * torch.randn((b, p), generator=g, device="cuda")
    w = 458.0 + 50.0 * torch.randn((b, p), generator=g, device="cuda")
    rows = {}
    for s in (9, 13):
        got = render_frames(x, y, w, sigma, s, u)
        ref = render_frames_reference(x, y, w, sigma, s, u)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        check(bool(torch.isfinite(got).all()), f"K1 S={s}: non-finite frames")
        check(err <= 1e-5 * scale, f"K1 S={s}: max|Δ| {err} > 1e-5·{scale}")
        ms = time_ms(torch, lambda: render_frames(x, y, w, sigma, s, u))
        device_ms = time_ms(torch, lambda: render_frames(x, y, w, sigma, s, u), device_only=True)
        plain_ms = time_ms(torch, lambda: render_frames_reference(x, y, w, sigma, s, u))
        g_pts = s * u
        nbytes = 4 * (3 * b * p + b * s * s)
        # per (frame, p, axis, grid point): sub, mul, div, exp, add; per
        # (frame, p): the peak product, division and S row scalings; per
        # output pixel and p: one multiply-add
        flops = b * p * (2 * g_pts * 5 + 2 + s) + b * s * s * p * 2
        bound_ms, by = bound(nbytes, flops)
        rows[s] = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=by)
        emit({"phase": "k1", "B": b, "P": p, "S": s, "u": u, "tol": 1e-5 * scale, **rows[s]})
    return rows[9]


def _embedding_inputs(torch, b, t, s, seed):
    from moleculardiffusion_mivit_tpu_torch.models import DeepResNetEmbedding, init_model

    mod = init_model(DeepResNetEmbedding(s, 64), torch.Generator().manual_seed(seed)).cuda()
    r1, r2 = mod.res_block1, mod.res_block2
    hwio = lambda c: c.weight.detach().permute(2, 3, 1, 0).contiguous().requires_grad_()  # noqa: E731
    kernels = {
        "initial": hwio(mod.initial_conv),
        "rb1_conv1": hwio(r1.conv1), "rb1_conv2": hwio(r1.conv2), "rb1_skip": hwio(r1.skip_conv),
        "rb2_conv1": hwio(r2.conv1), "rb2_conv2": hwio(r2.conv2), "rb2_skip": hwio(r2.skip_conv),
    }
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bns = mod._bns()
    scales = {k: (1.0 + 0.1 * torch.randn(m.weight.shape, generator=gen, device="cuda")).requires_grad_()
              for k, m in bns.items()}
    biases = {k: (0.1 * torch.randn(m.bias.shape, generator=gen, device="cuda")).requires_grad_()
              for k, m in bns.items()}
    wfc = mod.fc.weight.detach().t().contiguous().requires_grad_()
    bfc = (0.1 * torch.randn(64, generator=gen, device="cuda")).requires_grad_()
    x = (0.3 * torch.randn((b, t, s, s), generator=gen, device="cuda") + 0.1).requires_grad_()
    return x, kernels, scales, biases, wfc, bfc


def _embedding_flops(r, n, e):
    """``(simt, tensor_core)`` f32-grade operations of one forward: the
    initial conv and the fc run outside the tensor cores, the six convs at
    32..128 channels on them."""
    convs = 9 * 32 * 64 + 9 * 64 * 64 + 32 * 64 + 9 * 64 * 128 + 9 * 128 * 128 + 64 * 128
    return 2 * r * 9 * 1 * 32 + 2 * n * 128 * e, 2 * r * convs


def _defined(fe, outs):
    """The tensors of a K2 or K3 result without the undefined tails of the
    (7, ., 128) per-BN rows."""
    flat = []
    for t in outs:
        if t.ndim >= 2 and t.shape[0] == 7 and t.shape[-1] == 128:
            flat += [t[i, ..., :c] for i, (_, c) in enumerate(fe.BN_LAYOUT)]
        else:
            flat.append(t)
    return flat


def phase_k2_k3(torch):
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe

    record = None
    # Batch 1, 16 and 13x13 are the timed shapes; batch 8 (19,440 rows, what
    # cycle 0 of the main path below runs) and batch 4 (9,720 rows) are here
    # because the conv picks its tile from (rows, channels): between them the
    # five shapes launch every tile the launcher can choose (conv_rows.cuh).
    for (b, t, s) in ((1, 30, 9), (16, 30, 9), (1, 10, 13), (8, 30, 9), (4, 30, 9)):
        x, kernels, scales, biases, wfc, bfc = _embedding_inputs(torch, b, t, s, seed=b + t + s)
        leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
        emb_k, st_k = fe.fused_deep_resnet_embed(x, kernels, scales, biases, wfc, bfc)
        emb_r, st_r = fe.deep_resnet_embed_reference(x, kernels, scales, biases, wfc, bfc)
        err_fwd = float((emb_k - emb_r).detach().abs().max())
        check(torch.allclose(emb_k, emb_r, rtol=1e-4, atol=1e-4), f"K2 {b,t,s}: emb max|Δ| {err_fwd}")
        for name, _ in fe.BN_LAYOUT:
            for i, what in enumerate(("mean", "var")):
                check(torch.allclose(st_k[name][i], st_r[name][i], rtol=1e-4, atol=1e-4),
                      f"K2 {b,t,s}: {name} {what} differs")
        n, r, e = b * t, b * t * s * s, 64
        weights = [
            kernels["initial"].detach().reshape(9, 32), fe._pack_w3(kernels["rb1_conv1"].detach()),
            kernels["rb1_skip"].detach().reshape(32, 64), fe._pack_w3(kernels["rb1_conv2"].detach()),
            fe._pack_w3(kernels["rb2_conv1"].detach()), kernels["rb2_skip"].detach().reshape(64, 128),
            fe._pack_w3(kernels["rb2_conv2"].detach()),
        ]
        weights = tuple(w.contiguous() for w in weights)
        sc = fe._pack_rows([v.detach() for v in scales.values()]).contiguous()
        bi = fe._pack_rows([v.detach() for v in biases.values()]).contiguous()
        xs = x.detach().reshape(n, s, s).contiguous()
        wf, bf = wfc.detach(), bfc.detach()
        emb_1, stats_1, saved = fe.deep_resnet_embed_fwd(xs, weights, sc, bi, wf, bf)
        stages_fwd = fe.last_stage_launches()

        # Gradients. K3 is held, at 1e-3·max|g| per gradient, against
        # autograd in float64 through the plain version given K2's ReLU
        # pattern (read from K2's saved activations). Without that pin, two
        # f32 implementations put a few of the ~10^7 ReLU inputs of a 38,880-
        # row batch on opposite sides of 0, and each such element moves the
        # input gradient at its pixels by percents of max|g|; so against
        # autograd through the plain f32 version, with its own pattern, the
        # relative L2 error is held to 1e-2 and reported. The upstream
        # gradient is random, as a training loss's is per frame and channel.
        g_out = torch.randn(emb_r.shape, generator=torch.Generator(device="cuda").manual_seed(b * s),
                            device="cuda")
        leaves64 = [v.detach().double().requires_grad_() for v in leaves]
        it = iter(leaves64[1:])
        args64 = ({k: next(it) for k in kernels}, {k: next(it) for k in scales},
                  {k: next(it) for k in biases}, next(it), next(it))
        masks = iter([(saved[k] > 0).reshape(n, s, s, -1).permute(0, 3, 1, 2).double()
                      for k in ("a", "z1", "y1", "z1b", "y2")])
        flips = 0

        def relu_as_k2(z):
            nonlocal flips
            m = next(masks)
            flips += int(((z > 0).double() != m).sum())
            return z * m

        emb_d, _ = fe.deep_resnet_embed_reference(leaves64[0], *args64, relu=relu_as_k2)
        grads_k = torch.autograd.grad(emb_k, leaves, g_out, retain_graph=True)
        grads_r = torch.autograd.grad(emb_r, leaves, g_out, retain_graph=True)
        grads_d = torch.autograd.grad(emb_d, leaves64, g_out.double())
        err_bwd, worst, worst_l2 = 0.0, 0.0, 0.0
        for i, (gk, gr, gd) in enumerate(zip(grads_k, grads_r, grads_d)):
            scale = float(gd.abs().max())
            ek = float((gk.double() - gd).abs().max())
            check(ek <= 1e-3 * scale, f"K3 {b,t,s}: gradient {i} max|Δ| {ek} > 1e-3·{scale}")
            l2 = float((gk.double() - gr.double()).norm() / gr.double().norm())
            check(l2 <= 1e-2, f"K3 {b,t,s}: gradient {i} relative L2 {l2} to the plain f32 version")
            err_bwd, worst, worst_l2 = max(err_bwd, ek), max(worst, ek / scale), max(worst_l2, l2)

        # Determinism: a second call of each kernel on the same inputs gives
        # the same bits (fixed-order reductions, no atomics).
        g2 = g_out.reshape(n, e).contiguous()
        emb_2, stats_2, saved_2 = fe.deep_resnet_embed_fwd(xs, weights, sc, bi, wf, bf)
        first = [emb_1, stats_1, *(saved[k] for k, _ in fe.SAVED), saved["pooled"]]
        second = [emb_2, stats_2, *(saved_2[k] for k, _ in fe.SAVED), saved_2["pooled"]]
        for i, (u, v) in enumerate(zip(_defined(fe, first), _defined(fe, second))):
            check(torch.equal(u, v), f"K2 {b,t,s}: output {i} differs between two calls")
        bwd_1 = fe.deep_resnet_embed_bwd(xs, weights, sc, bi, wf, bf, saved, g2)
        stages_bwd = fe.last_stage_launches()
        bwd_2 = fe.deep_resnet_embed_bwd(xs, weights, sc, bi, wf, bf, saved, g2)
        flat = lambda r: _defined(fe, [r[0], *r[1], *r[2:]])  # noqa: E731
        for i, (u, v) in enumerate(zip(flat(bwd_1), flat(bwd_2))):
            check(torch.equal(u, v), f"K3 {b,t,s}: gradient {i} differs between two calls")
        check(stages_fwd["conv_tensor_core"] == 6 and stages_bwd["conv_tensor_core"] == 6
              and stages_bwd["wgrad_tensor_core"] == 6, f"tensor-core stages {stages_fwd} {stages_bwd}")

        fwd_ms = time_ms(torch, lambda: fe.deep_resnet_embed_fwd(xs, weights, sc, bi, wf, bf))
        bwd_ms = time_ms(torch, lambda: fe.deep_resnet_embed_bwd(xs, weights, sc, bi, wf, bf, saved, g2))
        fwd_dev_ms = time_ms(torch, lambda: fe.deep_resnet_embed_fwd(xs, weights, sc, bi, wf, bf),
                             device_only=True)
        bwd_dev_ms = time_ms(torch, lambda: fe.deep_resnet_embed_bwd(xs, weights, sc, bi, wf, bf, saved, g2),
                             device_only=True)
        with torch.no_grad():
            plain_fwd_ms = time_ms(torch, lambda: fe.deep_resnet_embed_reference(
                x, kernels, scales, biases, wfc, bfc))
        plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(emb_r, leaves, g_out, retain_graph=True))
        simt, tensor = _embedding_flops(r, n, e)
        param_bytes = 4 * sum(w.numel() for w in weights) + 4 * (2 * 7 * 128 + 128 * e + e)
        b2, by2 = bound(4 * r + param_bytes + 4 * n * e + 4 * 7 * 2 * 128, simt, tensor)
        # backward: a data-gradient and a weight-gradient product per conv
        b3, by3 = bound(4 * n * e + 4 * r + param_bytes + 4 * r + param_bytes, 2 * simt, 2 * tensor)
        f32_bound = lambda k: bound(0, k * (simt + tensor))[0]  # noqa: E731
        row = {"phase": "k2_k3", "B": b, "T": t, "S": s, "rows": r,
               "deterministic": True,
               "stage_launches": {"k2": stages_fwd, "k3": stages_bwd,
                                  "k2_total": sum(stages_fwd.values()),
                                  "k3_total": sum(stages_bwd.values())},
               "bound_ms_if_f32_simt": {"k2": f32_bound(1), "k3": f32_bound(2)},
               "k3_worst_rel_err": worst, "k3_worst_rel_l2_to_plain_f32": worst_l2,
               "relu_inputs_off_k2_pattern_f64": flips,
               "k2": dict(max_abs_err=err_fwd, ms=fwd_ms, device_ms=fwd_dev_ms, plain_ms=plain_fwd_ms,
                          bound_ms=b2, bound_by=by2),
               "k3": dict(max_abs_err=err_bwd, ms=bwd_ms, device_ms=bwd_dev_ms, plain_ms=plain_bwd_ms,
                          bound_ms=b3, bound_by=by3)}
        emit(row)
        if (b, t, s) == (16, 30, 9):
            record = row
    return record["k2"], record["k3"]


def phase_slice(torch, card):
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.evaluation import (
        load_validation_trajectories,
        render_validation_videos,
    )
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe
    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames
    from moleculardiffusion_mivit_tpu_torch.train.loop import run_training

    cfg = TrainConfig(initial_batch_size=8, adaptive_batch_size=1)
    model = GeneralTransformer(ModelConfig(use_pos_encoding=True), embedding="deep_resnet")
    num_cycles = 2
    n_seq = cfg.sequences_per_d * len(cfg.training_ds)
    steps = sum(n_seq // cfg.batch_size_for_cycle(c) for c in range(num_cycles))

    for k in (render_frames, fe.deep_resnet_embed_fwd, fe.deep_resnet_embed_bwd):
        k.launches = 0
    t0 = time.perf_counter()
    trajs = load_validation_trajectories(length=cfg.n_frames, device="cuda")
    rendered = render_validation_videos(trajs, cfg, BASELINE_OPTICS, device="cuda")
    val = {d: rendered[f"val{d:g}"] for d in (1.0, 3.0, 5.0, 7.0)}
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    marks = [time.perf_counter()]
    state, hist = run_training(model, cfg, BASELINE_OPTICS, val, num_cycles=num_cycles,
                               callback=lambda c, m: marks.append(time.perf_counter()), device="cuda")
    torch.cuda.synchronize()
    launches = {"render_frames": render_frames.launches,
                "deep_resnet_embed_fwd": fe.deep_resnet_embed_fwd.launches,
                "deep_resnet_embed_bwd": fe.deep_resnet_embed_bwd.launches}

    finite = all(math.isfinite(v) for vals in hist.values() for v in vals)
    check(finite, f"non-finite loss or val MSE: {hist}")
    check(hist["train_loss"][1] < hist["train_loss"][0], f"train loss did not fall: {hist['train_loss']}")
    n_val_renders = len(rendered)
    check(launches["render_frames"] == num_cycles * len(cfg.training_ds) + n_val_renders,
          f"K1 launches {launches['render_frames']}")
    check(launches["deep_resnet_embed_fwd"] == steps, f"K2 launches {launches} != {steps} steps")
    check(launches["deep_resnet_embed_bwd"] == steps, f"K3 launches {launches} != {steps} steps")
    for v in rendered.values():
        check(bool(torch.isfinite(v).all()) and v.shape[-2:] == (9, 9), "bad validation videos")
    cycle_s = [b - a for a, b in zip(marks, marks[1:])]
    emit({"phase": "slice", "card": card, "cycles": num_cycles, "steps": steps,
          "batch_sizes": [cfg.batch_size_for_cycle(c) for c in range(num_cycles)],
          "validation_render_s": t_val, "s_per_cycle": cycle_s,
          "seq_per_s": [n_seq / c for c in cycle_s], "history": hist, "launches": launches})
    return launches


def main() -> None:
    if not (ROOT / PKG / "__init__.py").is_file():
        fail(f"the {PKG} package is not beside this script")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from moleculardiffusion_mivit_tpu_torch.ops._build import build_all, load_library

    card = card_line()
    t0 = time.perf_counter()
    reports = build_all()
    for lib in ("render", "fused_embedding"):
        load_library(lib)
    build_s = time.perf_counter() - t0
    for stem, text in reports.items():
        print(f"--- nvcc {stem}.cu\n{text}", file=sys.stderr)
    emit({"phase": "device", "card": card, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s})

    k1 = phase_k1(torch)
    k2, k3 = phase_k2_k3(torch)
    launches = phase_slice(torch, card)

    src = f"{PKG}/csrc"
    kernels = [
        dict(name="render_frames", route="cuda", source=f"{src}/render.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/pallas_render.py:240",
             launches=launches["render_frames"], library_ms=None, **k1),
        dict(name="deep_resnet_embed_fwd", route="cuda", source=f"{src}/fused_embedding.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/fused_embedding.py:350",
             launches=launches["deep_resnet_embed_fwd"], library_ms=None, **k2),
        dict(name="deep_resnet_embed_bwd", route="cuda", source=f"{src}/fused_embedding.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/fused_embedding.py:373",
             launches=launches["deep_resnet_embed_bwd"], library_ms=None, **k3),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
        # "bytes" or "operations"; which operations were counted goes beside it
        what, _, detail = k["bound_by"].partition(" ")
        k["bound_by"] = what
        if detail:
            k["bound_operations"] = detail.strip("()")
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
