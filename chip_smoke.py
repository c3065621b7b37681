#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MiViT on one NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with a CUDA card, ``nvcc`` and PyTorch built for CUDA. Phases, one JSON
line each on stdout (a phase's line also carries ``t``, its process's
seconds so far); phases 4-6, 7, 8, 9, 10, 11 + 22, 12 + 14-19, 13 + 20
and 21 in nine processes of their own, each started while the one before
runs:

1. device: the card's name and power limit; build every kernel under
   ``moleculardiffusion_mivit_tpu_torch/csrc/`` with ``nvcc`` (in parallel).
2. k1: the render kernel against its plain version at a baseline cycle's
   frames (7680 of 10 sub-positions, u=5), at one main-path call (1920), 9×9
   and 13×13, at an even grid through its generic instantiation, and at the
   images-features in-order sweep's one call (30,000 frames), and at 13×13
   with the framerate experiment's P = 5 … 50 sub-positions (one class's
   64 × 300 / P frames); beside each, the card's floor for one allocation
   and one (empty) launch. Then with a sigma per PSF setting (the psfnoise
   grid: five settings of one class, 9,600 frames, and of the in-order
   suite, 150,000, in one launch) against five one-sigma launches (bitwise)
   and the plain version.
3. k2_k3: the deep-ResNet embedding forward (K2) and backward (K3)
   against autograd through the plain version, TF32 off, at five shapes
   (among them both batch sizes of the main path, and every conv tile) with
   embed dim 64, at batch 1 and 16 with the modular experiment's 58 and the
   embeddings experiment's 32 and 128, and on the framerate experiment's
   13×13 frames at 60 and 6 a sequence (10,140 to 162,240 and 1,014 to
   16,224 rows); two calls on the same inputs must agree bitwise; the
   kernel launches inside one forward and one backward are counted by kind.
   Then over 30 and 7 members in one launch each (the psfnoise and the
   denoising grid at batch 1 and 16: 72,900 and 1,166,400 rows, 17,010 and
   272,160): bitwise equal to as many one-member launches and repeatable,
   against the plain version under ``torch.vmap``. Then (phase 13's part
   (a), in this process) K2-bf16/K3-bf16 at ``BF16_SHAPES`` (2,430 to
   162,240 rows, S = 9 and 13, E = 58 and 64: every tile of their wgmma
   kernels) against their plain bf16 version (1e-2 / 5e-2 relative L2,
   ``BF16_TOL``), bitwise repeatable, and over 7 members at batch 1 and 16
   bitwise equal to their single launches; each timed beside the f32
   kernels on the same inputs, with the mma.sync kernels' device ms they
   replaced and the share of the bound; and where the toolkit has
   ``cuobjdump``, the count of ``HGMMA`` in each bf16 conv and
   weight-gradient kernel (none fails).
4. slice: the baseline experiment's seven models (GeneralTransformer with
   the linear, cnn and deep_resnet embeddings, relu and leaky_relu each, and
   MultiImageResNet) at full width and full data, each through
   ``train.loop.run_training`` for 2 cycles (batch 8, then 16), after
   rendering the validation suite once; launch counters reset just before
   and read just after, and per model: K1 once per D class and cycle, K2/K3
   once a step for the two deep_resnet models and never for the other five.
5. experiment: the baseline experiment through its own entry points
   (``experiments.baseline.build`` + ``Experiment.run``, then
   ``run_experiment.main``), all seven arms at full width, the learned arms'
   epochs as captured CUDA graphs (``train.capture``). At batch 16 the
   captured and the eager cycle agree (losses, validation MSEs, every
   parameter and buffer; bitwise is reported); at batch 1 the captured
   cycle is timed, a cycle at the cut size profiled (busy share, kernels a
   step), and the host ms of one replay taken. Launches are what ran: wrapper calls less those recorded while
   capturing plus replays × the calls a graph recorded; K2/K3 once a step of
   each deepcnn arm and in no other unit's graph, K1 once per D class and
   cycle plus the validation renders.
6. images_features: the images-features experiment (``experiments.
   images_features.build`` + ``Experiment.run``, then ``run_experiment.main
   --in-order``) at full width: nine arms (three deep-ResNet transformers,
   two with the 25 trajectory features fused early or late; ResNet with and
   without features; the features-only MLP; three MSD estimators), 5 D
   classes × 64 sequences of 30 frames with their features, validation at
   D = 1..9. At batch 16 the captured and the eager cycle agree; at batch 1
   the captured cycle is timed (a cut-size one profiled), generation and the features
   timed on their own; the features of one cycle computed on the card equal
   the CPU's at the CPU test's tolerance; K2/K3 launch 3 × ⌊320/b⌋ times a
   cycle, K1 5 times a cycle in generation; the runner's in-order MSD rows
   equal the JAX record's.
7. modular: the modular experiment with its hybrid arms and the in-order
   suite (``experiments.modular.build`` + ``Experiment.run``, then
   ``run_experiment.main modular --with-hybrid --in-order``) at full width:
   eight arms, seven of them deep-ResNet transformers (one embedding into
   58 dims), 5 D classes × 64 sequences of 30 frames with their per-frame
   tokens and 25 features. As phase 6: captured against eager at batch 16,
   batch 1 timed (a cut-size cycle profiled), the card's per-frame tokens against the
   CPU's; K2/K3 launch 7 × ⌊320/b⌋ times a cycle and never in
   ``mod_features``' graph; the published in-order suite's MSD rows on the
   card equal the JAX record's.
8. embeddings: the embeddings experiment (``experiments.embeddings.build``
   + ``Experiment.run``, then ``run_experiment.main embeddings``) at full
   width: ten arms, the three embeddings' transformers at embed 64, 32 and
   128 and MultiImageResNet, 4 D classes × 64 sequences of 30 frames. As
   phase 7: captured against eager at batch 16, batch 1 timed and profiled;
   K2/K3 launch 3 × ⌊256/b⌋ times a cycle, only in the deepcnn arms' graphs.
9. framerate: the framerate experiment (``experiments.framerate.build`` +
   ``Experiment.run``, then ``run_experiment.main framerate`` and the
   in-order rescore of its checkpoint) at full width: twelve arms, a
   deep-ResNet transformer and a ResNet per exposure, 352 sequences of 300
   steps rendered at six rates on 13×13 frames. As phase 7; K2/K3 launch 6 ×
   ⌊352/b⌋ times a cycle and never in a ResNet's graph, K1 36 times a cycle.
10. psfnoise: the PSF × noise experiment (``experiments.psfnoise.build`` +
   ``Experiment.run``, then ``run_experiment.main psfnoise --in-order``) at
   full width: 60 models in two grid arms of 30 (``train/grid.py``), 352
   sequences rendered into 5 PSF × 6 noise cells. As phase 7: captured
   against eager at batch 16 for every member, batch 1 timed and profiled;
   K2/K3 launch once a grid step for all 30 transformers (⌊352/b⌋ a cycle),
   K1 once a class for all five PSF settings; the runner's error table has
   the JAX record's 60 rows.
11. denoising: the denoising experiment (``experiments.denoising.build`` +
   ``Experiment.run``, then ``run_experiment.main denoising``) at full
   width: 14 models in two grid arms of 7 trained with L1 loss, 256
   sequences rendered into four noise variants and three RL-TV snapshots.
   As phase 10: captured against eager at batch 16 for every member, batch
   1 timed and profiled; K2/K3 launch once a grid step for all 7
   transformers (⌊256/b⌋ a cycle), K1 once a class; then the renderer's
   deterministic part, the filter, RL-TV and ``torch.poisson`` on the card
   against the CPU, and each timed.
12. realdata: the real-data pipeline (``realdata/``): K1 at the wide-field
   shapes (S = 63 at u = 5; P = 60, 100 and a 1,600-frame call) against its
   plain version; the pipeline on the card against the CPU on one movie
   (TIFF round trip, DoG, peaks, tracks, refinement, fallbacks, per-track
   D); the demo through ``realdata.demo.main --train-cycles 5`` at full
   width (K2/K3 16 launches a cycle, K1 one a cycle and one for the movie);
   a camera-size stack of 16 tiles × 10 particles × 100 frames rendered in
   one launch and run through the whole pipeline.
13. bf16: ``compute_dtype="bfloat16"`` (``phase_bf16``): the baseline
   experiment's seven arms captured against eager at batch 16 (bitwise),
   batch 1 timed as f32 is (losses falling by the second timed cycle,
   K2-bf16/K3-bf16 once a step
   of each deepcnn arm, the f32 K2/K3 never), batch 64 timed, and the f32
   cycle at batch 1, 16 and 64 beside it; masters, AdamW state and BN
   buffers f32; denoising's ``trans_grid`` (7 members, 16 sequences a
   class) two cycles at batch 1 and two at 16, the second of each timed; ``utils.flops.multi_cycle_flops`` of the baseline cycle
   and each timed cycle's MFU against the card's bf16 peak.
14. constrained (``phase_constrained``): ``single_state`` off the Brownian
   branch on the card (α = 0.5, 1.5, α ~ N(1, 0.3), with drift, in a box;
   256 × 300 steps), each rendered through K1, the MSD exponent against α;
   the fGn's deterministic part and the reflected and path walks on the
   card against the CPU; ``sim.mitochondria_demo.main --cycles 2`` at full
   width (K1 4 a cycle and 1 for evaluation, K2/K3 64 a cycle).
15. changepoint (``phase_changepoint``): the baseline experiment in sequence
   mode, captured against eager at batch 16 (all seven arms, K2/K3 once a
   step of each deepcnn arm); a planted-transition set; ``detect_change_
   points`` on its per-frame predictions on the card against the CPU.
16. sim2real (``phase_sim2real``): the sim-to-real study. The randomized
   arm's panel render at one cycle's 6,400 frames with the 8 members'
   sigmas in one K1 launch, against the plain version and bitwise against 8
   one-sigma launches; ``realdata.sim2real.main --train-cycles 4
   --movies-per-optics 1`` at full width (K2/K3 16 launches a cycle of each
   arm, K1 one a cycle and one a test row); the nominal row's movie through
   the pipeline on the card against the CPU with both arms' trained weights.
17. changepoint_study (``phase_changepoint_study``): the change-point
   studies. The modular study's three sequence-mode arms (images only,
   per-frame tokens, the hybrid) captured against eager at batch 16; the
   held-out planted, control and calibration sets scored by
   ``score_planted`` on the card against the CPU; one ``main()`` of each
   subcommand (``modular --with-hybrid --cycles 2``, ``demo --cycles 1``);
   K1/K2/K3 launches against the counts the phase computes.
18. ensemble (``phase_ensemble``): the 8-member early-fusion MiViT grid
   with the 25 features, 80 sequences a member (the cut's 16 a class × 5):
   one cycle at batch 16 captured against eager (bitwise), one generation
   call of all members in one K1 launch; ``experiments.ensemble.main
   --members 8 --cycles 2`` and ``experiments.continuous_d.main --cycles
   1`` with the full in-order suites (the ensemble's with the rotation
   TTA): finite losses and tables, K1 once a cycle and once a suite, K2/K3
   once a (grid) step, as the phase computes them.
19. rescore (``phase_rescore``): a 2-cycle images-features run at the cut
   size saved after each cycle as two members; ``tta_rescore``,
   ``seed_ensemble`` at two render seeds and ``render_noise --renders 2``
   over them on the full suite (both renders in one K1 launch); the seed
   ensemble's tables and the render-noise matrix on the card against the
   CPU at 1e-4 on the same checkpoints and data; ``msd_protocol`` (the
   published suite's MSD rows against ``MSD_ROWS``, the closest protocol)
   and ``simulator_validation`` (the 2:1 pixel shift); K1/K2/K3 launches
   against the counts the phase computes.
20. serving (``phase_serving``): ``evaluation.serving.main`` at batches
   256, 1024 and 4096 with the rotation TTA and the bf16 cast, every
   forward captured in a CUDA graph and held bitwise against its eager
   call, and ``--per-arm`` into a temporary file (the five poster arms,
   each ≥ 0); the bf16 prediction delta under
   ``SERVING_BF16_DELTA_LIMIT``; the f32 flagship on the card against the
   CPU (64 sequences, 1e-4 relative); no K1/K2/K3 launch on this path.
21. mesh (``phase_mesh``): ``parallel`` and ``Experiment.use_mesh`` at
   full width and ``MESH_SEQS_PER_D`` = 4 sequences a class, each cycle one
   full-batch step. (a) NCCL at world size 1: the baseline meshed
   captured, meshed eager and unmeshed captured, bitwise equal, each
   second cycle timed. (b) Two ranks on this card over gloo in processes
   of their own (``--mesh-rank``), eager: psfnoise at ``model=2`` (15
   members a rank, K2/K3 over them) and the baseline at ``data=2`` (the
   deep arms' K2/K3 on the gathered rows, global BatchNorm), each first
   step against the same step unsharded on the card (losses at 1e-5
   relative, gradients at 1e-3 of the largest, a ResNet arm's at 1e-1,
   parameters at 2.5·lr, BatchNorm statistics at 1e-3 of their largest,
   replicated arms bitwise equal across ranks); the baseline's step with
   per-rank BatchNorm statistics missing the losses' and the gradients'
   bounds; a captured cycle over gloo raising. (c) With two or more
   cards: NCCL across two or four, the first step held as in (b), then
   two captured cycles (finite losses, replicated arms bitwise equal on
   every rank). (b) and (c) also run ``bf16_dropout``: the baseline cut
   to its deep-ResNet transformer at dropout 0.1 and bf16 compute, the
   batch over ``data`` (K2-bf16/K3-bf16 on the gathered bf16 rows, each
   rank's dropout masks its global rows of the minibatch's), held to the
   JAX package's bounds for its sharded bf16 cycle (``MESH_BF16_*``), its
   masters and AdamW state f32; in (c) its captured NCCL cycles at bf16
   too; its launches listed apart (path ``mesh_bf16_dropout``). In (b)
   and (c) each rank then generates cycle 0 of the
   baseline, images-features, denoising (their classes split over the
   ranks) and psfnoise (classes over ``data``, members over ``model``) at
   the protocol's size through ``Experiment.generate``: its part (K1 on it
   alone), gathered (gloo in (b), NCCL in (c)), bitwise the unsharded
   ``generate_fn`` run beside it on the card; each rank's K1 frames and
   generation ms against the unsharded call's.
   ``chip_smoke.py --mesh-witness`` (not part of the smoke) measures
   whether a grid's step depends on its member count, how far the ResNet
   arm's f32 step lies from float64 in two orders of BatchNorm's sums, and
   what route (b) repeats of K2/K3.
22. dropout (``phase_dropout``): keyed dropout (``models.dropout``) on the
   training path: the baseline cut to ``DROPOUT_ARM`` at dropout 0.1,
   ``CUT_SEQS_PER_D`` sequences a class, through ``Experiment.run``: two
   batch-16 cycles captured and two eager, bitwise equal; the eager first
   step's attention masks (a hook) and every site's mask for that step on
   the card bitwise the CPU's; three captured batch-1 cycles, losses
   finite and falling; the kernels and device ms of one batch-16 replay
   with dropout and at dropout 0; K1/K2/K3 launches against the phase's
   count, listed apart (path ``dropout``).

Depth cut to keep the whole within 900 s (75 % of the 1,200 s limit), no
check dropped. The batch-1 part of every experiment phase and of phase 13
(``_batch_one_profiled``) runs, at the protocol's size, a capture cycle
and one timed cycle (two in phases experiment, embeddings, denoising and
bf16, whose loss check reads the second), and profiles a cycle of an
experiment at
``CUT_SEQS_PER_D`` = 16 sequences a class: the profiler costs ~30 µs of
host time a kernel it records, 95 s for the 3.2 million of one
protocol-size framerate cycle. Each runner call (``run_experiment.main``)
trains its one cycle, and the captured-against-eager cycles of phases 5-11
run, at that cut size too (phases 13 and 15 compare at the protocol's
64), and phase 13's denoising grid.
Phase 13 counts the baseline cycle's FLOPs once (they depend neither on the
batch size nor on the dtype), phases 14-19 share phase 12's process and
phase 20 phase 13's, and each group's process starts up while the group
before it runs.

Then the smoke's total seconds, a ``kernels`` line with each kernel's (K1,
K2, K3, K2-bf16, K3-bf16)
launches on the main paths (by path beside the total), error, times
(``ms`` around the wrapper, ``device_ms`` of its launches alone) and bound,
the card's name and power limit, and as the last line ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero before that line. Without a CUDA device, or without
the package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
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
PEAK_BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
# The JAX package's in-order MSD rows on the published 100-value suite
# (results/images_features_reconciled/metrics.jsonl, event error_tables),
# held at 1e-5 relative: the card's f32 sums differ from the CPU's.
MSD_ROWS = {"MSD_Perfect": 0.10239888891559892, "MSD_Frame": 1.284755779813329}
MSD_RTOL = 1e-5
# sub-positions a frame of the framerate experiment's six exposures
FRAMERATE_RATES = (5, 10, 15, 20, 30, 50)
# sequences a D class (a quarter of the protocol's 64) of the cycles the
# experiment phases run below the protocol's size, where a check holds at
# any size: part (a)'s captured-against-eager cycles (their eager batch-16
# cycles take 1.7-7.1 s at the protocol's size), part (b)'s profiled cycle
# (the profiler's host cost grows with the kernels it records) and the one
# cycle through run_experiment.main (whose files and events are its checks)
CUT_SEQS_PER_D = 16
# sequences a member a cycle of the ensemble phase: the cut's 16 a class × 5
ENSEMBLE_N = 5 * CUT_SEQS_PER_D
# max |bf16 − f32| × 10 of the served flagship (random weights from seed 0)
# at batches 256-4096, set before the first card run at ~3× the CPU's
# largest reading of the same cast (0.17 at batch 8-16, 0.30 at 256, 0.26 at
# 1024): about 13 bf16 ulps of its ~1.3 predictions
SERVING_BF16_DELTA_LIMIT = 1.0
# How far a model that starts on the predict-the-mean plateau may lie above
# its start after the batch-1 cycles (phase psfnoise's tr_3_5): its cycle
# means read 1.014 and 1.012 of its start, and 1.076 in a third cycle (an
# H100 at 700 W); 0.10 holds them, and a model that climbs off fails
PLATEAU_MARGIN = 0.10
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    """One JSON line on stdout; a phase's line also carries ``t``, its
    process's seconds so far (where a phase's time goes)."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True, file=sys.__stdout__)  # also where a phase sends prose to stderr


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


def bound(nbytes: float, flops: float, flops_3xtf32: float = 0.0, flops_bf16: float = 0.0):
    """Least time (ms) for ``nbytes`` moved, ``flops`` f32 operations outside
    the tensor cores, ``flops_3xtf32`` f32-grade operations that the kernel
    runs as three TF32 tensor-core operations each and ``flops_bf16`` bf16
    tensor-core operations; and what bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOP_PER_S + 3 * flops_3xtf32 / PEAK_TF32_FLOP_PER_S
             + flops_bf16 / PEAK_BF16_FLOP_PER_S) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    kind = "3xTF32" if flops_3xtf32 else "bf16" if flops_bf16 else ""
    return t_ops, f"operations ({kind})" if kind else "operations"


def phase_k1(torch):
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS

    sigma, u = BASELINE_OPTICS.gaussian_sigma_hr, BASELINE_OPTICS.upsampling_factor
    g = torch.Generator(device="cuda").manual_seed(0)
    full = 256 * 30  # frames of one cycle; a main-path call renders one D class, 64 * 30
    in_order = 1000 * 30  # the images-features in-order sweep, rendered in one call
    xs = 4.0 * torch.randn((in_order, 50), generator=g, device="cuda")
    ys = 4.0 * torch.randn((in_order, 50), generator=g, device="cuda")
    ws = 458.0 + 50.0 * torch.randn((in_order, 50), generator=g, device="cuda")
    rows = {}
    # (B, P, S): a cycle's frames and one main-path call at both compiled-in
    # patch sizes, an even grid with P = 4 through the generic instantiation,
    # the largest main-path call, and the framerate experiment's calls at
    # 13×13: one class of 64 sequences × 300 steps at each rate's P (P = 10
    # is the main-path call above)
    framerate = tuple((64 * 300 // p, p, 13) for p in FRAMERATE_RATES if p != 10)
    for (b, p, s) in ((full, 10, 9), (full, 10, 13), (64 * 30, 10, 9), (64 * 30, 10, 13), (64 * 30, 4, 10),
                      (in_order, 10, 9)) + framerate:
        x, y, w = (v[:b, :p].contiguous() for v in (xs, ys, ws))
        rows[(b, p, s)] = _k1_row(torch, x, y, w, sigma, s, u, "k1")
    call = rows[(64 * 30, 10, 9)]
    at_s13 = {f"P_{p}": rows[(64 * 300 // p, p, 13)] for p in FRAMERATE_RATES}
    return dict(rows[(full, 10, 9)], ms_per_main_path_call=call["ms"],
                device_ms_per_main_path_call=call["device_ms"], framerate_calls_at_s13=at_s13,
                psf_settings=_k1_psf_settings(torch, g))


def _k1_row(torch, x, y, w, sigma, s, u, phase):
    """K1 on ``(B, P)`` sub-positions against its plain version (1e-5 of the
    largest pixel, bitwise repeatable), timed beside its plain version and
    the card's launch floor, with its bound; emitted as a ``phase`` line and
    returned."""
    from moleculardiffusion_mivit_tpu_torch.ops.render import (
        launch_floor,
        render_frames,
        render_frames_reference,
    )

    b, p = x.shape
    render = lambda: render_frames(x, y, w, sigma, s, u)  # noqa: E731
    got = render()
    ref = render_frames_reference(x, y, w, sigma, s, u)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), f"K1 {b,p,s}: non-finite frames")
    check(err <= 1e-5 * scale, f"K1 {b,p,s}: max|Δ| {err} > 1e-5·{scale}")
    check(torch.equal(got, render()), f"K1 {b,p,s}: two calls differ")
    # 200 timings each: a call is tens of microseconds and the host's share varies
    ms = time_ms(torch, render, iters=200)
    device_ms = time_ms(torch, render, device_only=True)
    plain_ms = time_ms(torch, lambda: render_frames_reference(x, y, w, sigma, s, u))
    # the card's floor for one allocation and one launch, timed the same way
    floor = lambda: launch_floor((b, s, s), "cuda")  # noqa: E731
    floor_ms = time_ms(torch, floor, iters=200)
    floor_device_ms = time_ms(torch, floor, device_only=True)
    g_pts = s * u
    nbytes = 4 * (3 * b * p + b * s * s)
    # per (frame, p, axis, grid point): sub, mul, mul, exp, add; per
    # (frame, p): the peak product, division and S row scalings; per
    # output pixel and p: one multiply-add
    flops = b * p * (2 * g_pts * 5 + 2 + s) + b * s * s * p * 2
    bound_ms, by = bound(nbytes, flops)
    row = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
               launch_floor_ms=floor_ms, launch_floor_device_ms=floor_device_ms)
    emit({"phase": phase, "B": b, "P": p, "S": s, "u": u, "tol": 1e-5 * scale, **row})
    return row


def _k1_psf_settings(torch, g):
    """K1 with one sigma per PSF setting (the psfnoise grid renderer): the
    five settings of one class (64 sequences × 30 frames each, 9,600
    frames) and of the in-order suite (1,000 × 30 each, 150,000) in one
    launch, against the plain version with the sigmas broadcast (1e-5 of the
    largest pixel) and bitwise against five one-sigma launches, which are
    timed beside it."""
    from moleculardiffusion_mivit_tpu_torch.config import PSFNOISE_OPTICS
    from moleculardiffusion_mivit_tpu_torch.experiments.psfnoise import PSF_SETTINGS
    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames, render_frames_reference

    base = PSFNOISE_OPTICS.replace(psf_division_factor=1.0).gaussian_sigma_hr
    sigmas = tuple(base / ps for ps in PSF_SETTINGS)
    k, p, s, u = len(sigmas), 10, 9, PSFNOISE_OPTICS.upsampling_factor
    out = {}
    for per in (64 * 30, 1000 * 30):
        b = k * per
        x, y = (4.0 * torch.randn((b, p), generator=g, device="cuda") for _ in range(2))
        w = 500.0 + 50.0 * torch.randn((b, p), generator=g, device="cuda")
        render = lambda: render_frames(x, y, w, sigmas, s, u)  # noqa: E731

        def scalar_launches():
            return torch.cat([render_frames(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per],
                                            w[i * per:(i + 1) * per], sig, s, u) for i, sig in enumerate(sigmas)])

        def plain():
            runs = (v.reshape(k, per, p) for v in (x, y, w))
            sig = torch.tensor(sigmas, dtype=torch.float32, device="cuda").view(k, 1, 1)
            return render_frames_reference(*runs, sig, s, u).reshape(b, s, s)

        got, ref = render(), plain()
        torch.cuda.synchronize()
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        check(bool(torch.isfinite(got).all()), f"K1 settings {b}: non-finite frames")
        check(err <= 1e-5 * scale, f"K1 settings {b}: max|Δ| {err} > 1e-5·{scale}")
        check(torch.equal(got, scalar_launches()), f"K1 settings {b}: differs from {k} one-sigma launches")
        check(torch.equal(got, render()), f"K1 settings {b}: two calls differ")
        nbytes = 4 * (3 * b * p + b * s * s)
        flops = b * p * (2 * s * u * 5 + 2 + s) + b * s * s * p * 2
        bound_ms, by = bound(nbytes, flops)
        row = dict(max_abs_err=err, ms=time_ms(torch, render, iters=100),
                   device_ms=time_ms(torch, render, device_only=True),
                   scalar_launches_ms=time_ms(torch, scalar_launches, iters=100),
                   scalar_launches_device_ms=time_ms(torch, scalar_launches, device_only=True),
                   plain_ms=time_ms(torch, plain), bound_ms=bound_ms, bound_by=by)
        emit({"phase": "k1", "B": b, "P": p, "S": s, "u": u, "psf_settings": k, "tol": 1e-5 * scale,
              "bitwise_equal_to_scalar_launches": True, **row})
        out[f"B_{b}"] = row
    return out


def _embedding_inputs(torch, b, t, s, seed, e=64):
    from moleculardiffusion_mivit_tpu_torch.models import DeepResNetEmbedding, init_model

    mod = init_model(DeepResNetEmbedding(s, e), torch.Generator().manual_seed(seed)).cuda()
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
    bfc = (0.1 * torch.randn(e, generator=gen, device="cuda")).requires_grad_()
    x = (0.3 * torch.randn((b, t, s, s), generator=gen, device="cuda") + 0.1).requires_grad_()
    return x, kernels, scales, biases, wfc, bfc


def _embedding_flops(r, n, e):
    """``(simt, tensor_core)`` operations of one forward
    (``ops.fused_embedding.embedding_flops``, split): the initial conv and
    the fc run outside the tensor cores, the six convs at 32..128 channels
    on them."""
    from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import CONV_MACS_PER_ROW, embedding_flops

    tensor = 2 * r * CONV_MACS_PER_ROW
    return embedding_flops(r, n, e) - tensor, tensor


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

    records = {}
    # Batch 1, 16 and 13x13 are the timed shapes; batch 8 (19,440 rows, what
    # cycle 0 of the main path below runs) and batch 4 (9,720 rows) are here
    # because the conv picks its tile from (rows, channels): between them the
    # five shapes launch every tile the launcher can choose (conv_rows.cuh).
    # The modular experiment's concat_features arm embeds into E = 58, which
    # leaves the fc stages' 16-wide tiles of E a partial one: batch 1 and 16.
    # The embeddings experiment's small and big deep arms embed into E = 32
    # and 128 (two and eight fc tiles): batch 1 and 16. The framerate arms
    # embed 13×13 frames, 60 (tr_0) to 6 (tr_5) of them a sequence: batch 1
    # and 16 of each. The real-data demo's patch model trains at batch 16 on
    # 25-frame sequences (32,400 rows).
    for (b, t, s, e) in ((1, 30, 9, 64), (16, 30, 9, 64), (1, 10, 13, 64), (8, 30, 9, 64), (4, 30, 9, 64),
                         (1, 30, 9, 58), (16, 30, 9, 58), (1, 30, 9, 32), (16, 30, 9, 32), (1, 30, 9, 128),
                         (16, 30, 9, 128), (1, 60, 13, 64), (16, 60, 13, 64), (1, 6, 13, 64), (16, 6, 13, 64),
                         (16, 25, 9, 64)):
        x, kernels, scales, biases, wfc, bfc = _embedding_inputs(torch, b, t, s, seed=b + t + s, e=e)
        leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
        emb_k, st_k = fe.fused_deep_resnet_embed(x, kernels, scales, biases, wfc, bfc)
        emb_r, st_r = fe.deep_resnet_embed_reference(x, kernels, scales, biases, wfc, bfc)
        err_fwd = float((emb_k - emb_r).detach().abs().max())
        check(torch.allclose(emb_k, emb_r, rtol=1e-4, atol=1e-4), f"K2 {b,t,s,e}: emb max|Δ| {err_fwd}")
        for name, _ in fe.BN_LAYOUT:
            for i, what in enumerate(("mean", "var")):
                check(torch.allclose(st_k[name][i], st_r[name][i], rtol=1e-4, atol=1e-4),
                      f"K2 {b,t,s,e}: {name} {what} differs")
        n, r = b * t, b * t * s * s
        xs, weights, sc, bi, wf, bf = _kernel_args(fe, x, kernels, scales, biases, wfc, bfc)
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
            check(ek <= 1e-3 * scale, f"K3 {b,t,s,e}: gradient {i} max|Δ| {ek} > 1e-3·{scale}")
            l2 = float((gk.double() - gr.double()).norm() / gr.double().norm())
            check(l2 <= 1e-2, f"K3 {b,t,s,e}: gradient {i} relative L2 {l2} to the plain f32 version")
            err_bwd, worst, worst_l2 = max(err_bwd, ek), max(worst, ek / scale), max(worst_l2, l2)

        # Determinism: a second call of each kernel on the same inputs gives
        # the same bits (fixed-order reductions, no atomics).
        g2 = g_out.reshape(n, e).contiguous()
        emb_2, stats_2, saved_2 = fe.deep_resnet_embed_fwd(xs, weights, sc, bi, wf, bf)
        first = [emb_1, stats_1, *(saved[k] for k, _ in fe.SAVED), saved["pooled"]]
        second = [emb_2, stats_2, *(saved_2[k] for k, _ in fe.SAVED), saved_2["pooled"]]
        for i, (u, v) in enumerate(zip(_defined(fe, first), _defined(fe, second))):
            check(torch.equal(u, v), f"K2 {b,t,s,e}: output {i} differs between two calls")
        bwd_1 = fe.deep_resnet_embed_bwd(xs, weights, sc, bi, wf, bf, saved, g2)
        stages_bwd = fe.last_stage_launches()
        bwd_2 = fe.deep_resnet_embed_bwd(xs, weights, sc, bi, wf, bf, saved, g2)
        flat = lambda r: _defined(fe, [r[0], *r[1], *r[2:]])  # noqa: E731
        for i, (u, v) in enumerate(zip(flat(bwd_1), flat(bwd_2))):
            check(torch.equal(u, v), f"K3 {b,t,s,e}: gradient {i} differs between two calls")
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
        row = {"phase": "k2_k3", "B": b, "T": t, "S": s, "E": e, "rows": r,
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
        records[(b, t, s, e)] = row
    members = {(m, b): _k2_k3_members(torch, fe, m, b) for m in (30, 7) for b in (1, 16)}
    # the kernels line carries batch 16 at E = 64, with the other embed dims,
    # the framerate shapes and the grids' 30 and 7 members beside it
    out = []
    for k in ("k2", "k3"):
        row = dict(records[(16, 30, 9, 64)][k])
        for e in (58, 32, 128):
            row[f"at_embed_dim_{e}"] = {f"batch_{b}": records[(b, 30, 9, e)][k] for b in (1, 16)}
        row["at_s13"] = {f"T_{t}_batch_{b}": records[(b, t, 13, 64)][k] for t in (60, 6) for b in (1, 16)}
        row["realdata_patch_model_batch_16_T_25"] = records[(16, 25, 9, 64)][k]
        for m in (30, 7):
            row[f"members_{m}"] = {f"batch_{b}": members[(m, b)][k] for b in (1, 16)}
        out.append(row)
    return out


def _k2_k3_members(torch, fe, m, b, t=30, s=9, e=64):
    """K2 and K3 over ``m`` members in one launch each (the psfnoise grid's
    30 transformers at batch ``b``: 30 × 2,430 rows at batch 1, 30 × 38,880
    at 16; the denoising grid's 7): every output bitwise equal to ``m`` one-member launches and to a
    second member launch; against the plain version per member, K2 at the
    rtol/atol 1e-4 of the rows above and K3 at their relative L2 of 1e-2 to
    plain f32 (the one-member launches are held to float64 in the rows
    above at the same shapes). Timed against the one-member launches in a
    loop and the plain version under ``torch.vmap``."""
    n, r = b * t, b * t * s * s
    inputs = [_embedding_inputs(torch, b, t, s, seed=100 + i, e=e) for i in range(m)]
    stack = lambda get: torch.stack([get(a).detach() for a in inputs]).contiguous()  # noqa: E731
    xs = stack(lambda a: a[0].reshape(n, s, s))
    weights = (
        stack(lambda a: a[1]["initial"].reshape(9, 32)), stack(lambda a: fe._pack_w3(a[1]["rb1_conv1"])),
        stack(lambda a: a[1]["rb1_skip"].reshape(32, 64)), stack(lambda a: fe._pack_w3(a[1]["rb1_conv2"])),
        stack(lambda a: fe._pack_w3(a[1]["rb2_conv1"])), stack(lambda a: a[1]["rb2_skip"].reshape(64, 128)),
        stack(lambda a: fe._pack_w3(a[1]["rb2_conv2"])),
    )
    sc = stack(lambda a: fe._pack_rows(list(a[2].values())))
    bi = stack(lambda a: fe._pack_rows(list(a[3].values())))
    wf, bf = stack(lambda a: a[4]), stack(lambda a: a[5])
    args = (xs, weights, sc, bi, wf, bf)
    one = lambda i: (xs[i], tuple(w[i] for w in weights), sc[i], bi[i], wf[i], bf[i])  # noqa: E731
    g = torch.randn((m, n, e), generator=torch.Generator(device="cuda").manual_seed(b), device="cuda")

    f0, b0 = fe.deep_resnet_embed_fwd.launches, fe.deep_resnet_embed_bwd.launches
    emb, stats, saved = fe.deep_resnet_embed_fwd(*args)
    grads = fe.deep_resnet_embed_bwd(*args, saved, g)
    check((fe.deep_resnet_embed_fwd.launches - f0, fe.deep_resnet_embed_bwd.launches - b0) == (1, 1),
          "K2/K3 members: more than one launch each")
    def flat_fwd(out, i=None):  # one member's K2 outputs, without the undefined BN-row tails
        emb_, stats_, saved_ = out if i is None else (out[0][i], out[1][i], {k: v[i] for k, v in out[2].items()})
        return _defined(fe, [emb_, stats_, *(saved_[k] for k, _ in fe.SAVED), saved_["pooled"]])

    def flat_bwd(out, i=None):  # one member's K3 gradients, likewise
        if i is not None:
            out = (out[0][i], tuple(w[i] for w in out[1]), *(x[i] for x in out[2:]))
        return _defined(fe, [out[0], *out[1], *out[2:]])

    again = fe.deep_resnet_embed_fwd(*args), fe.deep_resnet_embed_bwd(*args, saved, g)
    for i in range(m):
        fwd1 = fe.deep_resnet_embed_fwd(*one(i))
        bwd1 = fe.deep_resnet_embed_bwd(*one(i), fwd1[2], g[i])
        for j, (u, v, w) in enumerate(zip(flat_fwd(fwd1), flat_fwd((emb, stats, saved), i), flat_fwd(again[0], i))):
            check(torch.equal(u, v), f"K2 members batch {b}: member {i} output {j} differs from its own launch")
            check(torch.equal(v, w), f"K2 members batch {b}: member {i} output {j} differs between two calls")
        for j, (u, v, w) in enumerate(zip(flat_bwd(bwd1), flat_bwd(grads, i), flat_bwd(again[1], i))):
            check(torch.equal(u, v), f"K3 members batch {b}: member {i} gradient {j} differs from its own launch")
            check(torch.equal(v, w), f"K3 members batch {b}: member {i} gradient {j} differs between two calls")
    del again

    # the plain version of the same function: every member at once under vmap
    leaves = [torch.stack([a[0].detach() for a in inputs]).requires_grad_()]
    dicts = [{k: torch.stack([a[j][k].detach() for a in inputs]).requires_grad_() for k in inputs[0][j]}
             for j in (1, 2, 3)]
    fc = [torch.stack([a[j].detach() for a in inputs]).requires_grad_() for j in (4, 5)]
    leaves += [v for d in dicts for v in d.values()] + fc
    plain = lambda: torch.vmap(fe.deep_resnet_embed_reference)(leaves[0], *dicts, *fc)  # noqa: E731
    emb_r, st_r = plain()
    err_fwd = float((emb.reshape(emb_r.shape) - emb_r).detach().abs().max())
    check(torch.allclose(emb.reshape(emb_r.shape), emb_r, rtol=1e-4, atol=1e-4),
          f"K2 members batch {b}: emb max|Δ| {err_fwd} to the plain version")
    for i, (name, c) in enumerate(fe.BN_LAYOUT):
        for q in (0, 1):
            check(torch.allclose(stats[:, i, q, :c], st_r[name][q], rtol=1e-4, atol=1e-4),
                  f"K2 members batch {b}: {name} statistics differ from the plain version")
    grads_r = torch.autograd.grad(emb_r, leaves, g.reshape(emb_r.shape), retain_graph=True)
    # the kernel's gradients in the plain leaves' layout, through the same autograd path
    emb_k, _ = torch.vmap(fe.fused_deep_resnet_embed)(leaves[0], *dicts, *fc)
    grads_k = torch.autograd.grad(emb_k, leaves, g.reshape(emb_r.shape))
    worst_l2, err_bwd = 0.0, 0.0
    for j, (gk, gr) in enumerate(zip(grads_k, grads_r)):
        for i in range(m):
            l2 = float((gk[i] - gr[i]).norm() / gr[i].norm())
            check(l2 <= 1e-2, f"K3 members batch {b}: member {i} gradient {j} relative L2 {l2} to plain f32")
            worst_l2 = max(worst_l2, l2)
        err_bwd = max(err_bwd, float((gk - gr).abs().max()))

    fwd = lambda: fe.deep_resnet_embed_fwd(*args)  # noqa: E731
    bwd = lambda: fe.deep_resnet_embed_bwd(*args, saved, g)  # noqa: E731
    fwd_singles = lambda: [fe.deep_resnet_embed_fwd(*one(i)) for i in range(m)]  # noqa: E731
    saved1 = [fe.deep_resnet_embed_fwd(*one(i))[2] for i in range(m)]
    bwd_singles = lambda: [fe.deep_resnet_embed_bwd(*one(i), saved1[i], g[i]) for i in range(m)]  # noqa: E731
    with torch.no_grad():
        plain_fwd_ms = time_ms(torch, plain, iters=5, warmup=1)
    plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(emb_r, leaves, g.reshape(emb_r.shape),
                                                              retain_graph=True), iters=5, warmup=1)
    simt, tensor = _embedding_flops(r, n, e)
    param_bytes = 4 * sum(w[0].numel() for w in weights) + 4 * (2 * 7 * 128 + 128 * e + e)
    b2, by2 = bound(m * (4 * r + param_bytes + 4 * n * e + 4 * 7 * 2 * 128), m * simt, m * tensor)
    b3, by3 = bound(m * (4 * n * e + 4 * r + param_bytes + 4 * r + param_bytes), 2 * m * simt, 2 * m * tensor)
    row = {"phase": "k2_k3", "members": m, "B": b, "T": t, "S": s, "E": e, "rows_per_member": r,
           "rows": m * r, "bitwise_equal_to_single_launches": True, "deterministic": True,
           "k3_worst_rel_l2_to_plain_f32": worst_l2,
           "k2": dict(max_abs_err=err_fwd, ms=time_ms(torch, fwd, iters=10),
                      device_ms=time_ms(torch, fwd, iters=10, device_only=True),
                      single_launches_ms=time_ms(torch, fwd_singles, iters=5),
                      single_launches_device_ms=time_ms(torch, fwd_singles, iters=5, device_only=True),
                      plain_ms=plain_fwd_ms, bound_ms=b2, bound_by=by2),
           "k3": dict(max_abs_err=err_bwd, ms=time_ms(torch, bwd, iters=10),
                      device_ms=time_ms(torch, bwd, iters=10, device_only=True),
                      single_launches_ms=time_ms(torch, bwd_singles, iters=5),
                      single_launches_device_ms=time_ms(torch, bwd_singles, iters=5, device_only=True),
                      plain_ms=plain_bwd_ms, bound_ms=b3, bound_by=by3)}
    emit(row)
    return row


def baseline_arms():
    """The seven models of the baseline experiment under its names, at full
    width: GeneralTransformer with the linear, cnn and deep_resnet embeddings,
    each with relu and leaky_relu, and MultiImageResNet."""
    from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
    from moleculardiffusion_mivit_tpu_torch.models import MultiImageResNet, get_transformer_models

    cfg = ModelConfig(use_pos_encoding=True)
    return {**get_transformer_models(cfg.replace(activation="relu"), "_s"),
            **get_transformer_models(cfg.replace(activation="leaky_relu"), "_leaky"),
            "resnet": MultiImageResNet(single_prediction=True)}


def phase_slice(torch, card):
    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.evaluation import (
        load_validation_trajectories,
        render_validation_videos,
    )
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe
    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames
    from moleculardiffusion_mivit_tpu_torch.train.loop import run_training

    cfg = TrainConfig(initial_batch_size=8, adaptive_batch_size=1)
    num_cycles = 2
    n_seq = cfg.sequences_per_d * len(cfg.training_ds)
    steps = sum(n_seq // cfg.batch_size_for_cycle(c) for c in range(num_cycles))
    wrappers = {"render_frames": render_frames, "deep_resnet_embed_fwd": fe.deep_resnet_embed_fwd,
                "deep_resnet_embed_bwd": fe.deep_resnet_embed_bwd}
    counts = lambda: {k: w.launches for k, w in wrappers.items()}  # noqa: E731

    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    trajs = load_validation_trajectories(length=cfg.n_frames, device="cuda")
    rendered = render_validation_videos(trajs, cfg, BASELINE_OPTICS, device="cuda")
    val = {d: rendered[f"val{d:g}"] for d in (1.0, 3.0, 5.0, 7.0)}
    torch.cuda.synchronize()
    t_val = time.perf_counter() - t0
    for v in rendered.values():
        check(bool(torch.isfinite(v).all()) and v.shape[-2:] == (9, 9), "bad validation videos")
    check(counts()["render_frames"] == len(rendered), f"K1 launches in validation {counts()}")

    # One model after the other, as the reference's training script loops
    # over its model dict; every arm sees the same frozen validation videos.
    arms = baseline_arms()
    for name, model in arms.items():
        before = counts()
        marks = [time.perf_counter()]
        state, hist = run_training(model, cfg, BASELINE_OPTICS, val, num_cycles=num_cycles,
                                   callback=lambda c, m: marks.append(time.perf_counter()), device="cuda")
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in counts().items()}

        finite = all(math.isfinite(v) for vals in hist.values() for v in vals)
        check(finite, f"{name}: non-finite loss or val MSE: {hist}")
        check(hist["train_loss"][1] < hist["train_loss"][0], f"{name}: train loss did not fall: {hist['train_loss']}")
        check(launches["render_frames"] == num_cycles * len(cfg.training_ds), f"{name}: K1 launches {launches}")
        fused = steps if name.startswith("deepcnn") else 0
        check(launches["deep_resnet_embed_fwd"] == fused, f"{name}: K2 launches {launches} != {fused}")
        check(launches["deep_resnet_embed_bwd"] == fused, f"{name}: K3 launches {launches} != {fused}")
        check(next(state.model.parameters()).is_cuda, f"{name}: the model is not on the card")
        cycle_s = [b - a for a, b in zip(marks, marks[1:])]
        emit({"phase": "slice", "arm": name, "card": card, "cycles": num_cycles, "steps": steps,
              "parameters": sum(p.numel() for p in model.parameters()),
              "batch_sizes": [cfg.batch_size_for_cycle(c) for c in range(num_cycles)],
              "validation_render_s": t_val, "s_per_cycle": cycle_s,
              "seq_per_s": [n_seq / c for c in cycle_s], "history": hist, "launches": launches})

    total = counts()
    check(total["render_frames"] == len(arms) * num_cycles * len(cfg.training_ds) + len(rendered),
          f"K1 launches {total['render_frames']} over the phase")
    check(total["deep_resnet_embed_fwd"] == 2 * steps and total["deep_resnet_embed_bwd"] == 2 * steps,
          f"K2/K3 launches {total} != {2 * steps} (two deepcnn arms)")
    return total


def device_kernels(torch, prof):
    """``(name, start_ns, end_ns)`` of every kernel a ``torch.profiler``
    run saw on the card, kernels inside replayed CUDA graphs included, read
    from the raw trace (no per-event Python objects: a batch-1 cycle runs
    1.6 million kernels)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def kernel_key(name: str) -> str:
    """A kernel's function name without return type, namespace, template
    and call arguments (``void (anonymous namespace)::pool_fc_kernel(float
    const*, ...)`` → ``pool_fc_kernel``)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0].split("::")[-1].strip()


def _profiled(torch, fn):
    """Run ``fn`` under ``torch.profiler`` (CUDA activity); returns its wall
    seconds, the card's busy share over them (union of kernel intervals),
    the kernels' summed device ms, their number, and the kernels counted by
    name. Emits the host seconds the profiler took to stop and to be read
    (a batch-1 cycle records 0.5-3.2 million kernels)."""
    from collections import Counter

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    kernels = device_kernels(torch, prof)
    names = Counter()
    for name, n in Counter(name for name, _, _ in kernels).items():
        names[kernel_key(name)] += n
    start = np.fromiter((a for _, a, _ in kernels), np.int64, len(kernels))
    end = np.fromiter((b for _, _, b in kernels), np.int64, len(kernels))
    order = np.argsort(start, kind="stable")
    start, end = start[order], end[order]
    # union of the intervals: each adds what reaches past every earlier end
    reach = np.concatenate(([np.iinfo(np.int64).min], np.maximum.accumulate(end)[:-1]))
    busy_ms = float(np.clip(end - np.maximum(start, reach), 0, None).sum()) / 1e6
    wall = t1 - t0
    emit({"phase": "profiler", "kernels": len(kernels), "wall_s": wall, "stop_s": t2 - t1,
          "read_s": time.perf_counter() - t2})
    return wall, busy_ms / (wall * 1e3), float((end - start).sum()) / 1e6, len(kernels), dict(names)


def _replay_host_ms(torch, engine, n: int = 20) -> dict:
    """Host ms of one ``replay()`` call of each unit's graph with the card
    idle (median of ``n``), after a run: each replay repeats the unit's
    first step (its counter is reset), so it trains the models further."""
    out = {}
    for key, unit in engine.units.items():
        if unit.graph is None:
            continue
        times = []
        for _ in range(n):
            unit.counter.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unit.graph.replay()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        out["+".join(key)] = 1e3 * statistics.median(times)
    return out


def _models(exp):
    """``(model name, arm name, member index or None)`` of every model of an
    experiment: an arm of one model, or each member of a grid arm."""
    from moleculardiffusion_mivit_tpu_torch.experiments.base import GridArm

    return [(n, arm_name, i) if isinstance(arm, GridArm) else (arm_name, arm_name, None)
            for arm_name, arm in exp.arms.items()
            for i, n in enumerate(arm.names if isinstance(arm, GridArm) else [arm_name])]


def _member_losses(exp) -> dict:
    """Each learned model's training loss of every cycle so far (a grid arm
    keeps its members' as one tensor a cycle)."""
    return {name: [float(v if i is None else v[i]) for v in exp.train_loss[arm]]
            for name, arm, i in _models(exp) if arm in exp.train_loss}


def _compare_experiments(torch, a, b):
    """Per model, the largest relative differences between two experiments'
    training losses and validation MSEs of every cycle so far and their
    parameters and buffers now, and whether all of them are bitwise equal
    (a non-learned arm has only its validation MSEs; a grid's members are
    compared one by one)."""
    out = {}
    losses_a, losses_b = _member_losses(a), _member_losses(b)
    for name, arm, member in _models(a):
        d = {"loss": 0.0, "val": 0.0, "param": 0.0, "bitwise": True}
        pairs = {"loss": list(zip(losses_a.get(name, []), losses_b.get(name, [])))}
        pairs["val"] = [p for key in a.history[name] for p in zip(a.history[name][key], b.history[name][key])]
        for what, ps in pairs.items():
            for va, vb in ps:
                d[what] = max(d[what], abs(va - vb) / abs(vb))
                d["bitwise"] &= va == vb
        if arm not in a.states:
            out[name] = d
            continue
        ref = b.states[arm].model.state_dict()
        for key, v in a.states[arm].model.state_dict().items():
            w = ref[key]
            if member is not None:
                v, w = v[member], w[member]
            d["bitwise"] &= bool(torch.equal(v, w))
            scale = float(w.abs().max()) or 1.0
            d["param"] = max(d["param"], float((v - w).abs().max()) / scale)
        out[name] = d
    return out


def phase_experiment(torch, card):
    """The baseline experiment through its entry points (``experiments.
    baseline.build`` + ``Experiment.run``, then ``run_experiment.main``) at
    full width: all seven arms, 4 D classes × 64 sequences of 30 frames, the
    frozen validation suite. (a) Cycles at batch 16 captured and eager from
    the same seed: over two cycles, losses, validation MSEs and every
    parameter and buffer agree; the second is timed. (b) At batch 1,
    captured, ``_batch_one_profiled``: a capture cycle and two timed ones
    (the loss check reads the second: the leaky deep arm can sit on its
    predict-the-mean plateau through cycle 1), then a profiled cycle at the
    cut size. (c) K2/K3 run
    inside the replayed graphs once a step of each deepcnn arm and in no
    other unit; K1 once per D class and cycle plus the validation renders.
    (d) Finite losses and MSEs, training loss falling at batch 1."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import run_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts

    n_val_renders = 6
    deep = ("deepcnn_2layer_s", "deepcnn_2layer_leaky")
    torch.cuda.reset_peak_memory_stats()
    engines = []

    def build(batch, fused, **kw):
        exp = baseline.build(seed=0, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()  # every engine below starts with empty counters
    t_phase = time.perf_counter()

    # (a) batch 16, captured against eager: cycles 0 and 1 compared, cycle 1
    # timed
    runs = {}
    for fused in (True, False):
        exp = build(16, fused, sequences_per_d=CUT_SEQS_PER_D)
        exp.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run(1, start_cycle=1)
        torch.cuda.synchronize()
        runs[fused] = [exp, time.perf_counter() - t0]
    cap, eag = runs[True][0], runs[False][0]
    n_cmp = _sequences(cap)
    tol = 1e-4
    diffs = _compare_experiments(torch, cap, eag)
    emit({"phase": "experiment", "part": "a_agreement", "tolerance_relative": tol, "by_arm": diffs})
    for name, d in diffs.items():
        for what in ("loss", "val", "param"):
            check(d[what] <= tol, f"experiment: {name}: captured and eager {what} differ by {d[what]} > {tol}")
    units16 = {"+".join(u.names): u.launches_per_replay for u in cap.engine.units.values()}
    emit({"phase": "experiment", "part": "a", "card": card, "batch": 16, "arms": len(cap.arms),
          "tolerance_relative": tol, "bitwise_equal": all(d["bitwise"] for d in diffs.values()),
          "s_per_cycle": {"captured": runs[True][1], "eager": runs[False][1]},
          "seq_per_s": {"captured": n_cmp / runs[True][1], "eager": n_cmp / runs[False][1]},
          "sequences": n_cmp, "captures": cap.engine.captures, "replays": cap.engine.replays,
          "launches_per_replay_by_unit": units16,
          "val_avg": {n: h["val_avg"] for n, h in cap.history.items()}})

    # (b) batch 1, captured: a capture cycle, two timed ones; a profiled one
    # at the cut size
    exp, marks, prof, units1, losses = _batch_one_profiled(torch, build, "experiment", deep, renders=4,
                                                           timed_cycles=2)
    eng = exp.engine
    n_seq = _sequences(exp)

    # the user's entry point, one cycle (batch 1 by the schedule) with its files
    with tempfile.TemporaryDirectory() as out:
        cli = run_experiment.main(["baseline", "--cycles", "1", "--out", out, "--checkpoint-last", "0",
                                    "--seqs-per-d", str(CUT_SEQS_PER_D)])
        engines.append(cli.engine)
        for f in ("metrics.jsonl", "history.json", "final/meta.json", "baseline_errors.csv",
                  "in_order_predictions.npz"):
            check(Path(out, f).is_file(), f"run_experiment wrote no {f}")
        cli_events = [json.loads(line)["event"] for line in Path(out, "metrics.jsonl").read_text().splitlines()]
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # (a) two experiments of two cycles; (b) three at the protocol's size and
    # two at the cut size; the runner's one (at the cut size too)
    builds, cycles = 5, 2 * 2 + 3 + 2 + 1
    k1_want = n_val_renders * builds + 4 * cycles
    k23_want = len(deep) * (2 * 2 * (n_cmp // 16) + 3 * n_seq + 3 * n_cmp)
    check(launches["render_frames"] == k1_want, f"experiment: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"experiment: {k} launches {launches[k]} != {k23_want}")
    replay_host_ms = _replay_host_ms(torch, eng)  # after the counts: these replays are not the main path's
    emit({"phase": "experiment", "part": "b", "card": card, "batch": 1, "arms": len(exp.arms),
          **_batch_one_times(marks, n_seq), **prof, "replay_host_ms_card_idle": replay_host_ms,
          "launches_per_replay_by_unit": units1, "train_loss": losses,
          "val_avg": {n: h["val_avg"] for n, h in exp.history.items()},
          "run_experiment_events": cli_events,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def _sequences(exp, per_d=None) -> int:
    """Sequences an experiment generates a cycle (a 10.2 tail class at half
    count), at ``per_d`` a class if given."""
    from moleculardiffusion_mivit_tpu_torch.experiments.base import class_sequence_counts

    return sum(class_sequence_counts(exp.train_cfg.training_ds, per_d or exp.train_cfg.sequences_per_d))


def _captured_against_eager(torch, build, phase, card, tol=1e-4, seqs_per_d=CUT_SEQS_PER_D):
    """Part (a) of an experiment phase: at batch 16, two cycles captured and
    two eager from one seed, ``seqs_per_d`` sequences a class (None: the
    experiment's own); losses,
    validation MSEs and every parameter and buffer must agree to ``tol``
    relative; the second cycle is timed. Returns the captured experiment."""
    runs = {}
    for fused in (True, False):
        exp = build(16, fused, **({"sequences_per_d": seqs_per_d} if seqs_per_d else {}))
        exp.run(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run(1, start_cycle=1)
        torch.cuda.synchronize()
        runs[fused] = (exp, time.perf_counter() - t0)
    cap, eag = runs[True][0], runs[False][0]
    n_seq = _sequences(cap)
    diffs = _compare_experiments(torch, cap, eag)
    for name, d in diffs.items():
        for what in ("loss", "val", "param"):
            check(d[what] <= tol, f"{phase}: {name}: captured and eager {what} differ by {d[what]} > {tol}")
    emit({"phase": phase, "part": "a", "card": card, "batch": 16, "arms": list(cap.arms),
          "tolerance_relative": tol, "bitwise_equal": all(d["bitwise"] for d in diffs.values()), "by_arm": diffs,
          "s_per_cycle": {"captured": runs[True][1], "eager": runs[False][1]}, "sequences": n_seq,
          "seq_per_s": {"captured": n_seq / runs[True][1], "eager": n_seq / runs[False][1]},
          "captures": cap.engine.captures, "replays": cap.engine.replays,
          "launches_per_replay_by_unit": {"+".join(u.names): u.launches_per_replay
                                          for u in cap.engine.units.values()},
          "val_avg": {n: h["val_avg"] for n, h in cap.history.items()}})
    return cap


def _batch_one_profiled(torch, build, phase, deep, renders, early_steps=None,
                        kernels=("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"), timed_cycles=1,
                        plateau=()):
    """Part (b) of an experiment phase, at batch 1, captured. At the
    protocol's size: a capture cycle, then ``timed_cycles`` cycles without
    the profiler (the first is the batch-1 time; the embeddings experiment's
    cnn_2layer_b, denoising's trans_poisson_noise and the baseline's
    deepcnn_2layer_leaky, at f32 and bf16, can still be on their plateaus
    after one cycle, so there the loss check reads a second,
    ``timed_cycles=2``). Checks finite
    losses and MSEs, training loss falling
    for every model (each member of a grid), and K2/K3 recorded once a
    replay in exactly the ``deep`` arms' graphs (a grid arm once for all its
    members). The loss falls if the last cycle's mean is below the first's;
    with ``early_steps``, below the mean of cycle 0's first ``early_steps``
    steps (the loss from initialisation: a model on the predict-the-mean
    plateau has fallen to it in cycle 0 and may stay there for cycles). A
    model in ``plateau`` starts on that plateau and may stay on it for the
    smoke's cycles: its last cycle is held to at most ``1 + PLATEAU_MARGIN``
    times its start instead (it must not climb off the plateau).

    Then, in an experiment of ``CUT_SEQS_PER_D`` sequences a class, a
    capture cycle and a profiled one: the card's busy share and the
    profiler's own count of K1 (``renders`` a cycle) and K2/K3 (once a step
    of each deep arm). The profiler costs ~30 µs of host time a kernel it
    records (95 s for the 3.2 million of a protocol-size framerate cycle),
    so it records a quarter of the steps.

    Returns the protocol-size experiment, its cycle marks, the profiled
    cycle's figures (a dict to emit), launches per replay by unit and the
    losses. ``kernels``: the wrappers the deep arms' graphs must record
    (K2-bf16/K3-bf16 at bf16)."""
    exp = build(1, True)
    eng = exp.engine
    marks = [time.perf_counter()]
    early = {}

    def after_cycle(c, m):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if c == 0 and early_steps:  # the engine's buffers hold cycle 0's per-step losses
            for key, unit in eng.units.items():
                for arm, buf in zip(key, unit.losses):
                    names = getattr(exp.arms[arm], "names", [arm])
                    first = buf[:early_steps].mean(dim=0).reshape(-1).tolist()
                    early.update(zip(names, first))

    exp.run(1 + timed_cycles, callback=after_cycle)
    losses = _member_losses(exp)
    for n, hist in exp.history.items():
        check(all(math.isfinite(v) for vals in hist.values() for v in vals), f"{phase}: {n}: non-finite val MSE")
    for n, ls in losses.items():
        check(all(math.isfinite(v) for v in ls), f"{phase}: {n}: non-finite loss {ls}")
    starts = {n: early[n] if early_steps else ls[0] for n, ls in losses.items()}
    if early_steps:
        emit({"phase": phase, "part": "b_loss", "early_steps": early_steps, "early_loss": early,
              "cycle_loss": losses, "not_below_cycle_0": sorted(n for n, ls in losses.items() if ls[-1] >= ls[0]),
              "plateau": {n: losses[n][-1] / starts[n] for n in plateau}, "plateau_margin": PLATEAU_MARGIN})
    for n, ls in losses.items():
        if n in plateau:
            check(ls[-1] <= starts[n] * (1 + PLATEAU_MARGIN),
                  f"{phase}: {n}: training loss rose off its plateau: {ls} from {starts[n]}")
        else:
            check(ls[-1] < starts[n], f"{phase}: {n}: training loss did not fall: {ls} from {starts[n]}")
    units1 = {"+".join(u.names): u.launches_per_replay for u in eng.units.values()}
    for key, per in units1.items():
        want = sum(1 for n in key.split("+") if n in deep)
        check(all(per.get(k, 0) == want for k in kernels),
              f"{phase}: unit {key} records {per}, expected {want} of each of {kernels} a replay")

    small = build(1, True, sequences_per_d=CUT_SEQS_PER_D)
    small.run(1)
    torch.cuda.synchronize()
    small.engine.unit_seconds = {}
    wall, busy, kernel_ms, n_kernels, names = _profiled(torch, lambda: small.run(1, start_cycle=1))
    check(all(math.isfinite(v) for ls in _member_losses(small).values() for v in ls),
          f"{phase}: non-finite loss in the profiled cycle")
    n_small = _sequences(small)
    seen = {k: names.get(k, 0) for k in ("render_frames_kernel", "pool_fc_kernel", "pool_fc_bwd_kernel")}
    want = {"render_frames_kernel": renders, "pool_fc_kernel": len(deep) * n_small,
            "pool_fc_bwd_kernel": len(deep) * n_small}
    check(seen == want, f"{phase}: profiled cycle ran {seen}, expected {want}")
    prof = {"profiled_sequences": n_small, "profiled_s_per_cycle": wall, "device_busy_share_profiled": busy,
            "device_kernel_ms": kernel_ms, "device_busy_share_est": kernel_ms / (wall * 1e3),
            "kernels_in_profiled_cycle": n_kernels, "kernels_per_step": n_kernels / n_small,
            "profiled_kernels_once_per_k1_k2_k3_call": seen,
            "unit_s_profiled_cycle": {"+".join(k): v for k, v in small.engine.unit_seconds.items()}}
    return exp, marks, prof, units1, losses


def _batch_one_times(marks, n_seq: int) -> dict:
    """Part (b)'s times at the protocol's size: the capture cycle's, and the
    first cycle after it (no profiler) as the batch-1 time."""
    s = marks[2] - marks[1]
    return {"s_per_cycle_capture": marks[1] - marks[0], "s_per_cycle": s, "seq_per_s": n_seq / s}


def phase_images_features(torch, card):
    """The images-features experiment through its entry points
    (``experiments.images_features.build`` + ``Experiment.run``, then
    ``run_experiment.main --cycles 1 --in-order``) at full width: nine arms, 5 D classes
    × 64 sequences of 30 frames with their 25 features, validation at D = 1,
    3, 5, 7, 9 (50 sequences each). (a) Batch 16, captured against eager from
    one seed, two cycles: losses, validation MSEs and every parameter and
    buffer agree to 1e-4 relative; the second cycle is timed. (b) Batch 1,
    captured: a capture cycle and a timed one, a cut-size cycle profiled; generation
    and the features timed on their own; host ms of one replay per unit.
    (c) The features of one cycle's 320 frame-averaged trajectories on the
    card against the CPU at the CPU test's ``PARITY_TOLERANCE``. (d) Launches:
    K2/K3 3 × ⌊320/b⌋ a cycle (the three deep-ResNet arms, in the graphs),
    K1 5 a cycle in generation, 5 a build for validation, 1 for the in-order
    sweep."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import run_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments import images_features
    from moleculardiffusion_mivit_tpu_torch.features import FEATURE_NAMES, compute_features_for_multiple_trajectories
    from moleculardiffusion_mivit_tpu_torch.features.features import PARITY_TOLERANCE
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    deep = ("im_tr", "im_ft_early_tr", "im_ft_late_tr")
    torch.cuda.reset_peak_memory_stats()
    engines = []

    def build(batch, fused, **kw):
        exp = images_features.build(seed=0, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    t_phase = time.perf_counter()

    cap = _captured_against_eager(torch, build, "images_features", card)
    n_cmp = _sequences(cap)
    exp, marks, prof, units1, losses = _batch_one_profiled(
        torch, build, "images_features", deep, renders=5)
    n_seq = _sequences(exp)
    eng = exp.engine

    # the user's entry point: one cycle (batch 1 by the schedule) and the in-order sweep
    with tempfile.TemporaryDirectory() as out:
        cli = run_experiment.main(["images_features", "--cycles", "1", "--out", out, "--checkpoint-last", "0",
                                    "--seqs-per-d", str(CUT_SEQS_PER_D),
                                   "--in-order"])
        engines.append(cli.engine)
        for f in ("metrics.jsonl", "history.json", "final/meta.json", "images_features_errors.csv",
                  "in_order_predictions.npz"):
            check(Path(out, f).is_file(), f"run_experiment images_features wrote no {f}")
        history = json.loads(Path(out, "history.json").read_text())
        check(list(history) == list(cap.arms) and all(len(h["val_avg"]) == 1 for h in history.values()),
              f"run_experiment images_features: histories {history}")
        in_order_rows = Path(out, "images_features_errors.csv").read_text().splitlines()[1:]
        n_in_order = len(cli.in_order_data["d_values"])
        events = [json.loads(line) for line in Path(out, "metrics.jsonl").read_text().splitlines()]
    check(n_in_order == 100, f"in-order sweep of {n_in_order} D values, expected 100")
    tables = next(e["tables"] for e in events if e["event"] == "error_tables")
    msd_rows = {name: tables[name]["mse"] for name in MSD_ROWS}
    for name, want in MSD_ROWS.items():
        check(abs(msd_rows[name] / want - 1) <= MSD_RTOL,
              f"images_features: in-order {name} {msd_rows[name]} is not the JAX record's {want}")
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # (a) two experiments of two cycles; (b) two at the protocol's size and
    # two at the cut size; the runner's one (at the cut size too)
    builds, cycles = 5, 2 * 2 + 2 + 2 + 1
    k1_want = 5 * builds + 1 + 5 * cycles
    k23_want = len(deep) * (2 * 2 * (n_cmp // 16) + 2 * n_seq + 3 * n_cmp)
    check(launches["render_frames"] == k1_want,
          f"images_features: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"images_features: {k} launches {launches[k]} != {k23_want}")

    # after the counts: replays, generation and features timed on their own
    replay_host_ms = _replay_host_ms(torch, eng)
    gen = lambda: exp.generate_fn(seeded_generator("cuda", 7, 0))  # noqa: E731
    data = gen()
    gen_ms = time_ms(torch, gen, iters=5, warmup=1)
    trajs_avg = data["trajs_avg"]
    feats = lambda: compute_features_for_multiple_trajectories(trajs_avg)  # noqa: E731
    feat_ms = time_ms(torch, feats, iters=10, warmup=2)
    _, _, feat_kernel_ms, feat_kernels, _ = _profiled(torch, feats)

    # (c) the card's features against the CPU's on the same trajectories
    on_card = feats()
    check(torch.equal(on_card, data["features"]), "images_features: generate_fn's features differ from a second call")
    on_cpu = compute_features_for_multiple_trajectories(trajs_avg.cpu())
    delta = (on_card.cpu() - on_cpu).abs()
    per_feature = {}
    for i, name in enumerate(FEATURE_NAMES):
        rtol, atol = PARITY_TOLERANCE[name]
        limit = atol + rtol * on_cpu[:, i].abs()
        per_feature[name] = {"max_abs_delta": float(delta[:, i].max()), "rtol": rtol, "atol": atol,
                             "worst_share_of_limit": float((delta[:, i] / limit).max())}
        check(bool((delta[:, i] <= limit).all()), f"images_features: card feature {name} off the CPU by "
                                                   f"{float(delta[:, i].max())} (rtol {rtol}, atol {atol})")
    emit({"phase": "images_features", "part": "b", "card": card, "batch": 1, "arms": len(exp.arms),
          **_batch_one_times(marks, n_seq), **prof,
          "generation_ms": gen_ms, "generation_share": gen_ms / (1e3 * (marks[2] - marks[1])),
          "features_ms": feat_ms, "features_device_kernel_ms": feat_kernel_ms, "features_kernels": feat_kernels,
          "replay_host_ms_card_idle": replay_host_ms, "launches_per_replay_by_unit": units1, "train_loss": losses,
          "val_avg": {n: h["val_avg"] for n, h in exp.history.items()},
          "run_experiment_in_order_csv": in_order_rows, "in_order_msd_rows": msd_rows,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "images_features", "part": "c_features_card_vs_cpu", "sequences": int(trajs_avg.shape[0]),
          "frames": int(trajs_avg.shape[1]), "by_feature": per_feature})
    emit({"phase": "images_features", "part": "d_launches", "launches": launches, "k1_expected": k1_want,
          "k2_k3_expected": k23_want, "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_modular(torch, card):
    """The modular experiment with ``--with-hybrid`` and the in-order sweep
    through its entry points (``experiments.modular.build`` +
    ``Experiment.run``, then ``run_experiment.main``) at full width: eight
    arms (ModularTransformer images only, features only, and both fused by
    add, concat + projection and concat_features, whose image embedding is
    58 wide; the early-fusion GeneralTransformer; HybridFusionTransformer by
    concat + projection and by add), 5 D classes × 64 sequences of 30 frames
    with their per-frame tokens and 25 global features, validation at D = 1,
    3, 5, 7. (a) Batch 16, captured against eager from one seed, two cycles:
    losses, validation MSEs and every parameter and buffer agree to 1e-4
    relative; the second cycle is timed. (b) Batch 1, captured: a capture
    cycle and a timed one, a cut-size cycle profiled; generation timed on its own.
    (c) One cycle's per-frame tokens on the card against the CPU's at the
    CPU test's tolerance. (d) Launches: K2/K3 7 × ⌊320/b⌋ a cycle (every arm
    but ``mod_features``, whose graph launches neither), K1 5 a cycle in
    generation, 4 + 1 a build for validation and the in-order sweep. (e) The
    in-order MSD rows of the published suite, computed on the card, equal
    the JAX record's."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import run_experiment
    from moleculardiffusion_mivit_tpu_torch.evaluation import IN_ORDER_IMFT_D_VALUES, error_table, generate_in_order_imft
    from moleculardiffusion_mivit_tpu_torch.experiments import modular
    from moleculardiffusion_mivit_tpu_torch.experiments.images_features import MSD_MULT_FACTOR, MSD_MULT_FACTOR_AVG
    from moleculardiffusion_mivit_tpu_torch.features import compute_per_frame_features, d_from_msd_tau1
    from moleculardiffusion_mivit_tpu_torch.sim import average_trajectories_frames, single_state
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

    arms = ["mod_images", "mod_features", "mod_both_add", "mod_both_concat", "mod_both_concat_feat",
            "glob_early_tr", "hybrid_concat", "hybrid_add"]
    deep = [a for a in arms if a != "mod_features"]
    torch.cuda.reset_peak_memory_stats()
    engines = []

    def build(batch, fused, **kw):
        exp = modular.build(seed=0, with_hybrid=True, with_in_order=True, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    t_phase = time.perf_counter()

    cap = _captured_against_eager(torch, build, "modular", card)
    check(list(cap.arms) == arms, f"modular: arms {list(cap.arms)}")
    n_cmp = _sequences(cap)
    exp, marks, prof, units1, losses = _batch_one_profiled(
        torch, build, "modular", deep, renders=5)
    n_seq = _sequences(exp)
    check(n_seq == 320, f"modular: {n_seq} sequences a cycle, expected 5 classes × 64")
    eng = exp.engine
    check(set(units1) == set(arms), f"modular: units {sorted(units1)}: no arm may stack")

    # the user's entry point: one cycle (batch 1 by the schedule) and the in-order sweep
    with tempfile.TemporaryDirectory() as out:
        cli = run_experiment.main(["modular", "--with-hybrid", "--in-order", "--cycles", "1", "--out", out,
                                    "--seqs-per-d", str(CUT_SEQS_PER_D),
                                   "--checkpoint-last", "0"])
        engines.append(cli.engine)
        for f in ("metrics.jsonl", "history.json", "final/meta.json", "modular_errors.csv",
                  "in_order_predictions.npz"):
            check(Path(out, f).is_file(), f"run_experiment modular wrote no {f}")
        history = json.loads(Path(out, "history.json").read_text())
        check(list(history) == arms and all(len(h["val_avg"]) == 1 for h in history.values()),
              f"run_experiment modular: histories {history}")
        in_order_rows = Path(out, "modular_errors.csv").read_text().splitlines()[1:]
        n_in_order = len(cli.in_order_data["d_values"])
    check(n_in_order == 100, f"modular: in-order sweep of {n_in_order} D values, expected 100")
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # (a) two experiments of two cycles; (b) two at the protocol's size and
    # two at the cut size; the runner's one (at the cut size too)
    builds, cycles = 5, 2 * 2 + 2 + 2 + 1
    k1_want = (4 + 1) * builds + 5 * cycles
    k23_want = len(deep) * (2 * 2 * (n_cmp // 16) + 2 * n_seq + 3 * n_cmp)
    check(launches["render_frames"] == k1_want, f"modular: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"modular: {k} launches {launches[k]} != {k23_want}")

    # after the counts: replays and generation timed on their own
    replay_host_ms = _replay_host_ms(torch, eng)
    g = seeded_generator("cuda", 7, 0)
    gen = lambda: exp.generate_fn(g)  # noqa: E731
    data = gen()
    gen_ms = time_ms(torch, gen, iters=5, warmup=1)

    # (c) the cycle's per-frame tokens, made again from generate_fn's
    # trajectories, on the card and on the CPU
    cfg = exp.train_cfg
    avg = torch.cat([
        average_trajectories_frames(single_state(fold_in(g, i, 0), cfg.sequences_per_d, 300, Ds=tuple(ds))[0]
                                    / cfg.traj_div_factor, cfg.n_pos_per_frame)
        for i, ds in enumerate(cfg.training_ds)])
    on_card = compute_per_frame_features(avg)
    check(torch.equal(on_card, data["pf_features"]), "modular: generate_fn's per-frame tokens are not its trajectories'")
    on_cpu = compute_per_frame_features(avg.cpu())
    delta = (on_card.cpu() - on_cpu).abs()
    limit = 1e-6 + 1e-6 * on_cpu.abs()
    check(bool((delta <= limit).all()), f"modular: card per-frame tokens off the CPU by {float(delta.max())}")

    # (e) the published suite's MSD rows, scored on the card
    raw = torch.as_tensor(generate_in_order_imft(), dtype=torch.float32, device="cuda").reshape(1000, 300, 2) / 100.0
    d_max = cfg.d_max_normalization
    preds = {"MSD_Perfect": d_from_msd_tau1(raw) * MSD_MULT_FACTOR * d_max,
             "MSD_Frame": d_from_msd_tau1(average_trajectories_frames(raw, 10)) * MSD_MULT_FACTOR_AVG * d_max}
    msd_rows = {n: error_table(p.reshape(100, 10).cpu().numpy(), IN_ORDER_IMFT_D_VALUES)["mse"] for n, p in preds.items()}
    for name, want in MSD_ROWS.items():
        check(abs(msd_rows[name] / want - 1) <= MSD_RTOL, f"modular: in-order {name} {msd_rows[name]} != {want}")

    emit({"phase": "modular", "part": "b", "card": card, "batch": 1, "arms": len(exp.arms),
          **_batch_one_times(marks, n_seq), **prof,
          "generation_ms": gen_ms, "generation_share": gen_ms / (1e3 * (marks[2] - marks[1])),
          "replay_host_ms_card_idle": replay_host_ms, "launches_per_replay_by_unit": units1, "train_loss": losses,
          "val_avg": {n: h["val_avg"] for n, h in exp.history.items()},
          "run_experiment_in_order_csv": in_order_rows,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "modular", "part": "c_per_frame_card_vs_cpu", "sequences": int(avg.shape[0]),
          "max_abs_delta": float(delta.max()), "worst_share_of_limit": float((delta / limit).max()),
          "rtol": 1e-6, "atol": 1e-6})
    emit({"phase": "modular", "part": "d_launches", "launches": launches, "k1_expected": k1_want,
          "k2_k3_expected": k23_want})
    emit({"phase": "modular", "part": "e_in_order_msd_rows", "on_card": msd_rows, "jax_record": MSD_ROWS,
          "rtol": MSD_RTOL, "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_embeddings(torch, card):
    """The embeddings experiment through its entry points
    (``experiments.embeddings.build`` + ``Experiment.run``, then
    ``run_experiment.main embeddings``) at full width and full data: ten
    arms, the linear, cnn and deep_resnet transformers at embed 64, 32 and
    128 (6, 3 and 12 layers) and MultiImageResNet, 4 D classes × 64
    sequences of 30 frames, validation at D = 1, 3, 5, 7. (a) Batch 16,
    captured against eager from one seed, two cycles: losses, validation
    MSEs and every parameter and buffer agree to 1e-4 relative; the second
    cycle is timed. (b) Batch 1, captured: a capture cycle, two timed
    ones (the first is the batch-1 time), a cut-size cycle profiled; generation timed on its own. (c) Launches: K2/K3 3 ×
    ⌊256/b⌋ a cycle, once a step of each ``deepcnn_2layer_*`` arm (E = 64,
    32, 128) and in no other unit's graph; K1 4 a cycle in generation and 4
    a build for validation."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import run_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments import embeddings
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    deep = ("deepcnn_2layer_n", "deepcnn_2layer_s", "deepcnn_2layer_b")
    torch.cuda.reset_peak_memory_stats()
    engines = []

    def build(batch, fused, **kw):
        exp = embeddings.build(seed=0, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    t_phase = time.perf_counter()

    cap = _captured_against_eager(torch, build, "embeddings", card)
    n_cmp = _sequences(cap)
    check(len(cap.arms) == 10, f"embeddings: {len(cap.arms)} arms")
    widths = {n: cap.arms[n].model.embedding.fc.out_features for n in deep}
    check(widths == {"deepcnn_2layer_n": 64, "deepcnn_2layer_s": 32, "deepcnn_2layer_b": 128},
          f"embeddings: deep-ResNet embed dims {widths}")
    exp, marks, prof, units1, losses = _batch_one_profiled(
        torch, build, "embeddings", deep, renders=4, timed_cycles=2)
    n_seq = _sequences(exp)
    check(n_seq == 256, f"embeddings: {n_seq} sequences a cycle, expected 4 classes × 64")
    eng = exp.engine
    check(set(units1) == set(exp.arms), f"embeddings: units {sorted(units1)}: no arm may stack")

    # the user's entry point: one cycle (batch 1 by the schedule)
    with tempfile.TemporaryDirectory() as out:
        cli = run_experiment.main(["embeddings", "--cycles", "1", "--out", out, "--checkpoint-last", "0",
                                    "--seqs-per-d", str(CUT_SEQS_PER_D)])
        engines.append(cli.engine)
        for f in ("metrics.jsonl", "history.json", "final/meta.json", "final/states/deepcnn_2layer_b.pt"):
            check(Path(out, f).is_file(), f"run_experiment embeddings wrote no {f}")
        history = json.loads(Path(out, "history.json").read_text())
        check(list(history) == list(cap.arms) and all(len(h["val_avg"]) == 1 for h in history.values()),
              f"run_experiment embeddings: histories {history}")
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # (a) two experiments of two cycles; (b) three at the protocol's size and
    # two at the cut size; the runner's one (at the cut size too)
    builds, cycles = 5, 2 * 2 + 3 + 2 + 1
    k1_want = 4 * builds + 4 * cycles
    k23_want = len(deep) * (2 * 2 * (n_cmp // 16) + 3 * n_seq + 3 * n_cmp)
    check(launches["render_frames"] == k1_want, f"embeddings: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"embeddings: {k} launches {launches[k]} != {k23_want}")

    # after the counts: replays and generation timed on their own
    replay_host_ms = _replay_host_ms(torch, eng)
    gen = lambda: exp.generate_fn(seeded_generator("cuda", 7, 0))  # noqa: E731
    gen_ms = time_ms(torch, gen, iters=5, warmup=1)
    emit({"phase": "embeddings", "part": "b", "card": card, "batch": 1, "arms": len(exp.arms),
          "parameters": embeddings.param_counts(exp),
          **_batch_one_times(marks, n_seq), **prof,
          "generation_ms": gen_ms, "generation_share": gen_ms / (1e3 * (marks[2] - marks[1])),
          "replay_host_ms_card_idle": replay_host_ms, "launches_per_replay_by_unit": units1, "train_loss": losses,
          "val_avg": {n: h["val_avg"] for n, h in exp.history.items()},
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "embeddings", "part": "c_launches", "launches": launches, "k1_expected": k1_want,
          "k2_k3_expected": k23_want, "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_framerate(torch, card):
    """The framerate experiment through its entry points
    (``experiments.framerate.build`` + ``Experiment.run``, then
    ``run_experiment.main framerate`` and the in-order rescore of its
    checkpoint) at full width and full data: twelve arms, a deep-ResNet
    transformer (``tr_i``) and MultiImageResNet (``res_i``) per exposure of
    5 … 50 sub-positions a frame, on 13×13 frames, 60 to 6 of them a
    sequence; 5 D classes × 64 sequences and the 10.2 class × 32 of 300
    steps, rendered at each rate; validation at D = 1, 3, 5, 7, 9. (a) Batch
    16, captured against eager from one seed, two cycles (1e-4 relative);
    the second cycle is timed. (b) Batch 1, captured: a capture cycle and
    a timed one, a cut-size cycle profiled; generation timed on its own. (c)
    Launches: K2/K3 6 × ⌊352/b⌋ a cycle, never in a ``res_i`` graph; K1 36 a
    cycle (6 classes × 6 rates), 30 a build for validation, 60 for the
    rescore (10 chunks × 6 rates). (d) The rescore writes the JAX example's
    CSV with finite scores for every arm."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import run_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments import framerate
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    deep = tuple(f"tr_{i}" for i in range(6))
    torch.cuda.reset_peak_memory_stats()
    engines = []

    def build(batch, fused, **kw):
        exp = framerate.build(seed=0, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    t_phase = time.perf_counter()

    cap = _captured_against_eager(torch, build, "framerate", card)
    n_cmp = _sequences(cap)
    check(list(cap.arms) == [f"{k}_{i}" for i in range(6) for k in ("tr", "res")],
          f"framerate: arms {list(cap.arms)}")
    exp, marks, prof, units1, losses = _batch_one_profiled(
        torch, build, "framerate", deep, renders=36)
    n_seq = _sequences(exp)
    check(n_seq == 352, f"framerate: {n_seq} sequences a cycle, expected 5 classes × 64 + 32")
    eng = exp.engine
    check(set(units1) == set(exp.arms), f"framerate: units {sorted(units1)}: no arm may stack")

    # the user's entry points: one cycle (batch 1 by the schedule), then the
    # in-order rescore of the checkpoint it wrote
    with tempfile.TemporaryDirectory() as out:
        cli = run_experiment.main(["framerate", "--cycles", "1", "--out", out, "--checkpoint-last", "0",
                                    "--seqs-per-d", str(CUT_SEQS_PER_D)])
        engines.append(cli.engine)
        for f in ("metrics.jsonl", "history.json", "final/meta.json", "final/states/tr_5.pt"):
            check(Path(out, f).is_file(), f"run_experiment framerate wrote no {f}")
        history = json.loads(Path(out, "history.json").read_text())
        check(list(history) == list(cap.arms) and all(len(h["val_avg"]) == 1 for h in history.values()),
              f"run_experiment framerate: histories {history}")
        t0 = time.perf_counter()
        rows = framerate.main(["--ckpt", str(Path(out, "final"))])
        torch.cuda.synchronize()
        rescore_s = time.perf_counter() - t0
        csv = Path(out, framerate.RESCORE_CSV).read_text().splitlines()
    check(csv[0] == "model,exposure_ms,mse,std,mse_d_le_7,published_mse" and len(csv) == 13,
          f"framerate: rescore CSV {csv[:2]}")
    check(all(math.isfinite(r["mse"]) for r in rows.values()), f"framerate: rescore {rows}")
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # (a) two experiments of two cycles; (b) two at the protocol's size and
    # two at the cut size; the runner's one (at the cut size too)
    builds, cycles = 6, 2 * 2 + 2 + 2 + 1  # the rescore builds too
    k1_want = 30 * builds + 36 * cycles + 60  # the rescore: 10 chunks × 6 rates
    k23_want = len(deep) * (2 * 2 * (n_cmp // 16) + 2 * n_seq + 3 * n_cmp)
    check(launches["render_frames"] == k1_want, f"framerate: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"framerate: {k} launches {launches[k]} != {k23_want}")

    # after the counts: replays and generation timed on their own
    replay_host_ms = _replay_host_ms(torch, eng)
    gen = lambda: exp.generate_fn(seeded_generator("cuda", 7, 0))  # noqa: E731
    gen_ms = time_ms(torch, gen, iters=5, warmup=1)
    emit({"phase": "framerate", "part": "b", "card": card, "batch": 1, "arms": len(exp.arms),
          **_batch_one_times(marks, n_seq), **prof,
          "generation_ms": gen_ms, "generation_share": gen_ms / (1e3 * (marks[2] - marks[1])),
          "replay_host_ms_card_idle": replay_host_ms, "launches_per_replay_by_unit": units1, "train_loss": losses,
          "val_avg": {n: h["val_avg"] for n, h in exp.history.items()},
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "framerate", "part": "c_launches", "launches": launches, "k1_expected": k1_want,
          "k2_k3_expected": k23_want})
    emit({"phase": "framerate", "part": "d_rescore", "seconds": rescore_s, "csv": csv,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_psfnoise(torch, card):
    """The PSF × noise experiment through its entry points
    (``experiments.psfnoise.build`` + ``Experiment.run``, then
    ``run_experiment.main psfnoise --in-order``) at full width and full
    data: 60 models in two grid arms, ``tr_grid`` (30 deep-ResNet
    transformers, no positional encoding) and ``res_grid`` (30
    MultiImageResNets), member ``6 i + j`` on cell (PSF ``i``, noise ``j``)
    of one ``(352, 5, 6, 30, 9, 9)`` tensor a cycle (5 D classes × 64 and the
    10.2 class × 32 sequences of 300 steps); validation at D = 1, 3, 5, 7, 9.
    (a) Batch 16, captured against eager from one seed, two cycles: every
    member's losses, validation MSEs, parameters and buffers agree to 1e-4
    relative; the second cycle is timed. (b) Batch 1, captured: a capture
    cycle and a timed one, a cut-size cycle profiled; every member's
    training loss falls from initialisation (the second cycle's mean below
    the mean of cycle 0's first 35 steps: the noisiest cells sit on the
    predict-the-mean plateau for their first cycles, in the JAX record too,
    so the cycle means are reported, not held); ``tr_3_5`` alone, which
    starts on that plateau with these draws, is held within
    ``PLATEAU_MARGIN`` of its start instead; generation timed on its own.
    (c) Launches: K2/K3 once a grid step
    for all 30 members (⌊352/b⌋ a cycle, in ``tr_grid``'s graph, never in
    ``res_grid``'s); K1 once per D class a cycle (6), once per validation D
    a build (5) and once for the in-order suite, each for all five PSF
    settings. (d) The runner writes ``psfnoise_errors.csv`` with the JAX
    record's 60 model names and finite scores."""
    import csv as csv_lib
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import run_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments import psfnoise
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    deep = ("tr_grid",)
    torch.cuda.reset_peak_memory_stats()
    engines = []

    def build(batch, fused, **kw):
        exp = psfnoise.build(seed=0, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    t_phase = time.perf_counter()

    cap = _captured_against_eager(torch, build, "psfnoise", card)
    n_cmp = _sequences(cap)
    names = [f"{k}_{i}_{j}" for k in ("tr", "res") for i in range(5) for j in range(6)]
    check(cap.model_names == names, f"psfnoise: models {cap.model_names}")
    del cap
    # early_steps: a tenth of the cycle's steps; plateau: the member whose
    # first 35 steps already sit at the predict-the-mean level
    exp, marks, prof, units1, losses = _batch_one_profiled(
        torch, build, "psfnoise", deep, renders=6, early_steps=35, plateau=("tr_3_5",))
    n_seq = _sequences(exp)
    check(n_seq == 352, f"psfnoise: {n_seq} sequences a cycle, expected 5 classes × 64 + 32")
    eng = exp.engine
    check(set(units1) == set(exp.arms), f"psfnoise: units {sorted(units1)}")
    check(len(losses) == 60, f"psfnoise: losses of {len(losses)} models")

    # the user's entry point: one cycle (batch 1 by the schedule) and the
    # in-order suite's error table
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        cli = run_experiment.main(["psfnoise", "--cycles", "1", "--out", out, "--checkpoint-last", "0",
                                    "--seqs-per-d", str(CUT_SEQS_PER_D),
                                   "--in-order"])
        torch.cuda.synchronize()
        runner_s = time.perf_counter() - t0
        engines.append(cli.engine)
        for f in ("metrics.jsonl", "history.json", "final/meta.json", "final/states/tr_grid.pt",
                  "in_order_predictions.npz"):
            check(Path(out, f).is_file(), f"run_experiment psfnoise wrote no {f}")
        with open(Path(out, "psfnoise_errors.csv")) as fh:
            table = {row["model"]: float(row["mse"]) for row in csv_lib.DictReader(fh)}
    with open(ROOT / "results" / "psfnoise_reconciled" / "psfnoise_errors.csv") as fh:
        record = [row["model"] for row in csv_lib.DictReader(fh)]
    check(list(table) == record == names, f"psfnoise: error table rows {list(table)[:3]}…")
    check(all(math.isfinite(v) for v in table.values()), f"psfnoise: error table {table}")
    del cli
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # (a) two experiments of two cycles; (b) two at the protocol's size and
    # two at the cut size; the runner's one (at the cut size too)
    builds, cycles = 5, 2 * 2 + 2 + 2 + 1
    k1_want = 5 * builds + 6 * cycles + 1  # the runner's in-order suite
    k23_want = len(deep) * (2 * 2 * (n_cmp // 16) + 2 * n_seq + 3 * n_cmp)
    check(launches["render_frames"] == k1_want, f"psfnoise: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"psfnoise: {k} launches {launches[k]} != {k23_want}")

    # after the counts: replays and generation timed on their own
    replay_host_ms = _replay_host_ms(torch, eng)
    gen = lambda: exp.generate_fn(seeded_generator("cuda", 7, 0))  # noqa: E731
    gen_ms = time_ms(torch, gen, iters=5, warmup=1)
    emit({"phase": "psfnoise", "part": "b", "card": card, "batch": 1, "models": len(losses),
          **_batch_one_times(marks, n_seq), **prof,
          "generation_ms": gen_ms, "generation_share": gen_ms / (1e3 * (marks[2] - marks[1])),
          "replay_host_ms_card_idle": replay_host_ms, "launches_per_replay_by_unit": units1, "train_loss": losses,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "psfnoise", "part": "c_launches", "launches": launches, "k1_expected": k1_want,
          "k2_k3_expected": k23_want})
    emit({"phase": "psfnoise", "part": "d_runner", "seconds": runner_s, "in_order_mse": table,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_denoising(torch, card):
    """The denoising experiment through its entry points
    (``experiments.denoising.build`` + ``Experiment.run``, then
    ``run_experiment.main denoising``) at full width and full data: 14
    models in two grid arms of 7, ``trans_grid`` (deep-ResNet transformers
    with a learned positional embedding) and ``resnet_grid``
    (MultiImageResNets), trained with L1 loss; member ``m`` reads setting
    ``m`` of one ``(256, 7, 30, 9, 9)`` stack a cycle (4 D classes × 64
    sequences of 300 steps rendered into four noise variants, the Poisson
    one RL-TV-deconvolved after 3, 6 and 11 steps); validation at D = 1, 3,
    5, 7. (a) Batch 16, captured against eager from one seed, two cycles:
    every member's losses, validation MSEs, parameters and buffers agree to
    1e-4 relative. (b) Batch 1, captured: a capture cycle, two timed ones
    (the first is the batch-1 time), a cut-size cycle profiled; every member's training loss falls (the third cycle's
    mean below the first's; the transformers on noisy settings sit near the
    L1 plateau of ≈ 0.21-0.24 in these cycles, so cycle 0's first steps,
    as phase psfnoise reads them, can already be below it).
    (c) Launches: K2/K3 once a grid step for all 7 transformers (⌊256/b⌋ a
    cycle, in ``trans_grid``'s graph, never in ``resnet_grid``'s); K1 once
    per D class a cycle (4) and once per validation D a build (4). (d) The
    runner writes the 14 members' histories. (e) The card against the CPU
    (``_denoising_card_against_cpu``)."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import run_experiment
    from moleculardiffusion_mivit_tpu_torch.experiments import denoising
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    deep = ("trans_grid",)
    torch.cuda.reset_peak_memory_stats()
    engines = []

    def build(batch, fused, **kw):
        exp = denoising.build(seed=0, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    t_phase = time.perf_counter()

    cap = _captured_against_eager(torch, build, "denoising", card)
    n_cmp = _sequences(cap)
    names = [f"{k}_{s}" for k in ("trans", "resnet") for s in denoising.SETTINGS]
    check(cap.model_names == names, f"denoising: models {cap.model_names}")
    del cap
    exp, marks, prof, units1, losses = _batch_one_profiled(
        torch, build, "denoising", deep, renders=4, timed_cycles=2)
    n_seq = _sequences(exp)
    check(n_seq == 256, f"denoising: {n_seq} sequences a cycle, expected 4 classes × 64")
    eng = exp.engine
    check(set(units1) == set(exp.arms), f"denoising: units {sorted(units1)}")
    check(len(losses) == 14, f"denoising: losses of {len(losses)} models")

    # the user's entry point: one cycle (batch 1 by the schedule)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        cli = run_experiment.main(["denoising", "--cycles", "1", "--out", out, "--checkpoint-last", "0",
                                    "--seqs-per-d", str(CUT_SEQS_PER_D)])
        torch.cuda.synchronize()
        runner_s = time.perf_counter() - t0
        engines.append(cli.engine)
        for f in ("metrics.jsonl", "history.json", "final/meta.json", "final/states/trans_grid.pt",
                  "final/states/resnet_grid.pt"):
            check(Path(out, f).is_file(), f"run_experiment denoising wrote no {f}")
        history = json.loads(Path(out, "history.json").read_text())
    check(list(history) == names and all(math.isfinite(h["val_avg"][-1]) for h in history.values()),
          f"denoising: runner history {list(history)[:3]}…")
    del cli
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # (a) two experiments of two cycles; (b) three at the protocol's size and
    # two at the cut size; the runner's one (at the cut size too)
    builds, cycles = 5, 2 * 2 + 3 + 2 + 1
    k1_want = 4 * builds + 4 * cycles
    k23_want = len(deep) * (2 * 2 * (n_cmp // 16) + 3 * n_seq + 3 * n_cmp)
    check(launches["render_frames"] == k1_want, f"denoising: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"denoising: {k} launches {launches[k]} != {k23_want}")

    # after the counts: replays, generation and the card against the CPU
    replay_host_ms = _replay_host_ms(torch, eng)
    gen = lambda: exp.generate_fn(seeded_generator("cuda", 7, 0))  # noqa: E731
    gen_ms = time_ms(torch, gen, iters=5, warmup=1)
    emit({"phase": "denoising", "part": "b", "card": card, "batch": 1, "models": len(losses),
          **_batch_one_times(marks, n_seq), **prof,
          "generation_ms": gen_ms, "generation_share": gen_ms / (1e3 * (marks[2] - marks[1])),
          "replay_host_ms_card_idle": replay_host_ms, "launches_per_replay_by_unit": units1, "train_loss": losses,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "denoising", "part": "c_launches", "launches": launches, "k1_expected": k1_want,
          "k2_k3_expected": k23_want})
    emit({"phase": "denoising", "part": "d_runner", "seconds": runner_s,
          "val_avg": {n: h["val_avg"][-1] for n, h in history.items()}})
    _denoising_card_against_cpu(torch, exp, card)
    emit({"phase": "denoising", "part": "phase_s", "seconds": time.perf_counter() - t_phase})
    return launches


def _denoising_card_against_cpu(torch, exp, card):
    """Part (e) of phase denoising, on one class of the cycle (64 sequences
    at D = 5, 1,920 frames): the four-variant renderer's deterministic part,
    the filter and RL-TV on the card against the plain CPU path, at the CPU
    tests' tolerances (``tests/test_torch_denoising.py``):

    - ``no_noise`` (K1) against the plain renderer on the CPU given the same
      sub-positions and the card's per-frame intensity, 1e-5 × max|frame|;
      ``gauss − no_noise`` in ``[0, bg + 3σ]``;
    - ``filtered`` against the CPU's ``gaussian_filter_2d`` of the card's
      ``poisson``, 1e-6 × max|poisson|;
    - each of RL-TV's 11 steps on the card from the CPU's estimate, 5e-5
      (the TV step amplifies a convolution's rounding difference up to
      100×); the snapshots after 3, 6 and 11 steps at 1e-4 on at least
      99.5 % of the pixels (the largest gap reported beside the CPU's own
      between the input and the input one ulp up: RL-TV is ill-conditioned
      at plateaus);
    - ``torch.poisson`` on the card at λ = 1e5, 2e5 and 4e5 (the shot noise
      of the renderer: λ = gauss · 100) against the CPU's: 2^20 draws each,
      mean and variance within 5 standard errors of λ on both sides.

    Then K1 at this call, RL-TV, the filter, a class's whole render and
    its seven-variant stack timed."""
    from moleculardiffusion_mivit_tpu_torch.denoise import rl_tv
    from moleculardiffusion_mivit_tpu_torch.experiments.denoising import DENOISING_OPTICS as optics
    from moleculardiffusion_mivit_tpu_torch.ops.filters import gaussian_filter_2d
    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames, render_frames_reference
    from moleculardiffusion_mivit_tpu_torch.sim import normalize_images, single_state
    from moleculardiffusion_mivit_tpu_torch.sim.render import (
        _prepare_subpositions,
        trajectories_to_video_multiple_settings,
    )
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

    cfg = exp.train_cfg
    n, p, s, u = cfg.sequences_per_d, cfg.n_pos_per_frame, optics.output_size, optics.upsampling_factor
    g = seeded_generator("cuda", 5, 0)
    trajs, _ = single_state(fold_in(g, 0), n, cfg.n_frames * p, Ds=(5.0, 1.0))
    trajs = trajs / cfg.traj_div_factor
    gr = fold_in(g, 1)
    no_noise, gauss, poisson, filtered = trajectories_to_video_multiple_settings(gr, trajs, p, cfg.center, optics)
    torch.cuda.synchronize()

    part_mean, part_std = optics.particle_intensity
    w = (part_mean + part_std * torch.randn((n, cfg.n_frames), generator=fold_in(gr, 0), device="cuda")) / p
    w = w[..., None].expand(n, cfg.n_frames, p).contiguous()
    x_hr, y_hr = _prepare_subpositions(trajs, p, cfg.center, optics)
    ref = render_frames_reference(x_hr.cpu(), y_hr.cpu(), w.cpu(), optics.gaussian_sigma_hr, s, u)
    err_render = float((no_noise.cpu() - ref).abs().max())
    check(err_render <= 1e-5 * float(ref.abs().max()), f"denoising: no_noise max|Δ| {err_render} to the CPU")
    added = gauss - no_noise
    bg_mean, bg_std = optics.background_intensity
    check(float(added.min()) >= 0.0 and float(added.max()) <= bg_mean + 3 * bg_std + 1e-3,
          f"denoising: gauss − no_noise in [{float(added.min())}, {float(added.max())}]")
    err_filter = float((filtered.cpu() - gaussian_filter_2d(poisson.cpu(), 0.5)).abs().max())
    check(err_filter <= 1e-6 * float(poisson.abs().max()), f"denoising: filter max|Δ| {err_filter} to the CPU")

    bg_sigma = optics.background_intensity[1]
    videos, _ = normalize_images(torch.stack([no_noise, gauss, poisson, filtered], 1), bg_mean, bg_sigma,
                                 part_mean + bg_mean)
    image = videos[:, 2]
    psf = torch.from_numpy(rl_tv.create_gaussian_psf(sigma=1.0))
    clipped = torch.clamp(image, min=1e-6).cpu()
    estimate, step_err = torch.full_like(clipped, 0.5), 0.0
    for _ in range(11):
        card_step = rl_tv._rl_tv_step(estimate.cuda(), clipped.cuda(), psf.cuda(), psf.flip(-2, -1).cuda(), 0.01)
        estimate = rl_tv._rl_tv_step(estimate, clipped, psf, psf.flip(-2, -1), 0.01)
        step_err = max(step_err, float((card_step.cpu() - estimate).abs().max()))
    check(step_err <= 5e-5, f"denoising: an RL-TV step on the card differs from the CPU's by {step_err}")
    snaps = rl_tv.apply_rl_tv_iter_list_batch(image, psf).cpu()
    snaps_cpu = rl_tv.apply_rl_tv_iter_list_batch(image.cpu(), psf)
    one_ulp = rl_tv.apply_rl_tv_iter_list_batch(torch.nextafter(image.cpu(), torch.tensor(float("inf"))), psf)
    rl_rows = {}
    for j, steps in enumerate((3, 6, 11)):
        d = (snaps[:, j] - snaps_cpu[:, j]).abs()
        row = {"max_abs": float(d.max()), "rms": float(d.pow(2).mean().sqrt()),
               "share_beyond_1e-4": float((d > 1e-4).float().mean()),
               "cpu_one_ulp_max_abs": float((one_ulp[:, j] - snaps_cpu[:, j]).abs().max())}
        check(row["share_beyond_1e-4"] <= 5e-3, f"denoising: RL-TV after {steps}: {row}")
        rl_rows[f"steps_{steps}"] = row

    poisson_rows = {}
    for lam in (1e5, 2e5, 4e5):
        rates = torch.full((2**20,), lam)
        row = {}
        for dev, gen in (("cuda", seeded_generator("cuda", 11, int(lam))), ("cpu", seeded_generator("cpu", 11, int(lam)))):
            draws = torch.poisson(rates.to(dev), generator=gen).double()
            z_mean = float((draws.mean() - lam) / math.sqrt(lam / draws.numel()))
            z_var = float((draws.var() / lam - 1.0) / math.sqrt(2.0 / draws.numel()))
            check(abs(z_mean) <= 5 and abs(z_var) <= 5, f"torch.poisson on {dev} at λ {lam}: z {z_mean}, {z_var}")
            row[dev] = {"z_mean": z_mean, "z_var": z_var}
        poisson_rows[f"lambda_{lam:g}"] = row

    flat = [v.reshape(-1, p).contiguous() for v in (x_hr, y_hr, w)]
    sigma, b = optics.gaussian_sigma_hr, flat[0].shape[0]
    k1 = lambda: render_frames(*flat, sigma, s, u)  # noqa: E731
    k1_bound, k1_by = bound(4 * (3 * b * p + b * s * s), b * p * (2 * s * u * 5 + 2 + s) + b * s * s * p * 2)
    timing = {
        "k1": dict(B=b, ms=time_ms(torch, k1, iters=100), device_ms=time_ms(torch, k1, device_only=True),
                   plain_ms=time_ms(torch, lambda: render_frames_reference(*flat, sigma, s, u)),
                   bound_ms=k1_bound, bound_by=k1_by, max_abs_err=err_render),
        "rl_tv_ms": time_ms(torch, lambda: rl_tv.apply_rl_tv_iter_list_batch(image, psf), iters=10),
        "rl_tv_device_ms": time_ms(torch, lambda: rl_tv.apply_rl_tv_iter_list_batch(image, psf), iters=10,
                                   device_only=True),
        "filter_ms": time_ms(torch, lambda: gaussian_filter_2d(poisson, 0.5)),
        "four_variants_ms": time_ms(torch, lambda: trajectories_to_video_multiple_settings(
            gr, trajs, p, cfg.center, optics), iters=10),
        "seven_variant_stack_ms": time_ms(torch, lambda: rl_tv.trajs_to_vid_norm_rl(
            gr, trajs, p, cfg.center, optics), iters=10),
    }
    emit({"phase": "denoising", "part": "e_card_vs_cpu", "card": card, "frames": b,
          "no_noise_max_abs_err": err_render, "filter_max_abs_err": err_filter,
          "rl_tv_step_max_abs_err": step_err, "rl_tv_snapshots": rl_rows, "poisson": poisson_rows,
          "timing": timing})


def phase_realdata(torch, card):
    """The real-data pipeline (``realdata/``) and its demo at full width.

    (a) K1 at the wide-field shapes against its plain version: the demo's
    movie (25 frames of 6 particles × 10 sub-positions, S = 63, u = 5), the
    sim-to-real movie's P = 100 (50,400 bytes of shared memory: the opt-in
    above 48 KB) and the camera-size call of part (d) (1,600 frames of P =
    100), each timed beside its plain version and the launch floor. (b) The
    pipeline on the card against the port's own CPU path on one movie
    rendered on the card (``_realdata_card_against_cpu``). (c) The demo
    through its entry point (``realdata.demo.main --train-cycles 5``, the
    full-width patch model, 256 sequences a cycle at batch 16): the last
    cycle's training loss below the first's, a finite metrics file with 6
    tracks, K2/K3 16 launches a cycle, K1 one a cycle and one for the movie.
    (d) A camera-size stack: 16 independent 63-px tiles of 10 particles, 100
    frames each, rendered in one batched ``render_widefield`` call (one K1
    launch) and assembled into (100, 252, 252), then detect → track →
    patches → localise → ``estimate_d_for_tracks`` with a full-width patch
    model of random weights; track count, stage seconds, peak memory.
    The path's launches are counted over (c) and (d)."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch.realdata import demo
    from moleculardiffusion_mivit_tpu_torch.sim.render import widefield_subpositions
    from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts

    t_phase = time.perf_counter()
    optics, u = demo.OPTICS, demo.OPTICS.upsampling_factor
    g = torch.Generator(device="cuda").manual_seed(12)
    k1_rows = {}
    for b, k in ((25, 6), (25, 10), (1600, 10)):
        trajs = 14 + 35 * torch.rand((k, b * demo.N_POS, 2), generator=g, device="cuda")
        x, y = widefield_subpositions(trajs, demo.N_POS, demo.FIELD, u)
        w = 400.0 + 20.0 * torch.randn(x.shape, generator=g, device="cuda")
        k1_rows[f"B_{b}_P_{k * demo.N_POS}"] = _k1_row(torch, x, y, w, optics.gaussian_sigma_hr, demo.FIELD, u,
                                                        "realdata")
    with contextlib.redirect_stdout(sys.stderr):
        _realdata_card_against_cpu(torch, card)

    # (c) and (d): the path, its launches counted from here
    counts0 = launch_counts()
    cycles = 5
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the demo's prose, off the JSON lines
            report = demo.main(["--train-cycles", str(cycles), "--out", out, "--seed", "0"])
        demo_s = time.perf_counter() - t0
        written = json.loads(Path(out, "realdata_metrics.json").read_text())
    after_demo = launch_counts()
    demo_launches = {k: after_demo[k] - counts0[k] for k in counts0}
    losses = report["train_loss"]
    check(losses[-1] < losses[0], f"realdata demo: training loss did not fall: {losses}")
    check(written == report["summary"] and written["n_tracks"] == 6
          and all(math.isfinite(v) for v in written.values()), f"realdata demo: metrics {written}")
    steps = cycles * (256 // 16)
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(demo_launches[k] == steps, f"realdata demo: {k} launches {demo_launches[k]} != {steps}")
    check(demo_launches["render_frames"] == cycles + 1,
          f"realdata demo: K1 launches {demo_launches['render_frames']} != {cycles + 1}")
    emit({"phase": "realdata", "part": "c_demo", "card": card, "seconds": demo_s, "train_loss": losses,
          "s_per_cycle": report["s_per_cycle"], "stage_s": report["stage_s"], "metrics": written,
          "d_model": report["d_model"], "d_msd": report["d_msd"], "launches": demo_launches})

    with contextlib.redirect_stdout(sys.stderr):
        camera = _realdata_camera_stack(torch, card)
    launches = {k: v - counts0[k] for k, v in launch_counts().items()}
    check(launches["render_frames"] == cycles + 2, f"realdata: K1 launches {launches}")
    emit({"phase": "realdata", "part": "summary", "card": card, "k1_widefield": k1_rows, "camera": camera,
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    return launches


def _realdata_card_against_cpu(torch, card):
    """Part (b) of phase realdata: the demo's movie rendered on the card,
    then every stage of the pipeline on the card and on the CPU from the
    same stack (``_pipeline_card_against_cpu``), with one full-width patch
    model's random weights on both devices."""
    import copy
    import tempfile

    import numpy as np

    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, init_model
    from moleculardiffusion_mivit_tpu_torch.realdata import demo, read_tiff_stack
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    with tempfile.TemporaryDirectory() as tmp:
        movie = demo.make_movie(f"{tmp}/m.tif", seeded_generator("cuda", 0, 3))
        stack = read_tiff_stack(f"{tmp}/m.tif")
    check(np.array_equal(stack, movie), "realdata: the TIFF round trip is not bitwise")
    model = init_model(GeneralTransformer(demo.MODEL_CONFIG, embedding="deep_resnet"),
                       torch.Generator().manual_seed(5)).eval()
    model_cpu, model = copy.deepcopy(model), model.cuda()
    row = _pipeline_card_against_cpu(torch, stack, {"random": (model, model_cpu)}, "realdata")
    check(row["tracks"] == 6, f"realdata: {row['tracks']} tracks, not 6")
    emit({"phase": "realdata", "part": "b_card_vs_cpu", "card": card, **row})


def _pipeline_card_against_cpu(torch, stack, models: dict, phase: str) -> dict:
    """Every stage of the pipeline on the card and on the CPU from the same
    stack: the DoG at 1e-5 of its largest value; every frame's peaks, the
    tracks and the fallback set identical; the refined x/y within 1e-3 px,
    PSF size and fitted amplitude within 1e-3 relative; then per model
    (``{name: (card module, CPU module)}``, the same weights) d_msd at 1e-5
    relative and d_model at 1e-4 of the largest |d_model|, both devices from
    the CPU's refined positions."""
    import numpy as np

    from moleculardiffusion_mivit_tpu_torch.ops.curve_fit import fit_gaussian_2d
    from moleculardiffusion_mivit_tpu_torch.realdata import (
        demo,
        detect_particles_stack,
        estimate_d_for_tracks,
        extract_particle_patches,
        refine_localizations,
        track_particles,
    )

    coords, dog = detect_particles_stack(stack, min_distance=5, device="cuda")
    coords_cpu, dog_cpu = detect_particles_stack(stack, min_distance=5, device="cpu")
    dog_err = float(np.abs(dog - dog_cpu).max())
    check(dog_err <= 1e-5 * float(np.abs(dog_cpu).max()), f"{phase}: DoG max|Δ| {dog_err} to the CPU")
    check(all(np.array_equal(a, b) for a, b in zip(coords, coords_cpu)), f"{phase}: peaks differ from the CPU's")
    tracks, dets, _ = track_particles(stack, device="cuda", **demo.TRACKING)
    tracks_cpu, dets_cpu, _ = track_particles(stack, device="cpu", **demo.TRACKING)
    check(tracks == tracks_cpu and dets == dets_cpu and len(tracks) > 0, f"{phase}: tracks differ from the CPU's")
    patches = extract_particle_patches(stack, tracks, demo.PATCH)
    refined = refine_localizations(tracks, patches, demo.PATCH, device="cuda")
    refined_cpu = refine_localizations(tracks, patches, demo.PATCH, device="cpu")
    fallback = {k for k, v in refined.items() if v["psf_size"] == 10.0}
    check(fallback == {k for k, v in refined_cpu.items() if v["psf_size"] == 10.0}, f"{phase}: fallback sets differ")
    xy_err = max(abs(refined[k][c] - v[c]) for k, v in refined_cpu.items() for c in ("x_refined", "y_refined"))
    psf_err = max(abs(refined[k]["psf_size"] - v["psf_size"]) / v["psf_size"] for k, v in refined_cpu.items())
    flat = torch.tensor(np.concatenate(list(patches.values())))
    amp = fit_gaussian_2d(flat.cuda())[0][:, 0].cpu()
    amp_cpu = fit_gaussian_2d(flat)[0][:, 0]
    amp_err = float(((amp - amp_cpu).abs() / amp_cpu.abs()).max())
    check(xy_err <= 1e-3 and psf_err <= 1e-3 and amp_err <= 1e-3,
          f"{phase}: refined x/y {xy_err} px, PSF {psf_err}, amplitude {amp_err} relative to the CPU")

    def predictor(m):
        return lambda videos: m(videos).detach()

    kw = dict(patch_size=demo.PATCH, background_mean=demo.BG_MEAN, background_sigma=demo.BG_SIGMA,
              theoretical_max=demo.THEO_MAX, msd_calibration=0.375, refined_positions=refined_cpu)
    row = {"tracks": len(tracks), "fits": len(refined), "fallbacks": len(fallback), "dog_max_abs_err": dog_err,
           "refined_xy_max_abs_err_px": xy_err, "psf_max_rel_err": psf_err, "amplitude_max_rel_err": amp_err}
    for name, (model, model_cpu) in models.items():
        model.eval()
        model_cpu.eval()
        with torch.no_grad():
            d = estimate_d_for_tracks(tracks, stack, predictor(model), device="cuda", **kw)
            d_cpu = estimate_d_for_tracks(tracks, stack, predictor(model_cpu), device="cpu", **kw)
        scale = max(abs(v["d_model"]) for v in d_cpu.values())  # random weights: a track's D may lie near 0
        model_err = max(abs(d[k]["d_model"] - v["d_model"]) for k, v in d_cpu.items()) / scale
        msd_err = max(abs(d[k]["d_msd"] - v["d_msd"]) / abs(v["d_msd"]) for k, v in d_cpu.items())
        check(model_err <= 1e-4 and msd_err <= 1e-5,
              f"{phase}: {name} d_model {model_err}, d_msd {msd_err} relative to the CPU")
        row[f"{name}_d_model_max_rel_err"], row[f"{name}_d_msd_max_rel_err"] = model_err, msd_err
    return row


def _realdata_camera_stack(torch, card):
    """Part (d) of phase realdata: 16 independent 63-px tiles of 10
    particles (the sim-to-real movie), 100 frames each, in one
    ``render_widefield`` call, assembled 4 × 4 into a (100, 252, 252) stack
    with 160 particles, then the whole pipeline on the card."""
    import numpy as np

    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, init_model
    from moleculardiffusion_mivit_tpu_torch.realdata import (
        demo,
        estimate_d_for_tracks,
        extract_particle_patches,
        refine_localizations,
        track_particles,
    )
    from moleculardiffusion_mivit_tpu_torch.sim import render_widefield

    tiles, particles, frames = 16, 10, 100
    rng = np.random.default_rng(16)
    starts = rng.uniform(14, demo.FIELD - 14, size=(tiles, particles, 1, 2))
    steps = rng.normal(0, np.sqrt(2 * demo.D_TRUE / demo.N_POS), size=(tiles, particles, frames * demo.N_POS, 2))
    steps[..., 0, :] = 0
    trajs = torch.tensor(starts + np.cumsum(steps, axis=2), dtype=torch.float32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    stage = {}
    t0 = time.perf_counter()
    movies = render_widefield(torch.Generator(device="cuda").manual_seed(16), trajs, demo.N_POS, demo.FIELD,
                              demo.OPTICS)
    side = 4 * demo.FIELD
    stack = movies.reshape(4, 4, frames, demo.FIELD, demo.FIELD).permute(2, 0, 3, 1, 4).reshape(frames, side, side)
    stack = stack.cpu().numpy()
    stage["render"] = time.perf_counter() - t0
    tracks, _, _ = track_particles(stack, device="cuda", **demo.TRACKING)
    stage["detect"], stage["track"] = track_particles.seconds["detect"], track_particles.seconds["link"]
    t0 = time.perf_counter()
    patches = extract_particle_patches(stack, tracks, demo.PATCH)
    stage["patches"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refined = refine_localizations(tracks, patches, demo.PATCH, device="cuda")
    stage["localize"] = time.perf_counter() - t0
    model = init_model(GeneralTransformer(demo.MODEL_CONFIG, embedding="deep_resnet"),
                       torch.Generator().manual_seed(6)).cuda().eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        d = estimate_d_for_tracks(tracks, stack, lambda v: model(v), patch_size=demo.PATCH,
                                  background_mean=demo.BG_MEAN, background_sigma=demo.BG_SIGMA,
                                  theoretical_max=demo.THEO_MAX, msd_calibration=0.375, refined_positions=refined,
                                  device="cuda")
    torch.cuda.synchronize()
    stage["predict"] = time.perf_counter() - t0
    d_msd = np.array([v["d_msd"] for v in d.values()])
    check(stack.shape == (frames, side, side) and len(tracks) >= 100 and len(d) == len(tracks)
          and np.isfinite([v["d_model"] for v in d.values()]).all() and np.isfinite(d_msd).all(),
          f"realdata: camera stack gave {len(tracks)} tracks, {len(d)} estimates")
    row = {"shape": list(stack.shape), "particles": tiles * particles, "tracks": len(tracks),
           "fits": len(refined), "fallbacks": sum(v["psf_size"] == 10.0 for v in refined.values()),
           "d_msd_median": float(np.median(d_msd)), "stage_s": stage,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit({"phase": "realdata", "part": "d_camera", "card": card, **row})
    return row


def phase_sim2real(torch, card):
    """The sim-to-real study (``realdata/sim2real.py``) at full width.

    (a) The randomized arm's panel render at the protocol's size: one
    cycle's 256 patch-following sequences × 25 frames (6,400 frames, P = 10,
    S = 9, u = 5) with each of the 8 members' sigma and intensities, in one
    K1 launch, against the plain version (1e-5 of the largest pixel) and
    against 8 one-sigma launches (bitwise), timed beside both. (b) + (c)
    The study through its entry point (``sim2real.main --train-cycles 4
    --movies-per-optics 1``): both arms trained 4 cycles of 256 sequences at
    batch 16 (K2/K3 once a step, K1 once a cycle: the panel's 8 sigmas in
    one launch), finite losses; one movie of each of the 7 test rows (one K1
    launch a row) scored by both arms, every row with a track and finite
    MAEs. Then the nominal row's movie through the pipeline on the card and
    on the CPU with both arms' trained weights (``_pipeline_card_against_cpu``).
    (d) Each stage's seconds. The path's launches are counted over (b) and
    (c)'s entry-point run."""
    import copy
    import tempfile

    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames, render_frames_reference
    from moleculardiffusion_mivit_tpu_torch.realdata import demo, sim2real
    from moleculardiffusion_mivit_tpu_torch.sim import brownian_motion
    from moleculardiffusion_mivit_tpu_torch.sim.render import widefield_subpositions
    from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    t_phase = time.perf_counter()
    panel = sim2real.RAND_PANEL
    k, per, t, p, s, u = len(panel), 256 // len(panel), 25, demo.N_POS, demo.PATCH, demo.OPTICS.upsampling_factor
    g = seeded_generator("cuda", 14)
    n = k * per
    d = 0.02 + 0.98 * torch.rand((n,), generator=g, device="cuda")
    seg = brownian_motion(g, n, t, p, d, dt=1.0).reshape(n, t, p, 2)
    pos = (s - 1) / 2.0 + seg - seg.mean(dim=2, keepdim=True) + torch.rand((n, t, 1, 2), generator=g, device="cuda") - 0.5
    x, y = (v.reshape(n * t, p).contiguous() for v in widefield_subpositions(pos.reshape(n, 1, t * p, 2), p, s, u))
    z = torch.randn(x.shape, generator=g, device="cuda").reshape(k, per * t, p)
    w = torch.cat([o.particle_intensity[0] / p + (o.particle_intensity[1] / p) * z[m] for m, o in enumerate(panel)])
    sigmas = tuple(o.gaussian_sigma_hr for o in panel)
    b, run = n * t, per * t
    render = lambda: render_frames(x, y, w, sigmas, s, u)  # noqa: E731

    def one_sigma_launches():
        return torch.cat([render_frames(x[m * run:(m + 1) * run], y[m * run:(m + 1) * run], w[m * run:(m + 1) * run],
                                        sig, s, u) for m, sig in enumerate(sigmas)])

    def plain():
        sig = torch.tensor(sigmas, dtype=torch.float32, device="cuda").view(k, 1, 1)
        return render_frames_reference(*(v.reshape(k, run, p) for v in (x, y, w)), sig, s, u).reshape(b, s, s)

    got, ref = render(), plain()
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), "sim2real: non-finite panel frames")
    check(err <= 1e-5 * scale, f"sim2real: panel render max|Δ| {err} > 1e-5·{scale}")
    eight = one_sigma_launches()
    eight_err = float((got - eight).abs().max())
    check(eight_err <= 1e-5 * scale, f"sim2real: panel render differs from {k} one-sigma launches by {eight_err}")
    check(torch.equal(got, render()), "sim2real: two panel renders differ")
    nbytes = 4 * (3 * b * p + b * s * s)
    bound_ms, by = bound(nbytes, b * p * (2 * s * u * 5 + 2 + s) + b * s * s * p * 2)
    k1_panel = dict(B=b, P=p, S=s, u=u, members=k, max_abs_err=err, tol=1e-5 * scale,
                    bitwise_equal_to_one_sigma_launches=bool(torch.equal(got, eight)),
                    one_sigma_launches_max_abs_err=eight_err,
                    ms=time_ms(torch, render, iters=100), device_ms=time_ms(torch, render, device_only=True),
                    one_sigma_launches_ms=time_ms(torch, one_sigma_launches, iters=100),
                    one_sigma_launches_device_ms=time_ms(torch, one_sigma_launches, device_only=True),
                    plain_ms=time_ms(torch, plain), bound_ms=bound_ms, bound_by=by)
    emit({"phase": "sim2real", "part": "a_panel_render", "card": card, **k1_panel})

    # (b) and (c): the study through its entry point, its launches counted from here
    counts0 = launch_counts()
    cycles = 4
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the study's prose, off the JSON lines
            study = sim2real.main(["--train-cycles", str(cycles), "--movies-per-optics", "1", "--out", out,
                                   "--seed", "0"])
        study_s = time.perf_counter() - t0
        written = json.loads(Path(out, "sim2real.json").read_text())
    launches = {name: v - counts0[name] for name, v in launch_counts().items()}
    report = study.report
    check(set(written) == {"d_true", "train_cycles", "movies_per_optics", "rows"}
          and list(written["rows"]) == list(sim2real.TEST_OPTICS), f"sim2real: sim2real.json {written}")
    for arm, trained in study.arms.items():
        check(len(trained.losses) == cycles and all(math.isfinite(v) for v in trained.losses),
              f"sim2real: {arm} losses {trained.losses}")
    for name, row in report["rows"].items():
        check(row is not None and row["n_tracks"] >= 1
              and all(math.isfinite(row[c]) for c in ("fixed_mae", "randomized_mae", "msd_mae")),
              f"sim2real: row {name}: {row}")
    steps = 2 * cycles * (256 // 16)
    for kernel in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[kernel] == steps, f"sim2real: {kernel} launches {launches[kernel]} != {steps}")
    rows = len(sim2real.TEST_OPTICS)
    check(launches["render_frames"] == 2 * cycles + rows,
          f"sim2real: K1 launches {launches['render_frames']} != {2 * cycles} cycles + {rows} rows")
    emit({"phase": "sim2real", "part": "bc_study", "card": card, "seconds": study_s, "rows": report["rows"],
          "arms": report["arms"], "stage_s": report["stage_s"], "launches": launches})

    # (c) the nominal row's movie on the card and on the CPU, both arms' trained weights
    stack = sim2real.make_movies(seeded_generator("cuda", 0, 3, 0), sim2real.NOMINAL, 1)[0]
    models = {arm: (trained.model, copy.deepcopy(trained.model).cpu()) for arm, trained in study.arms.items()}
    with contextlib.redirect_stdout(sys.stderr):
        row = _pipeline_card_against_cpu(torch, stack, models, "sim2real")
    emit({"phase": "sim2real", "part": "c_card_vs_cpu", "card": card, "row": "nominal", **row})
    emit({"phase": "sim2real", "part": "summary", "card": card, "k1_panel": k1_panel, "stage_s": report["stage_s"],
          "launches": launches, "seconds": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------------ bf16
# K2-bf16/K3-bf16 against their plain bf16 version on the card: the
# embedding to 1e-2 relative L2 and 1e-2 of its largest value, each
# gradient to 5e-2 relative L2 and 5e-2 of its largest value. Both round at
# the same places (the JAX kernel's), so what differs is the f32 order of
# the products' sums, which can move a value across a bf16 rounding
# boundary (one ulp, 2^-8), and the products and BatchNorms after it carry
# that on, most into the BN parameters' gradients (sums that cancel). The
# gradient limit sits between two readings of bf16_kernel_spread.py
# (results/bf16_kernel_spread): two sound bf16 implementations differ by at
# most 2.8 % at their worst gradient, the plain version in f32 lies at least
# 8.2 % from it in bf16; each row checks that this f32 control exceeds the
# limit. tests/test_torch_cuda.py holds the kernels to the same numbers.
# The BN statistics are f32: 1e-3 relative.
BF16_TOL, BF16_GRAD_L2_TOL, BF16_GRAD_MAX_TOL = 1e-2, 5e-2, 5e-2
# Part (a)'s shapes (B, T, S, E): between them they launch every tile of
# the bf16 conv kernel that the embedding's layers reach (64 or 128 rows by
# 32, 64 or 128 columns, 32 or 64 channels a stage) and every weight-gradient
# kernel: 2,430 (the batch-1 step), 10,140 and 162,240 (13×13 frames),
# 32,400 (the real-data patch model, E = 58 as the modular experiment's
# concat arm) and 38,880 rows.
BF16_SHAPES = ((1, 30, 9, 64), (1, 60, 13, 64), (16, 25, 9, 58), (16, 30, 9, 64), (16, 60, 13, 64))
# Device ms of the mma.sync kernels these replaced (K2-bf16, K3-bf16; the
# earlier figures in PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700 W):
# one member at batch 1 / 16, and 7 members at batch 1 / 16. A record, not a
# measurement of this run: the phase rows print it beside this run's device
# ms, and it stays out of the kernel rows that reach the ``kernels`` line.
REPLACED_MMA_SYNC_DEVICE_MS = {(1, 30, 9, 64): (0.1216, 0.2944), (16, 30, 9, 64): (0.3792, 0.8374),
                               ("members_7", 1): (0.2903, 0.6898), ("members_7", 16): (1.8242, 4.1685)}


def _kernel_args(fe, x, kernels, scales, biases, wfc, bfc):
    """The wrappers' arguments (packed, contiguous, detached) for the
    embedding inputs of ``_embedding_inputs``."""
    b, t, s, _ = x.shape
    weights = (kernels["initial"].reshape(9, 32), fe._pack_w3(kernels["rb1_conv1"]),
               kernels["rb1_skip"].reshape(32, 64), fe._pack_w3(kernels["rb1_conv2"]),
               fe._pack_w3(kernels["rb2_conv1"]), kernels["rb2_skip"].reshape(64, 128),
               fe._pack_w3(kernels["rb2_conv2"]))
    return (x.detach().reshape(b * t, s, s).contiguous(), tuple(w.detach().contiguous() for w in weights),
            fe._pack_rows([v.detach() for v in scales.values()]).contiguous(),
            fe._pack_rows([v.detach() for v in biases.values()]).contiguous(),
            wfc.detach().contiguous(), bfc.detach().contiguous())


def _bf16_inputs(torch, b, t, s, seed, e=64):
    """``_embedding_inputs`` rounded to bf16, as leaves."""
    x, kernels, scales, biases, wfc, bfc = _embedding_inputs(torch, b, t, s, seed, e)
    c = lambda v: v.detach().bfloat16().requires_grad_()  # noqa: E731
    return (c(x), {k: c(v) for k, v in kernels.items()}, {k: c(v) for k, v in scales.items()},
            {k: c(v) for k, v in biases.items()}, c(wfc), c(bfc))


def _bf16_bounds(r, n, e, m=1):
    """Bounds of K2-bf16 and K3-bf16 over ``m`` members of ``r`` rows,
    counted as the f32 rows are: bytes of the function's bf16 inputs,
    parameters, embedding and gradients and its f32 statistics (the
    activations K2 saves for K3 are the port's choice, not the function's,
    and are left out); operations: the six convs as bf16 products, the
    initial conv and the fc in f32."""
    simt, tensor = _embedding_flops(r, n, e)
    params = 9 * 32 + 9 * 32 * 64 + 32 * 64 + 9 * 64 * 64 + 9 * 64 * 128 + 64 * 128 + 9 * 128 * 128
    params += 2 * 7 * 128 + 128 * e + e
    k2 = bound(m * (2 * r + 2 * params + 2 * n * e + 4 * 7 * 2 * 128), m * simt, flops_bf16=m * tensor)
    k3 = bound(m * (2 * n * e + 2 * r + 2 * params + 2 * r + 2 * params), 2 * m * simt,
               flops_bf16=2 * m * tensor)
    return k2, k3


def _bf16_kernel_row(torch, fe, b, t=30, s=9, e=64):
    """K2-bf16/K3-bf16 at batch ``b`` through ``fused_deep_resnet_embed``
    against the plain bf16 version (``BF16_TOL``), both calls of each
    wrapper bitwise repeatable, and timed beside the f32 kernels on the
    same inputs in f32."""
    n, r = b * t, b * t * s * s
    x, kernels, scales, biases, wfc, bfc = _bf16_inputs(torch, b, t, s, seed=200 + b, e=e)
    leaves = [x, *kernels.values(), *scales.values(), *biases.values(), wfc, bfc]
    f0, b0 = fe.deep_resnet_embed_fwd_bf16.launches, fe.deep_resnet_embed_bwd_bf16.launches
    emb_k, st_k = fe.fused_deep_resnet_embed(x, kernels, scales, biases, wfc, bfc)
    emb_r, st_r = fe.deep_resnet_embed_reference(x, kernels, scales, biases, wfc, bfc)
    check(emb_k.dtype == emb_r.dtype == torch.bfloat16, f"K2-bf16 {b}: embedding dtype {emb_k.dtype}")
    ek, er = emb_k.detach().float(), emb_r.detach().float()
    err_fwd, scale_fwd = float((ek - er).abs().max()), float(er.abs().max())
    l2_fwd = float((ek - er).norm() / er.norm())
    check(err_fwd <= BF16_TOL * scale_fwd and l2_fwd <= BF16_TOL,
          f"K2-bf16 {b}: emb max|Δ| {err_fwd} (of {scale_fwd}), relative L2 {l2_fwd}")
    for name, _ in fe.BN_LAYOUT:
        for i in (0, 1):
            u, v = st_k[name][i], st_r[name][i]
            check(u.dtype == torch.float32 and torch.allclose(u, v, rtol=1e-3, atol=1e-3 * float(v.abs().max())),
                  f"K2-bf16 {b}: {name} statistic {i} differs")
    g_out = torch.randn(emb_r.shape, generator=torch.Generator(device="cuda").manual_seed(b), device="cuda")
    g_out = g_out.bfloat16()
    grads_k = torch.autograd.grad(emb_k, leaves, g_out, retain_graph=True)
    grads_r = torch.autograd.grad(emb_r, leaves, g_out, retain_graph=True)
    check((fe.deep_resnet_embed_fwd_bf16.launches - f0, fe.deep_resnet_embed_bwd_bf16.launches - b0) == (1, 1),
          f"K2-bf16/K3-bf16 {b}: not one launch each")
    err_bwd, worst, worst_l2, l2s = 0.0, 0.0, 0.0, []
    for i, (gk, gr) in enumerate(zip(grads_k, grads_r)):
        check(gk.dtype == torch.bfloat16, f"K3-bf16 {b}: gradient {i} is {gk.dtype}")
        gk, gr = gk.float(), gr.float()
        scale = float(gr.abs().max())
        ek = float((gk - gr).abs().max())
        l2 = float((gk - gr).norm() / gr.norm())
        check(ek <= BF16_GRAD_MAX_TOL * scale and l2 <= BF16_GRAD_L2_TOL,
              f"K3-bf16 {b}: gradient {i} max|Δ| {ek} (of {scale}), relative L2 {l2}")
        err_bwd, worst, worst_l2 = max(err_bwd, ek), max(worst, ek / scale), max(worst_l2, l2)
        l2s.append(l2)

    # how far bf16 arithmetic itself moves them: the plain version in f32 on
    # the same (bf16-valued) inputs, against the plain bf16 version
    leaves32 = [v.detach().float().requires_grad_() for v in leaves]
    it = iter(leaves32[1:])
    args32_ = ({k: next(it) for k in kernels}, {k: next(it) for k in scales}, {k: next(it) for k in biases},
               next(it), next(it))
    emb_f, _ = fe.deep_resnet_embed_reference(leaves32[0], *args32_)
    grads_f = torch.autograd.grad(emb_f, leaves32, g_out.float())
    f32_l2 = max(float((gf - gr.float()).norm() / gr.float().norm()) for gf, gr in zip(grads_f, grads_r))
    check(f32_l2 > BF16_GRAD_L2_TOL, f"K3-bf16 {b}: the f32 control {f32_l2} passes the gradient limit")

    args = _kernel_args(fe, x, kernels, scales, biases, wfc, bfc)
    g2 = g_out.reshape(n, e).contiguous()
    out1 = fe.deep_resnet_embed_fwd_bf16(*args)
    stages_fwd = fe.last_stage_launches()
    out2 = fe.deep_resnet_embed_fwd_bf16(*args)
    flat_fwd = lambda o: _defined(fe, [o[0], o[1], *(o[2][k] for k, _ in fe.SAVED), o[2]["pooled"]])  # noqa: E731
    for i, (u, v) in enumerate(zip(flat_fwd(out1), flat_fwd(out2))):
        check(torch.equal(u, v), f"K2-bf16 {b}: output {i} differs between two calls")
    saved = out1[2]
    bwd1 = fe.deep_resnet_embed_bwd_bf16(*args, saved, g2)
    stages_bwd = fe.last_stage_launches()
    bwd2 = fe.deep_resnet_embed_bwd_bf16(*args, saved, g2)
    flat_bwd = lambda o: _defined(fe, [o[0], *o[1], *o[2:]])  # noqa: E731
    for i, (u, v) in enumerate(zip(flat_bwd(bwd1), flat_bwd(bwd2))):
        check(torch.equal(u, v), f"K3-bf16 {b}: gradient {i} differs between two calls")

    args32 = tuple(tuple(w.float() for w in a) if isinstance(a, tuple) else a.float() for a in args)
    saved32 = fe.deep_resnet_embed_fwd(*args32)[2]
    g32 = g2.float()
    times = {}
    for what, fwd, bwd in (("bf16", lambda: fe.deep_resnet_embed_fwd_bf16(*args),
                            lambda: fe.deep_resnet_embed_bwd_bf16(*args, saved, g2)),
                           ("f32", lambda: fe.deep_resnet_embed_fwd(*args32),
                            lambda: fe.deep_resnet_embed_bwd(*args32, saved32, g32))):
        times[what] = {"k2": (time_ms(torch, fwd), time_ms(torch, fwd, device_only=True)),
                       "k3": (time_ms(torch, bwd), time_ms(torch, bwd, device_only=True))}
    with torch.no_grad():
        plain_fwd_ms = time_ms(torch, lambda: fe.deep_resnet_embed_reference(x, kernels, scales, biases, wfc, bfc))
    plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(emb_r, leaves, g_out, retain_graph=True))
    (b2, by2), (b3, by3) = _bf16_bounds(r, n, e)
    recorded = REPLACED_MMA_SYNC_DEVICE_MS.get((b, t, s, e), (None, None))
    row = {"phase": "bf16", "part": "a", "B": b, "T": t, "S": s, "E": e, "rows": r, "deterministic": True,
           "tolerance_rel_l2": {"k2": BF16_TOL, "k3": BF16_GRAD_L2_TOL},
           "tolerance_max_rel": {"k2": BF16_TOL, "k3": BF16_GRAD_MAX_TOL},
           "k2_rel_l2": l2_fwd, "k3_worst_rel_err": worst, "k3_worst_rel_l2": worst_l2, "k3_rel_l2_by_gradient": l2s,
           "plain_bf16_against_plain_f32_worst_gradient_rel_l2": f32_l2,
           "stage_launches": {"k2": stages_fwd, "k3": stages_bwd},
           "replaced_mma_sync_device_ms": dict(zip(("k2", "k3"), recorded)),
           "k2": dict(max_abs_err=err_fwd, ms=times["bf16"]["k2"][0], device_ms=times["bf16"]["k2"][1],
                      bound_share=b2 / times["bf16"]["k2"][1],
                      f32_kernel_ms=times["f32"]["k2"][0], f32_kernel_device_ms=times["f32"]["k2"][1],
                      plain_ms=plain_fwd_ms, bound_ms=b2, bound_by=by2),
           "k3": dict(max_abs_err=err_bwd, ms=times["bf16"]["k3"][0], device_ms=times["bf16"]["k3"][1],
                      bound_share=b3 / times["bf16"]["k3"][1],
                      f32_kernel_ms=times["f32"]["k3"][0], f32_kernel_device_ms=times["f32"]["k3"][1],
                      plain_ms=plain_bwd_ms, bound_ms=b3, bound_by=by3)}
    emit(row)
    return row


def _bf16_members(torch, fe, m, b, t=30, s=9, e=64):
    """K2-bf16/K3-bf16 over ``m`` members in one launch each (the denoising
    grid's 7 transformers at batch ``b``): every output bitwise equal to
    the member's own launch and to a second call; timed beside the
    one-member launches and the f32 kernels over the same members."""
    n, r = b * t, b * t * s * s
    inputs = [_bf16_inputs(torch, b, t, s, seed=300 + i, e=e) for i in range(m)]
    per = [_kernel_args(fe, *a) for a in inputs]
    stack = lambda j: (tuple(torch.stack([p[j][k] for p in per]) for k in range(7)) if j == 1  # noqa: E731
                       else torch.stack([p[j] for p in per]))
    args = tuple(stack(j) for j in range(6))
    g = torch.randn((m, n, e), generator=torch.Generator(device="cuda").manual_seed(b), device="cuda").bfloat16()
    f0 = fe.deep_resnet_embed_fwd_bf16.launches
    out = fe.deep_resnet_embed_fwd_bf16(*args)
    grads = fe.deep_resnet_embed_bwd_bf16(*args, out[2], g)
    check(fe.deep_resnet_embed_fwd_bf16.launches - f0 == 1, "K2-bf16 members: more than one launch")
    again = fe.deep_resnet_embed_fwd_bf16(*args), fe.deep_resnet_embed_bwd_bf16(*args, out[2], g)

    def flat_fwd(o, i=None):
        if i is not None:
            o = (o[0][i], o[1][i], {k: v[i] for k, v in o[2].items()})
        return _defined(fe, [o[0], o[1], *(o[2][k] for k, _ in fe.SAVED), o[2]["pooled"]])

    def flat_bwd(o, i=None):
        if i is not None:
            o = (o[0][i], tuple(w[i] for w in o[1]), *(v[i] for v in o[2:]))
        return _defined(fe, [o[0], *o[1], *o[2:]])

    for i in range(m):
        fwd1 = fe.deep_resnet_embed_fwd_bf16(*per[i])
        bwd1 = fe.deep_resnet_embed_bwd_bf16(*per[i], fwd1[2], g[i])
        for j, (u, v, w) in enumerate(zip(flat_fwd(fwd1), flat_fwd(out, i), flat_fwd(again[0], i))):
            check(torch.equal(u, v) and torch.equal(v, w), f"K2-bf16 members {b}: member {i} output {j}")
        for j, (u, v, w) in enumerate(zip(flat_bwd(bwd1), flat_bwd(grads, i), flat_bwd(again[1], i))):
            check(torch.equal(u, v) and torch.equal(v, w), f"K3-bf16 members {b}: member {i} gradient {j}")
    del again
    args32 = tuple(tuple(w.float() for w in a) if isinstance(a, tuple) else a.float() for a in args)
    saved32 = fe.deep_resnet_embed_fwd(*args32)[2]
    saved1 = [fe.deep_resnet_embed_fwd_bf16(*per[i])[2] for i in range(m)]
    calls = {
        "k2": (lambda: fe.deep_resnet_embed_fwd_bf16(*args),
               lambda: [fe.deep_resnet_embed_fwd_bf16(*per[i]) for i in range(m)],
               lambda: fe.deep_resnet_embed_fwd(*args32)),
        "k3": (lambda: fe.deep_resnet_embed_bwd_bf16(*args, out[2], g),
               lambda: [fe.deep_resnet_embed_bwd_bf16(*per[i], saved1[i], g[i]) for i in range(m)],
               lambda: fe.deep_resnet_embed_bwd(*args32, saved32, g.float())),
    }
    # the plain bf16 version of the same function: every member at once under vmap
    leaves = [torch.stack([a[0].detach() for a in inputs]).requires_grad_()]
    dicts = [{k: torch.stack([a[j][k].detach() for a in inputs]).requires_grad_() for k in inputs[0][j]}
             for j in (1, 2, 3)]
    fc = [torch.stack([a[j].detach() for a in inputs]).requires_grad_() for j in (4, 5)]
    leaves += [v for d in dicts for v in d.values()] + fc
    plain = lambda: torch.vmap(fe.deep_resnet_embed_reference)(leaves[0], *dicts, *fc)  # noqa: E731
    emb_r, _ = plain()
    with torch.no_grad():
        plain_ms = {"k2": time_ms(torch, plain, iters=3, warmup=1)}
    plain_ms["k3"] = time_ms(torch, lambda: torch.autograd.grad(emb_r, leaves, g.reshape(emb_r.shape),
                                                                retain_graph=True), iters=3, warmup=1)
    del emb_r
    bounds = dict(zip(("k2", "k3"), _bf16_bounds(r, n, e, m)))
    recorded = REPLACED_MMA_SYNC_DEVICE_MS.get(("members_7", b), (None, None)) if m == 7 else (None, None)
    row = {"phase": "bf16", "part": "a_members", "members": m, "B": b, "rows_per_member": r, "rows": m * r,
           "bitwise_equal_to_single_launches": True, "deterministic": True,
           "replaced_mma_sync_device_ms": dict(zip(("k2", "k3"), recorded))}
    for k, (one, singles, f32) in calls.items():
        device_ms = time_ms(torch, one, iters=10, device_only=True)
        row[k] = dict(ms=time_ms(torch, one, iters=10), device_ms=device_ms, bound_share=bounds[k][0] / device_ms,
                      single_launches_ms=time_ms(torch, singles, iters=5),
                      f32_kernel_ms=time_ms(torch, f32, iters=10),
                      f32_kernel_device_ms=time_ms(torch, f32, iters=10, device_only=True),
                      plain_ms=plain_ms[k],
                      bound_ms=bounds[k][0], bound_by=bounds[k][1])
    emit(row)
    return row


def _hgmma_counts(torch) -> dict:
    """``HGMMA`` (wgmma) instructions in the built library's bf16 conv and
    weight-gradient kernels, by kernel, from ``cuobjdump -sass`` where the
    toolkit has it (else None). Fails if one of them has none."""
    from moleculardiffusion_mivit_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.is_file():
        print("chip_smoke: no cuobjdump beside nvcc; HGMMA not counted", file=sys.stderr)
        return None
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path("fused_embedding"))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if "conv_bf16_kernel" in name or "wgrad_bf16_kernel" in name:
                counts[name] = 0
            else:
                name = None
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    check(len(counts) >= 2 and all(counts.values()),
          f"bf16 tensor-core kernels without wgmma (HGMMA by kernel: {counts})")
    return counts


def _bf16_kernels(torch):
    """Part (a) of phase bf16: the kernel rows at ``BF16_SHAPES`` and over 7
    members at batch 1 and 16, and the HGMMA count of the bf16 kernels.
    Returns the K2-bf16 and K3-bf16 rows of the ``kernels`` line (38,880
    rows, the others beside it)."""
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe

    hgmma = _hgmma_counts(torch)
    emit({"phase": "bf16", "part": "a_hgmma", "hgmma_by_kernel": hgmma})
    rows = {shape: _bf16_kernel_row(torch, fe, *shape) for shape in BF16_SHAPES}
    members = {b: _bf16_members(torch, fe, 7, b) for b in (1, 16)}
    out = []
    for k in ("k2", "k3"):
        row = dict(rows[(16, 30, 9, 64)][k])
        row["batch_1"] = rows[(1, 30, 9, 64)][k]
        row["shapes"] = {"x".join(map(str, shape)): rows[shape][k] for shape in BF16_SHAPES}
        row["members_7"] = {f"batch_{b}": members[b][k] for b in (1, 16)}
        row["hgmma_by_kernel"] = hgmma
        out.append(row)
    return out


def _all_f32(torch, exp) -> bool:
    """Every learned arm's master parameters, AdamW state and buffers are
    f32 (integer counters aside)."""
    for state in exp.states.values():
        tensors = [*state.model.parameters(), *state.model.buffers()]
        tensors += [v for s in state.optimizer.state.values() for v in s.values() if torch.is_tensor(v)]
        if any(t.is_floating_point() and t.dtype != torch.float32 for t in tensors):
            return False
    return True


def _timed_cycles(torch, exp, cycles: int = 2) -> list:
    """Seconds of each of ``cycles`` cycles (the first of a batch size
    captures its graphs)."""
    out = []
    for c in range(cycles):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run(1, start_cycle=c)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_bf16(torch, card):
    """The baseline experiment and a grid arm at ``compute_dtype=
    "bfloat16"`` through their entry points (``experiments.*.build`` +
    ``Experiment.set_compute_dtype`` + ``Experiment.run``, captured CUDA
    graphs), with the f32 figures beside them. (b) Baseline, all seven arms:
    at batch 16 two cycles captured and two eager from one seed agree
    bitwise (losses, validation MSEs, every parameter and buffer); at batch
    1 a capture cycle and a timed one, a cut-size cycle profiled, the losses finite
    and falling, K2-bf16/K3-bf16 recorded once a replay in exactly the two
    deepcnn arms' graphs and run once a step of each (the profiler's count
    of their pool kernels) and the f32 K2/K3 never; at batch 64 a capture
    cycle and a timed one; every master, AdamW state and BN buffer f32; s a
    cycle and seq/s at f32 at batch 1, 16 and 64 in the same process. (c)
    Denoising's ``trans_grid`` (7 deep-ResNet transformers in one grid) at
    bf16, ``CUT_SEQS_PER_D`` sequences a class: two cycles at batch 1 and
    two at 16 (the first captures, the second is timed), K2-bf16/K3-bf16
    once a grid step. (d) ``utils.flops.multi_cycle_flops`` of the baseline cycle at
    f32 and bf16, and each timed cycle's achieved TFLOP/s and MFU against
    ``device_peak_flops``."""
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline, denoising
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils import flops

    deep = ("deepcnn_2layer_s", "deepcnn_2layer_leaky")
    k23_bf16 = ("deep_resnet_embed_fwd_bf16", "deep_resnet_embed_bwd_bf16")
    engines = []
    t_phase = time.perf_counter()

    def build(batch, fused, dtype="bfloat16", **kw):
        exp = baseline.build(seed=0, device="cuda", **kw).set_compute_dtype(dtype)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    # (b) batch 16: captured against eager, bitwise (tolerance 0), then a timed cycle
    cap = _captured_against_eager(torch, build, "bf16", card, tol=0.0, seqs_per_d=None)
    check(_all_f32(torch, cap), "bf16: a master, AdamW state or buffer is not f32")
    n_seq = _sequences(cap)
    s_cycle = {"bfloat16": {16: _timed_cycles(torch, cap, 1)[0]}}
    models = {n: a.model for n, a in cap.arms.items() if a.model is not None}
    cfg = cap.train_cfg
    val_videos = [v["videos"] for v in cap.val_data.values()]
    val_shape = (sum(v.shape[0] for v in val_videos), *val_videos[0].shape[1:])
    del cap
    # batch 1: a capture cycle and a timed one (f32 is timed the same way
    # below), then a profiled one at the cut size
    exp, marks, prof, units1, losses = _batch_one_profiled(torch, build, "bf16", deep, renders=4, kernels=k23_bf16,
                                                           timed_cycles=2)
    check(_all_f32(torch, exp), "bf16: a master, AdamW state or buffer is not f32 after batch 1")
    check(not any(per.get(k, 0) for per in units1.values() for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd")),
          f"bf16: an f32 K2/K3 launch in a bf16 graph: {units1}")
    s_cycle["bfloat16"][1] = marks[2] - marks[1]
    del exp
    s_cycle["bfloat16"][64] = _timed_cycles(torch, build(64, True))[1]
    s_cycle["float32"] = {b: _timed_cycles(torch, build(b, True, dtype="float32"))[1] for b in (1, 16, 64)}
    counts1 = launch_counts()
    launches = kernel_launches(counts0, engines)
    # batch 16: three captured cycles and two eager; batch 1: three and two at
    # the cut size; batch 64: two
    want = len(deep) * (5 * (n_seq // 16) + 3 * n_seq + 2 * prof["profiled_sequences"] + 2 * (n_seq // 64))
    for k in k23_bf16:
        check(launches[k] == want, f"bf16: {k} launches {launches[k]} != {want}")
    f32_want = len(deep) * (2 * n_seq + 2 * (n_seq // 16) + 2 * (n_seq // 64))
    check(launches["deep_resnet_embed_fwd"] == f32_want, f"bf16: f32 K2 launches {launches} != {f32_want}")

    # (c) denoising's trans_grid at bf16: two cycles at batch 1 and two at 16,
    # the first of each capturing the graphs, the second timed
    grid_s, grid_capture_s, grid_losses = {}, {}, {}
    grid_engines = []
    for batch in (1, 16):
        g = denoising.build(seed=0, device="cuda", sequences_per_d=CUT_SEQS_PER_D).set_compute_dtype("bfloat16")
        del g.arms["resnet_grid"]
        g.train_cfg = g.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        g.build()
        grid_engines.append(g.engine)
        grid_capture_s[batch], grid_s[batch] = _timed_cycles(torch, g, 2)
        grid_losses[batch] = _member_losses(g)
        check(all(math.isfinite(x) for v in grid_losses[batch].values() for x in v) and len(grid_losses[batch]) == 7,
              f"bf16: trans_grid losses at batch {batch}: {grid_losses[batch]}")
        check(_all_f32(torch, g), "bf16: trans_grid master, AdamW state or buffer not f32")
        grid_seq = _sequences(g)
        del g
    grid_launches = kernel_launches(counts1, grid_engines)
    grid_want = 2 * (grid_seq + grid_seq // 16)
    for k in k23_bf16:
        check(grid_launches[k] == grid_want, f"bf16: trans_grid {k} launches {grid_launches[k]} != {grid_want}")
    for k, v in grid_launches.items():
        launches[k] += v

    # (d) FLOPs and MFU of the baseline cycle, its FLOPs counted once: they
    # depend neither on the batch size nor on the dtype (2.819e12 in every
    # earlier smoke at 1, 16 and 64, f32 and bf16)
    peak = flops.device_peak_flops()
    f = flops.multi_cycle_flops(models, cfg, 1, val_shape)
    mfu = {f"{dtype}_batch_{b}": {"s_per_cycle": s, "seq_per_s": n_seq / s, **flops.utilization(f, s, peak)}
           for dtype, by_batch in s_cycle.items() for b, s in by_batch.items()}
    emit({"phase": "bf16", "part": "b", "card": card, "arms": list(models), "sequences_per_cycle": n_seq,
          "captured_equal_to_eager_batch_16": True, "masters_optimizer_bn_f32": True,
          "s_per_cycle": s_cycle, "seq_per_s": {d: {b: n_seq / s for b, s in v.items()} for d, v in s_cycle.items()},
          "batch_1": {**_batch_one_times(marks, n_seq), **prof,
                      "launches_per_replay_by_unit": units1, "train_loss": losses}})
    emit({"phase": "bf16", "part": "c", "card": card, "grid": "denoising trans_grid", "members": 7,
          "sequences_per_cycle": grid_seq, "s_per_cycle": grid_s, "s_per_cycle_capture": grid_capture_s,
          "train_loss": grid_losses,
          "launches": grid_launches})
    emit({"phase": "bf16", "part": "d", "card": card, "peak_flops": peak,
          "flops_note": "matrix products and convolutions of every step and the validation forward; "
                        "generation not counted", "by_dtype_and_batch": mfu,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def _fgn_card_against_cpu(torch, card):
    """The fGn's deterministic part (``sim.trajectory._fgn_from_normals``)
    on the card and on the CPU from the same normals, at the smoke's Hurst
    exponents (α = 0.5, 1.0, 1.5) and 300 steps. Tolerance: 1e-5 of the
    series' sd plus three times the CPU f32 series' own distance from the
    f64 evaluation of the same formula. At H > ½ the f32 autocovariance
    cancels large terms, so two f32 evaluations (the CPU's, the card's, as
    JAX's) differ by what f32 itself is off, not by f32 rounding."""
    from moleculardiffusion_mivit_tpu_torch.sim import trajectory as tr

    g = torch.Generator().manual_seed(31)
    n, per = 300, 64
    zr, zi = (torch.randn((3 * per, 2 * n), generator=g) for _ in range(2))
    rows = {}
    for i, hurst in enumerate((0.25, 0.5, 0.75)):
        sl = slice(i * per, (i + 1) * per)
        h = torch.full((per,), hurst)
        cpu = tr._fgn_from_normals(h, zr[sl], zi[sl])
        exact = tr._fgn_from_normals(h.double(), zr[sl].double(), zi[sl].double())
        on_card = tr._fgn_from_normals(h.cuda(), zr[sl].cuda(), zi[sl].cuda()).cpu()
        sd = float(exact.std())
        cpu_off = float((cpu.double() - exact).abs().max()) / sd
        err = float((on_card - cpu).abs().max()) / sd
        tol = 1e-5 + 3 * cpu_off
        rows[f"H_{hurst}"] = {"card_vs_cpu_over_sd": err, "cpu_f32_vs_f64_over_sd": cpu_off,
                              "card_f32_vs_f64_over_sd": float((on_card.double() - exact).abs().max()) / sd,
                              "tolerance_over_sd": tol}
        check(err <= tol, f"constrained: fGn H={hurst} card vs CPU {err} > {tol} of the sd")
    emit({"phase": "constrained", "part": "b_fgn_card_vs_cpu", "card": card, "steps": n, "series": per,
          "by_hurst": rows})


def _walks_card_against_cpu(torch, card):
    """``reflected_walk`` and ``PiecewiseLinearGeometry.map_displacements`` on
    the card and on the CPU given the same displacements (drawn on the CPU):
    positions within 4 f32 ulps of the largest coordinate (the clamps and
    folds are exact IEEE operations; the rotation's cos, sin and 2×2 product
    may round differently)."""
    from moleculardiffusion_mivit_tpu_torch.sim import constrained as con
    from moleculardiffusion_mivit_tpu_torch.sim import mitochondria_demo

    g = torch.Generator().manual_seed(32)
    n, t = 256, 300
    rows = {}
    dxy = torch.stack([con.disp_fbm(g, 0.8, 1.0, t, 1.0, n) for _ in range(2)], dim=-1)
    geo = mitochondria_demo.build_skeleton()
    disp = con.disp_fbm(g, 1.0, 4.0, t, 1.0, n)
    for name, fn, arg in (
            ("reflected_walk", lambda d: con.reflected_walk(d, (5.0, -2.0), (2.0, 1.0), 0.3), dxy),
            ("map_displacements", lambda d: geo.map_displacements(d, geo.total_length / 2.0), disp)):
        cpu = fn(arg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = fn(arg.cuda())
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        err = float((on_card.cpu() - cpu).abs().max())
        tol = 4 * 2.0**-23 * float(cpu.abs().max())
        rows[name] = {"max_abs_diff": err, "tolerance": tol, "card_s": card_s}
        check(err <= tol, f"constrained: {name} card vs CPU {err} > {tol}")
    emit({"phase": "constrained", "part": "e_walks_card_vs_cpu", "card": card, "particles": n, "steps": t,
          "by_walk": rows})


def _msd_exponent(trajs, lags=(1, 2, 4, 8, 16, 32)) -> float:
    """Slope of log ensemble-MSD against log lag."""
    import numpy as np

    x = trajs.double()
    msd = [float(((x[:, lag:] - x[:, :-lag]) ** 2).sum(-1).mean()) for lag in lags]
    return float(np.polyfit(np.log(lags), np.log(msd), 1)[0])


def phase_constrained(torch, card):
    """The rest of ``sim/`` and the constrained-diffusion demo on the card.

    (a) ``single_state`` at α = 0.5, α = 1.5, α ~ N(1, 0.3), α = 0.5 with
    drift (0.5, −0.3) and α = 0.6 in a box of L = 5, 256 particles × 300
    steps (D ~ N(3, 1)), each timed and rendered through K1
    (``render_videos``: one launch, 7,680 frames): finite videos; the
    ensemble-MSD exponent within 0.1 of α (0.5, 1.5); the drawn α in [0, 2]
    with mean 1 ± 0.05; the mean step equal to the drift ± 0.05; every
    position inside the box. (b) The fGn's deterministic part on the card
    against the CPU from the same normals (``_fgn_card_against_cpu``). (e)
    The reflected walk and the path walk on the card against the CPU given
    the same displacements (``_walks_card_against_cpu``). (f) The demo
    through its entry point (``sim.mitochondria_demo.main --cycles 2``) at
    full width: K1 once per D class a cycle plus the evaluation render, K2
    and K3 once a step (64 a cycle at batch 1), finite losses and estimates.
    The path's launches are counted over (a) and (f)."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
    from moleculardiffusion_mivit_tpu_torch.sim import mitochondria_demo, render_videos, single_state
    from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    t_phase = time.perf_counter()
    n, t, cfg = 256, 300, TrainConfig()
    cases = {"alpha_0.5": dict(alphas=0.5), "alpha_1.5": dict(alphas=1.5), "alpha_1.0_sd_0.3": dict(alphas=(1.0, 0.3)),
             "alpha_0.5_drift": dict(alphas=0.5, drift=(0.5, -0.3)), "alpha_0.6_box_5": dict(alphas=0.6, L=5.0)}
    counts0 = launch_counts()
    rows = {}
    for i, (name, kw) in enumerate(cases.items()):
        g = seeded_generator("cuda", 30, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trajs, labels = single_state(g, n, t, Ds=(3.0, 1.0), **kw)
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        videos = render_videos(g, trajs / cfg.traj_div_factor, cfg, BASELINE_OPTICS)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0 - sim_s
        check(trajs.is_cuda and trajs.shape == (n, t, 2) and bool(torch.isfinite(trajs).all()),
              f"constrained: {name}: trajectories {tuple(trajs.shape)}")
        check(videos.shape == (n, t // cfg.n_pos_per_frame, 9, 9) and bool(torch.isfinite(videos).all()),
              f"constrained: {name}: videos {tuple(videos.shape)}")
        alpha = labels[:, 0, 0]
        row = {"sim_s": sim_s, "render_s": render_s, "alpha_mean": float(alpha.mean()),
               "msd_exponent": _msd_exponent(trajs)}
        if isinstance(kw["alphas"], float) and "drift" not in kw and "L" not in kw:
            check(abs(row["msd_exponent"] - kw["alphas"]) <= 0.1,
                  f"constrained: {name}: MSD exponent {row['msd_exponent']} for α = {kw['alphas']}")
        if name == "alpha_1.0_sd_0.3":
            check(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 2.0 and abs(row["alpha_mean"] - 1.0) <= 0.05,
                  f"constrained: {name}: drawn α {row['alpha_mean']} in [{float(alpha.min())}, {float(alpha.max())}]")
        if "drift" in kw:
            row["mean_step"] = torch.diff(trajs, dim=1).mean(dim=(0, 1)).tolist()
            check(all(abs(a - b) <= 0.05 for a, b in zip(row["mean_step"], kw["drift"])),
                  f"constrained: {name}: mean step {row['mean_step']} for drift {kw['drift']}")
        if "L" in kw:
            row["range"] = [float(trajs.min()), float(trajs.max())]
            check(row["range"][0] >= 0.0 and row["range"][1] <= kw["L"], f"constrained: {name}: outside the box {row}")
        rows[name] = row
    emit({"phase": "constrained", "part": "a_single_state", "card": card, "particles": n, "steps": t, "by_case": rows})
    sim_launches = {k: v - counts0[k] for k, v in launch_counts().items()}
    check(sim_launches["render_frames"] == len(cases), f"constrained: K1 launches {sim_launches}")

    _fgn_card_against_cpu(torch, card)
    _walks_card_against_cpu(torch, card)

    cycles = 2
    before = launch_counts()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # the demo's prose, off the JSON lines
            report = mitochondria_demo.main(["--cycles", str(cycles), "--seed", "0", "--out", out])
        demo_s = time.perf_counter() - t0
        written = json.loads(Path(out, "mitochondria_report.json").read_text())
    demo_launches = {k: v - before[k] for k, v in launch_counts().items()}
    steps = cycles * len(mitochondria_demo.D_TRAIN) * mitochondria_demo.N_TRAIN_PER_D  # batch 1
    check(written["mivit"] == report["mivit"] and all(math.isfinite(v) for v in report["train_loss"])
          and all(math.isfinite(report[k]) for k in ("msd_naive", "msd_confined", "mivit", "mivit_sd")),
          f"constrained demo: report {written}")
    check(demo_launches["render_frames"] == cycles * len(mitochondria_demo.D_TRAIN) + 1,
          f"constrained demo: K1 launches {demo_launches}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(demo_launches[k] == steps, f"constrained demo: {k} launches {demo_launches[k]} != {steps}")
    launches = {k: v - counts0[k] for k, v in launch_counts().items()}
    emit({"phase": "constrained", "part": "f_demo", "card": card, "seconds": demo_s, "cycles": cycles,
          "train_loss": report["train_loss"], "s_per_cycle": report["s_per_cycle"],
          "estimates": {k: report[k] for k in ("msd_naive", "msd_confined", "mivit", "mivit_sd")},
          "launches": demo_launches, "path_launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_changepoint(torch, card):
    """Sequence mode on the card and the change points that read it.

    (a) The baseline experiment in sequence mode (``experiments.baseline.
    build(sequences=True)`` + ``Experiment.run``: per-frame predictions,
    tail-swap mixing) at full width, all seven arms: at batch 16 two cycles
    captured and two eager from one seed agree (losses, validation MSEs,
    every parameter and buffer, 1e-4 relative), K2/K3 once a step of each
    deepcnn arm, K1 once per D class a cycle plus the validation renders.
    (b) A planted-transition set as ``examples/sequence_changepoint_demo.py``
    step 2 builds it: one cycle's data (4 classes × 64, a held-out seed)
    with the training augmentation's tail swaps (``mix_trajectory_tails``,
    the first half of each class swapped at a known frame) and the same
    sequences unmixed as constant-D controls, predicted per frame by
    ``deepcnn_2layer_s``. (c) ``detect_change_points`` on those
    predictions on the card and on the CPU: equal split indices, scores
    within 1e-5 relative; the planted and control score means."""
    from moleculardiffusion_mivit_tpu_torch.evaluation import detect_change_points
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.train.loop import generate_cycle_data, mix_trajectory_tails
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

    deep = ("deepcnn_2layer_s", "deepcnn_2layer_leaky")
    n_val_renders = 6
    engines = []
    t_phase = time.perf_counter()

    def build(batch, fused, **kw):
        exp = baseline.build(seed=0, sequences=True, device="cuda", **kw)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    cap = _captured_against_eager(torch, build, "changepoint", card, seqs_per_d=None)
    n_seq = _sequences(cap)
    for n, h in cap.history.items():
        check(all(math.isfinite(v) for vals in h.values() for v in vals), f"changepoint: {n}: non-finite val MSE")

    cfg = cap.train_cfg
    g = seeded_generator("cuda", 777)
    videos, labels = generate_cycle_data(fold_in(g, 0), cfg, cap.optics)
    mixed, mixed_labels = mix_trajectory_tails(fold_in(g, 1), videos, labels, len(cfg.training_ds), cfg.n_frames)
    changed = mixed_labels != mixed_labels[:, :1]
    planted = changed.any(dim=1)
    true_split = torch.where(planted, changed.int().argmax(dim=1), -1)
    launches = kernel_launches(counts0, engines)
    builds, cycles = 2, 2 * 2
    k1_want = n_val_renders * builds + len(cfg.training_ds) * (cycles + 1)
    k23_want = len(deep) * cycles * (n_seq // 16)
    check(launches["render_frames"] == k1_want, f"changepoint: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"changepoint: {k} launches {launches[k]} != {k23_want}")

    preds = {name: cap.predict("deepcnn_2layer_s", {"videos": v, "labels": None})[..., 0]
             for name, v in (("planted", mixed), ("control", videos))}
    check(all(p.shape == (n_seq, cfg.n_frames) and bool(torch.isfinite(p).all()) for p in preds.values()),
          f"changepoint: per-frame predictions {[tuple(p.shape) for p in preds.values()]}")
    scores, splits = {}, {}
    for name, p in preds.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        split_card, score_card = detect_change_points(p)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0)
        split_cpu, score_cpu = detect_change_points(p.cpu())
        check(torch.equal(split_card.cpu(), split_cpu), f"changepoint: {name}: split indices differ card vs CPU")
        rel = float(((score_card.cpu() - score_cpu).abs() / score_cpu.abs().clamp_min(1e-12)).max())
        check(rel <= 1e-5, f"changepoint: {name}: scores differ card vs CPU by {rel} relative")
        scores[name], splits[name] = score_cpu, split_cpu
        emit({"phase": "changepoint", "part": f"c_{name}", "card": card, "sequences": n_seq,
              "detect_ms_card": card_ms, "max_rel_score_diff": rel})
    sm = scores["planted"][planted.cpu()]
    auc = float((sm[:, None] > scores["control"][None, :]).double().mean()
                + 0.5 * (sm[:, None] == scores["control"][None, :]).double().mean())
    hit = planted.cpu()
    loc_err = (splits["planted"][hit] - true_split.cpu()[hit]).abs().double()
    emit({"phase": "changepoint", "part": "summary", "card": card, "planted": int(planted.sum()),
          "controls": n_seq, "mean_score_planted": float(sm.mean()), "mean_score_control": float(scores["control"].mean()),
          "roc_auc": auc, "median_split_error_frames": float(loc_err.median()),
          "val_avg": {n: h["val_avg"] for n, h in cap.history.items()}, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_changepoint_study(torch, card):
    """The change-point studies (``evaluation/changepoint_study.py``) at full
    width, cut in size.

    (a) The modular study with the hybrid arm (``build_modular``, three
    arms: images only, per-frame tokens concatenated, the hybrid) at batch
    16, ``CUT_SEQS_PER_D`` a class: two cycles captured and two eager from
    one seed agree (losses and every parameter and buffer, 1e-4 relative).
    (b) The held-out sets (planted transitions, controls, calibration;
    ``CUT_SEQS_PER_D`` a class) predicted per frame by each trained arm on
    the card, then ``score_planted`` on the card's predictions on the card
    and on the CPU: every report field equal, the scores' largest relative
    difference printed. (c) One ``main()`` call of each subcommand
    (``modular --with-hybrid --cycles 2``, ``demo --cycles 1``, 16 sequences
    a class): finite losses, the examples' report keys. K1 launches once a
    class a cycle, once a class for each held-out set and once for each
    validation set of the demo; K2/K3 once a step of each of the three
    modular arms and of the demo's two deepcnn arms: the phase computes
    these counts and holds the launches to them."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch.evaluation import changepoint_study as study
    from moleculardiffusion_mivit_tpu_torch.evaluation.changepoint import score_planted
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts

    t_phase = time.perf_counter()
    engines = []
    n_classes = len(study.TRAINING_DS)

    def build(batch, fused, sequences_per_d):
        exp = study.build_modular(0, sequences_per_d, True, device="cuda")
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    cap = _captured_against_eager(torch, build, "changepoint_study", card)
    n_seq = _sequences(cap)
    k1_want = 2 * 2 * n_classes
    k23_want = 2 * 2 * len(cap.arms) * (n_seq // 16)

    # (b) the held-out sets, scored on the card and on the CPU
    t0 = time.perf_counter()
    sets = study.planted_sets(cap.train_cfg, cap.optics, CUT_SEQS_PER_D, "cuda", with_hybrid=True)
    k1_want += 2 * n_classes
    labels = sets["planted"]["labels"] * cap.train_cfg.d_max_normalization
    scored = {}
    for name in cap.arms:
        preds = [study.predict_per_frame(cap, name, sets[k]) for k in ("planted", "control", "calibration")]
        check(all(p.shape == (n_classes * CUT_SEQS_PER_D, cap.train_cfg.n_frames) and bool(torch.isfinite(p).all())
                  for p in preds), f"changepoint_study: {name}: per-frame predictions {[tuple(p.shape) for p in preds]}")
        on_card = score_planted(*preds, labels)
        on_cpu = score_planted(*(p.cpu() for p in preds), labels.cpu())
        check(on_card == on_cpu, f"changepoint_study: {name}: score_planted on the card {on_card} != CPU {on_cpu}")
        scores = [detect_pair(torch, p) for p in preds]
        scored[name] = {"roc_auc": on_card["roc_auc"], "detection_rate": on_card["detection_rate"],
                        "max_rel_score_diff": max(scores)}
    torch.cuda.synchronize()
    emit({"phase": "changepoint_study", "part": "b_scored", "card": card, "sequences": n_classes * CUT_SEQS_PER_D,
          "by_arm": scored,
          "seconds": time.perf_counter() - t0})

    # (c) each subcommand through its entry point
    runs = {}
    for cmd, args in (("modular", ["--with-hybrid", "--cycles", "2", "--eval-per-class", str(CUT_SEQS_PER_D)]),
                      ("demo", ["--cycles", "1"])):
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                ran = study.main([cmd, *args, "--seqs-per-d", str(CUT_SEQS_PER_D), "--out", out, "--device", "cuda"])
            seconds = time.perf_counter() - t0
            name = "changepoint_modular.json" if cmd == "modular" else "changepoint_metrics.json"
            written = json.loads(Path(out, name).read_text())
        exp = ran.pop("experiment")
        engines.append(exp.engine)
        check(written == ran["report"], f"changepoint_study: {cmd}: the written report differs from main's")
        check(all(math.isfinite(v) for ls in ran["train_loss"].values() for v in ls),
              f"changepoint_study: {cmd}: non-finite training loss {ran['train_loss']}")
        cycles = len(next(iter(ran["train_loss"].values())))
        steps = sum(n_classes * CUT_SEQS_PER_D // exp.train_cfg.batch_size_for_cycle(c) for c in range(cycles))
        if cmd == "modular":
            check(set(written) >= {"mod_images", "mod_both_concat", "mod_hybrid"}, f"changepoint_study: {written}")
            k1_want += cycles * n_classes + 2 * n_classes
            k23_want += len(exp.arms) * steps
        else:
            check(written["n_controls"] == n_classes * study.DEMO_EVAL_PER_CLASS, f"changepoint_study: {written}")
            # the baseline renders its six validation sets (D = 1, 3, 5, 7, 9, the in-order grid) once
            k1_want += 6 + cycles * n_classes + 2 * n_classes
            k23_want += 2 * steps
        runs[cmd] = {"seconds": seconds, "report_seconds": ran["seconds"], "train_s": ran["train_s"],
                     "eval_s": ran["eval_s"], "train_loss": ran["train_loss"]}
        emit({"phase": "changepoint_study", "part": f"c_{cmd}", "card": card, **runs[cmd],
              "roc_auc": {k: v["roc_auc"] for k, v in written.items() if isinstance(v, dict) and "roc_auc" in v}
              or written.get("roc_auc")})

    launches = kernel_launches(counts0, engines)
    check(launches["render_frames"] == k1_want,
          f"changepoint_study: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"changepoint_study: {k} launches {launches[k]} != {k23_want}")
    emit({"phase": "changepoint_study", "part": "summary", "card": card, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_ensemble(torch, card):
    """The 8-member MiViT ensemble and the continuous-D curriculum
    (``experiments/ensemble.py``, ``experiments/continuous_d.py``) at full
    width, cut in size: ``ENSEMBLE_N`` = 80 sequences a member a cycle (the
    cut's 16 a class × 5).

    (a) One grid of 8 early-fusion MiViTs with the 25 features, one cycle
    at batch 16, captured and eager from one seed: every member's loss,
    parameters and buffers bitwise equal. One generation call of all 8
    members alone: one K1 launch. (b) ``ensemble.main --members 8 --cycles
    2`` (batch 1 by the schedule): finite losses, the example's four tables
    (``imft``, ``committed`` and both with the rotation TTA) finite on the
    full suites, K1 once a cycle for all members and once a suite, K2/K3
    once a grid step for all members and never in evaluation. (c)
    ``continuous_d.main --cycles 1``: the same for one model. The phase
    computes its K1/K2/K3 launches and holds them to these counts."""
    import tempfile

    import numpy as np

    from moleculardiffusion_mivit_tpu_torch.experiments import continuous_d, ensemble
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    t_phase = time.perf_counter()
    m, n = 8, ENSEMBLE_N
    engines = []
    counts0 = launch_counts()

    # (a) captured against eager, one cycle at batch 16
    runs = {}
    for fused in (True, False):
        exp = ensemble.build(0, m, n, device="cuda")
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=16)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        t0 = time.perf_counter()
        exp.run(1)
        torch.cuda.synchronize()
        runs[fused] = (exp, time.perf_counter() - t0)
    diffs = _compare_experiments(torch, runs[True][0], runs[False][0])
    check(len(diffs) == m and all(d["bitwise"] for d in diffs.values()),
          f"ensemble: captured and eager differ: {diffs}")
    cap = runs[True][0]
    before = launch_counts()
    data = cap.generate_fn(seeded_generator("cuda", 7, 0))
    torch.cuda.synchronize()
    gen_k1 = launch_counts()["render_frames"] - before["render_frames"]
    check(gen_k1 == 1, f"ensemble: one generation call of {m} members launched K1 {gen_k1} times")
    check(tuple(data["videos"].shape) == (m, n, 30, 9, 9) and tuple(data["features"].shape) == (m, n, 25)
          and tuple(data["labels"].shape) == (m, n, 1), f"ensemble: data {[tuple(v.shape) for v in data.values()]}")
    emit({"phase": "ensemble", "part": "a", "card": card, "batch": 16, "members": m, "sequences_a_member": n,
          "bitwise_equal": True, "s_cycle": {"captured": runs[True][1], "eager": runs[False][1]},
          "launches_per_replay": {"+".join(u.names): u.launches_per_replay for u in cap.engine.units.values()}})
    del runs, cap, exp, data

    # (b) and (c): the entry points
    ran = {}
    for name, mod, argv in (("ensemble", ensemble, ["--members", str(m), "--cycles", "2"]),
                            ("continuous_d", continuous_d, ["--cycles", "1"])):
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(sys.stderr):
                got = mod.main([*argv, "--n", str(n), "--out", out, "--device", "cuda"])
            seconds = time.perf_counter() - t0
            written = json.loads(Path(out, f"{name}_report.json").read_text())
        engines.append(got.pop("experiment").engine)
        check(written == got["report"], f"ensemble: {name}: the written report differs from main's")
        losses = np.asarray(got["train_loss"], dtype=np.float64)
        check(bool(np.isfinite(losses).all()), f"ensemble: {name}: non-finite training loss {got['train_loss']}")
        tables = ("imft", "imft_tta", "committed", "committed_tta") if name == "ensemble" else ("imft", "committed")
        for tag in tables:
            t = written[tag]
            vals = [v for k, v in t.items() if k not in ("per_d_mse", "d_values")] + t["per_d_mse"]
            check(all(math.isfinite(v) for v in vals), f"ensemble: {name}: {tag} {t}")
            check(len(t["per_d_mse"]) == (100 if tag.startswith("imft") else 70), f"ensemble: {name}: {tag} per-D")
        cycles = len(got["train_loss"])
        steps = sum(n // ensemble.train_config().batch_size_for_cycle(c) for c in range(cycles))
        want = {"train": {"k1": cycles, "k2": steps, "k3": steps}, "eval": {"k1": 2, "k2": 0, "k3": 0}}
        check(written["launches"] == want, f"ensemble: {name}: launches {written['launches']} != {want}")
        ran[name] = {"seconds": seconds, "train_s": got["train_s"], "eval_s": got["eval_s"],
                     "cycle_end_s": got["cycle_end_s"], "launches": written["launches"],
                     "imft": {k: written["imft"].get(k) for k in ("member_mse_mean", "ensemble_mse", "mse")
                              if k in written["imft"]}}
        emit({"phase": "ensemble", "part": f"b_{name}", "card": card, **ran[name]})

    launches = kernel_launches(counts0, engines)
    k1_want = 2 + 1 + sum(r["launches"]["train"]["k1"] + 2 for r in ran.values())
    k23_want = 2 * (n // 16) + sum(r["launches"]["train"]["k2"] for r in ran.values())
    check(launches["render_frames"] == k1_want, f"ensemble: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"ensemble: {k} launches {launches[k]} != {k23_want}")
    emit({"phase": "ensemble", "part": "summary", "card": card, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def _cut_suite(data: dict, n: int) -> dict:
    """The first ``n`` sequences of an in-order suite's videos and features
    (the first ``n`` / 10 D values), on the CPU."""
    return {"videos": data["videos"][:n].cpu(), "features": data["features"][:n].cpu(), "labels": None}


def phase_rescore(torch, card):
    """The rescoring studies over trained images-features runs and the
    CPU-sized examples (``experiments/tta_rescore.py``, ``seed_ensemble.py``,
    ``render_noise.py``, ``evaluation/msd_protocol.py``,
    ``sim/simulator_validation.py``).

    (a) A 2-cycle images-features run at the cut size (16 sequences a class,
    batch 1, captured), saved after cycles 1 and 2 as two members: trained
    this far, their in-order MSEs are ~7, where f32 evaluation on the card
    and on the CPU agree to ~2e-5 (at batch 16, 5 steps a cycle, the MSEs
    of ~20 put ``ft_mlp``'s 1.8e-4 apart). (b)
    ``tta_rescore.main`` on the second, ``seed_ensemble.main`` over both at
    render seeds 0 and 1, ``render_noise.main --renders 2``: the example's
    keys, finite values, K1 six launches a build (five validation sets and
    the suite) and one for both renders. (c) The same checkpoints and data
    (the first 20 sequences of the suite and of two renders) on the card
    and on the CPU: the seed ensemble's tables and the render-noise matrix
    and σs equal to 1e-4. (d) ``msd_protocol.main``: the 300-step 100-value
    suite's MSD_Perfect and MSD_Frame rows equal ``MSD_ROWS`` at
    ``MSD_RTOL``, and that suite is the closest for every arm;
    ``simulator_validation.main``: the 2:1 pixel shift, finite checks, K1
    six launches. The phase computes its K1/K2/K3 launches and holds them
    to these counts."""
    import tempfile

    import numpy as np

    from moleculardiffusion_mivit_tpu_torch.evaluation import msd_protocol
    from moleculardiffusion_mivit_tpu_torch.experiments import images_features, render_noise, seed_ensemble, tta_rescore
    from moleculardiffusion_mivit_tpu_torch.sim import simulator_validation
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment, save_experiment

    t_phase = time.perf_counter()
    counts0 = launch_counts()
    n = 5 * CUT_SEQS_PER_D
    deep_arms = 3  # im_tr, im_ft_early_tr, im_ft_late_tr
    with tempfile.TemporaryDirectory() as root:
        runs = [str(Path(root, f"member{m}")) for m in range(2)]
        # (a) two members from one 2-cycle run
        exp = images_features.build(seed=0, sequences_per_d=CUT_SEQS_PER_D, device="cuda")
        exp.build()
        for c, run in enumerate(runs):
            exp.run(1, start_cycle=c)
            save_experiment(exp, str(Path(run, "final")))
        torch.cuda.synchronize()
        engine, losses = exp.engine, {k: [float(x) for x in v] for k, v in exp.train_loss.items()}
        steps = sum(n // exp.train_cfg.batch_size_for_cycle(c) for c in range(2))
        check(all(math.isfinite(x) for v in losses.values() for x in v), f"rescore: training losses {losses}")
        t_train = time.perf_counter() - t_phase
        del exp

        # (b) the entry points on the card
        with contextlib.redirect_stdout(sys.stderr):
            tta = tta_rescore.main([runs[1], "--device", "cuda"])
            ens = [seed_ensemble.main([*runs, "--seed", str(r), "--out", str(Path(root, f"ens{r}")), "--device",
                                       "cuda"]) for r in (0, 1)]
            rn = render_noise.main([*runs, "--renders", "2", "--out", str(Path(root, "rn")), "--device", "cuda"])
        rows = list(tta["tta"].values()) + list(tta["plain"].values())
        check(len(rows) == 8 and all(math.isfinite(v) for t in rows for v in t.values()), f"rescore: tta {tta}")
        check(Path(runs[1], "tta_errors.csv").read_text().splitlines()[0] == "model,mse,std", "rescore: tta csv")
        for e in ens:
            check(list(e["report"])[:4] == ["members", "run_dirs", "seqs_per_d", "suite"]
                  and all(math.isfinite(v) for arm in seed_ensemble.ARMS for kind in ("plain", "tta")
                          for v in [*e["arms"][arm][kind]["member_mses"], e["arms"][arm][kind]["ensemble_mse"]]),
                  f"rescore: seed ensemble {e['report']}")
        check(np.isfinite(rn["mse_matrix_seed_x_render"]).all() and np.asarray(rn["mse_matrix_seed_x_render"]).shape
              == (2, 2) and math.isfinite(rn["ensemble_render_mean"]), f"rescore: render noise {rn['report']}")
        k1_builds = {"tta": tta["k1_launches"], "ens": [e["k1_launches"] for e in ens],
                     "renders": rn["k1_launches_renders"]}
        check(k1_builds == {"tta": 6, "ens": [6, 6], "renders": 1}, f"rescore: K1 launches {k1_builds}")
        emit({"phase": "rescore", "part": "b", "card": card, "train_s": t_train,
              "seconds": {"tta": tta["seconds"], "seed_ensemble": [e["seconds"] for e in ens],
                          "render_noise": rn["seconds"]}, "k1": k1_builds,
              "tta_im_ft_tr_rot": tta["tta"]["im_ft_tr_rot"]["mse"], "render_noise_grand_mean": rn["grand_mean"]})

        # (c) card against CPU on the same checkpoints and data
        diffs, built, got = {}, {}, {}
        for dev in ("cuda", "cpu"):  # the suite and the renders are the card's
            built[dev] = images_features.build(seed=0, sequences_per_d=CUT_SEQS_PER_D, val_d_values=(),
                                               with_in_order=dev == "cuda", device=dev)
            built[dev].build()
        cut, d_cut = 20, built["cuda"].in_order_data["d_values"][:2]
        suite = _cut_suite(built["cuda"].in_order_data, cut)
        renders = [_cut_suite(r, cut) for r in render_noise.make_renders(built["cuda"], 2)]
        with contextlib.redirect_stdout(sys.stderr):
            for dev, e in built.items():
                on = lambda d: {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in d.items()}  # noqa: E731
                _, tables = seed_ensemble.tables(seed_ensemble.member_predictions(e, on(suite), runs), d_cut)
                got[dev] = {"ens": tables, "rn": render_noise.score(e, [on(r) for r in renders], runs,
                                                                     "im_ft_early_tr", d_cut)}
        for arm in seed_ensemble.ARMS:
            for kind in ("plain", "tta"):
                a, b = got["cuda"]["ens"][arm][kind], got["cpu"]["ens"][arm][kind]
                diffs[f"{arm}/{kind}"] = max(abs(x - y) for x, y in zip([*a["member_mses"], a["ensemble_mse"],
                                                                          a["ensemble_std"]],
                                                                         [*b["member_mses"], b["ensemble_mse"],
                                                                          b["ensemble_std"]]))
        a, b = got["cuda"]["rn"], got["cpu"]["rn"]
        diffs["render_noise"] = max(
            float(np.abs(np.subtract(a["mse_matrix_seed_x_render"], b["mse_matrix_seed_x_render"])).max()),
            *(abs(a[k] - b[k]) for k in ("seed_sigma_at_fixed_render", "render_sigma_of_seed_mean",
                                         "grand_mean", "ensemble_render_mean", "ensemble_render_std")))
        check(all(v <= 1e-4 for v in diffs.values()), f"rescore: card against CPU {diffs}")
        emit({"phase": "rescore", "part": "c", "card": card, "sequences": cut, "max_abs_diff": max(diffs.values())})
        del built

    # (d) the CPU-sized examples on the card
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(sys.stderr):
        msd = msd_protocol.main(["--out", out, "--device", "cuda"])
        k1 = launch_counts()["render_frames"]
        sim = simulator_validation.main(["--out", out, "--device", "cuda"])
        sim_k1 = launch_counts()["render_frames"] - k1
    main_suite = msd["suites"][2]
    check("100 D (0.1-10.0), 300 steps" in main_suite["suite"],
          f"rescore: suite order {[s['suite'] for s in msd['suites']]}")
    for name, want in MSD_ROWS.items():
        got_mse = main_suite["tables"][name]["mse"]
        check(abs(got_mse / want - 1.0) <= MSD_RTOL, f"rescore: msd_protocol {name} {got_mse} != {want}")
    check(all(b["suite"] == main_suite["suite"] for b in msd["closest"].values()) and len(msd["closest"]) == 3,
          f"rescore: closest protocol {msd['closest']}")
    check(sim["check5_pixel_shift"] == {"at_100nm": 2, "at_200nm": 1}, f"rescore: pixel shift {sim}")
    check(all(math.isfinite(sim[k][s]) for k in ("check2_loop_closure", "check3_coarse_sampling",
                                                "check4_localization_noise") for s in ("mean", "se"))
          and all(math.isfinite(r["contrast"]) for r in sim["check6_snr"]), f"rescore: simulator checks {sim}")
    check(sim_k1 == 6, f"rescore: simulator validation launched K1 {sim_k1} times")

    launches = kernel_launches(counts0, [engine])
    # (a) 5 validation sets and 5 classes a cycle; (b) 6 a build, one for
    # both renders; (c) the card's suite and its two renders; (d) 6
    k1_want = 5 + 2 * 5 + 6 + 2 * 6 + (5 + 1) + (1 + 1) + 6
    check(launches["render_frames"] == k1_want, f"rescore: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == deep_arms * steps, f"rescore: {k} launches {launches[k]} != {deep_arms * steps}")
    emit({"phase": "rescore", "part": "summary", "card": card, "launches": launches,
          "msd_seconds": msd["seconds"], "simulator_seconds": sim["seconds"], "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_serving(torch, card):
    """The serving path (``evaluation/serving.py``, the port of
    ``examples/serving_benchmark.py``): ``serving.main`` at ``--batches 256
    1024 4096 --iters 5 --tta --bf16`` (the bf16-cast flagship and its
    4-rotation TTA, each captured in a CUDA graph and held bitwise against
    its eager call at every batch), then ``--per-arm`` into a temporary
    file. Checked: finite rows with the example's keys, every capture equal
    to its eager call, ``max_pred_delta_d_units`` finite and at most
    ``SERVING_BF16_DELTA_LIMIT``, the five arms each ≥ 0 in the file, the
    f32 flagship's predictions (eager and captured) on the card against the
    CPU's on the same weights and a 64-sequence batch at 1e-4 relative, and
    no launch of K1, K2 or K3: at ``train=False`` the deep-ResNet embedding
    runs cuDNN convolutions, as the JAX package routes it to XLA."""
    import tempfile

    from moleculardiffusion_mivit_tpu_torch.evaluation import serving
    from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts

    t_phase = time.perf_counter()
    counts0 = launch_counts()
    with tempfile.TemporaryDirectory() as root, contextlib.redirect_stdout(sys.stderr):
        report = serving.main(["--batches", "256", "1024", "4096", "--iters", "5", "--tta", "--bf16"])
        times_path = Path(root, "inference_times.json")
        per_arm = serving.main(["--batches", "256", "--iters", "5", "--per-arm", str(times_path)])["per_arm"]
        written = json.loads(times_path.read_text())
    rows = report["rows"]
    keys = ["batch", "latency_ms", "seqs_per_sec", "max_pred_delta_d_units", "tta_latency_ms", "tta_cost_factor"]
    check([r["batch"] for r in rows] == [256, 1024, 4096] and all(list(r) == keys for r in rows)
          and all(math.isfinite(v) and v > 0 for r in rows for v in r.values()), f"serving: rows {rows}")
    held = report["captured_equals_eager"]
    check(held == [(b, f) for b in (256, 1024, 4096) for f in ("plain", "tta")],
          f"serving: captured against eager {held}")
    deltas = [r["max_pred_delta_d_units"] for r in rows]
    check(all(d <= SERVING_BF16_DELTA_LIMIT for d in deltas),
          f"serving: bf16 prediction delta {deltas} above {SERVING_BF16_DELTA_LIMIT}")
    check(written == per_arm and list(written) == list(serving.ARMS)
          and all(len(v) == 2 and v[0] >= 0 and math.isfinite(v[0]) for v in written.values()),
          f"serving: per-arm file {written}")

    # the f32 flagship on the card against the CPU, on the same weights
    with torch.inference_mode():
        videos = serving.make_videos(0, 64, "cpu")
        want = serving.initialised(serving.flagship(), 0, "cpu")(videos)
        model = serving.initialised(serving.flagship(), 0, "cuda")
        eager = model(videos.cuda()).cpu()
        captured = serving.served(model, (videos.cuda(),))().cpu()
    rel = {k: float((v - want).abs().max() / want.abs().max()) for k, v in (("eager", eager), ("captured", captured))}
    check(all(v <= 1e-4 for v in rel.values()), f"serving: card against CPU {rel}")

    counts = launch_counts()
    launches = {k: counts[k] - counts0[k] for k in counts}
    check(not any(launches.values()), f"serving: kernels launched on the serving path {launches}")
    emit({"phase": "serving", "card": card, "rows": rows, "peak": report["peak"], "per_arm_ms_per_10k": per_arm,
          "card_against_cpu": rel, "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


def detect_pair(torch, preds) -> float:
    """The largest relative difference between ``detect_change_points``'
    scores of ``preds`` on the card and on the CPU (the split indices must
    be equal)."""
    from moleculardiffusion_mivit_tpu_torch.evaluation import detect_change_points

    split_card, score_card = detect_change_points(preds)
    split_cpu, score_cpu = detect_change_points(preds.cpu())
    check(torch.equal(split_card.cpu(), split_cpu), "changepoint_study: split indices differ card vs CPU")
    return float(((score_card.cpu() - score_cpu).abs() / score_cpu.abs().clamp_min(1e-12)).max())


# Phase mesh's cycles: MESH_SEQS_PER_D sequences a class, the whole cycle one
# minibatch (16 sequences for the baseline, 22 a member for psfnoise), so a
# cycle is one AdamW step and what it records is that first step's.
# The dropout rate of phase dropout's arm and of phase mesh's bf16 run (the
# JAX package's mesh and training tests train at 0.1), and the arm: the
# baseline's deep-ResNet transformer at its full width (K2/K3 on its path).
DROPOUT = 0.1
DROPOUT_ARM = "deepcnn_2layer_s"


def _dropout_experiment(seqs_per_d: int, dropout: float = DROPOUT, dtype: str = "float32"):
    """The baseline experiment (seed 0, on the card, not built) cut to one
    arm, ``DROPOUT_ARM`` at ``dropout``, ``seqs_per_d`` sequences a class,
    trained at ``dtype``."""
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline
    from moleculardiffusion_mivit_tpu_torch.experiments.base import ModelEntry
    from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer

    exp = baseline.build(seed=0, device="cuda", sequences_per_d=seqs_per_d, try_leaky_relu=False)
    arm = exp.arms[DROPOUT_ARM]
    model = GeneralTransformer(arm.model.config.replace(dropout=dropout), embedding="deep_resnet")
    exp.arms = {DROPOUT_ARM: ModelEntry(model=model, slice_fn=arm.slice_fn)}
    return exp.set_compute_dtype(dtype)


def phase_dropout(torch, card):
    """Keyed dropout (``models.dropout``) on the training path: the
    baseline cut to ``DROPOUT_ARM`` at dropout ``DROPOUT``, ``CUT_SEQS_PER_D``
    sequences a class, through ``Experiment.run``. (a) At batch 16 two
    cycles captured and two eager from one seed: bitwise equal (losses,
    validation MSEs, every parameter and buffer), each replay drawing the
    masks of its step. (b) The masks of the eager run's first step at each
    of the arm's attention dropouts (read by a hook: the output is nonzero
    where the mask keeps, on the inputs that are nonzero) bitwise equal to
    ``dropout_mask`` on the CPU for the step's key and ``idx[0]``, and
    every site's mask for that step card against CPU; the kept share.
    (c) At batch 1 captured, three cycles: finite losses, falling. (d) The
    kernels one replay of the batch-16 graph runs, and their device ms,
    with dropout and at dropout 0 (a twin built alike). K1/K2/K3 launches
    against the counts the phase computes; they are listed apart from the
    other paths' (path ``dropout``)."""
    from moleculardiffusion_mivit_tpu_torch.models import dropout as tdrop
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts
    from moleculardiffusion_mivit_tpu_torch.train.loop import epoch_permutation
    from moleculardiffusion_mivit_tpu_torch.utils.rng import dropout_key, seeded_generator

    t_phase = time.perf_counter()
    engines = []

    def build(batch, fused, dropout=DROPOUT):
        exp = _dropout_experiment(CUT_SEQS_PER_D, dropout)
        exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=batch)
        exp.fused_cycles = fused
        exp.build()
        engines.append(exp.engine)
        return exp

    counts0 = launch_counts()
    runs, seen = {}, []
    for fused in (True, False):
        exp = build(16, fused)
        cfg = exp.arms[DROPOUT_ARM].model.config
        hooks = []
        if not fused:  # the eager first step's attention masks, layer by layer
            for layer in range(cfg.num_layers):
                mod = getattr(exp.states[DROPOUT_ARM].model.transformer, f"layer_{layer}").self_attn.dropout
                hooks.append(mod.register_forward_hook(
                    lambda m, args, out: seen.append((m.site, args[0].cpu(), out.cpu()))
                    if m.training and len(seen) < cfg.num_layers else None))
        exp.run(2)
        for h in hooks:
            h.remove()
        runs[fused] = exp
    cap, eag = runs[True], runs[False]
    diffs = _compare_experiments(torch, cap, eag)
    check(all(d["bitwise"] for d in diffs.values()), f"dropout: captured and eager differ: {diffs}")

    # (b) the first step's key and idx[0]: Experiment.run's stream of arm 0
    # in cycle 0
    n_seq, train_cfg = _sequences(cap), cap.train_cfg
    g = seeded_generator("cuda", train_cfg.seed + 1, 0, 1, 0)
    first = epoch_permutation(g, n_seq, 16, "cuda")[0, 0]
    key = dropout_key(g)
    keep = 1 - DROPOUT
    hooked = []
    for site, x, out in seen:
        want = tdrop.dropout_mask(tdrop.step_key(torch.tensor(key), first.cpu()), site, 0, x.shape, keep)
        live = x != 0
        hooked.append({"site": site, "live_share": float(live.float().mean()),
                       "equal": bool(torch.equal((out != 0)[live], want[live]))})
    check(len(hooked) == cfg.num_layers and all(h["equal"] and h["live_share"] > 0.99 for h in hooked),
          f"dropout: the eager step's attention masks are not the CPU's: {hooked}")
    tokens = train_cfg.n_frames + 1
    site_shapes = ((16, cfg.num_heads, tokens, tokens), (16, tokens, cfg.embed_dim),
                   (16, tokens, cfg.hidden_dim), (16, tokens, cfg.embed_dim))
    kept, card_equal = [], True
    for layer in range(cfg.num_layers):
        for k, shape in enumerate(site_shapes):
            site = 4 * layer + k
            on = [tdrop.dropout_mask(tdrop.step_key(torch.tensor(key, device=d), first.to(d)), site, 0, shape, keep)
                  for d in ("cpu", "cuda")]
            card_equal &= bool(torch.equal(on[0], on[1].cpu()))
            kept.append(float(on[1].float().mean()))
    check(card_equal, "dropout: a site's mask on the card differs from the CPU's")

    # (c) batch 1, captured: three cycles, the losses falling
    one = build(1, True)
    one.run(3)
    losses = _member_losses(one)[DROPOUT_ARM]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"dropout: batch-1 losses not finite and falling: {losses}")
    torch.cuda.synchronize()
    launches = kernel_launches(counts0, engines)
    # three builds (six validation renders each), 2 × 2 + 3 cycles (a
    # render a class); K2/K3 once a step: 2 × 2 × (n_seq / 16) + 3 × n_seq
    k1_want, k23_want = 6 * 3 + 4 * (2 * 2 + 3), 2 * 2 * (n_seq // 16) + 3 * n_seq
    check(launches["render_frames"] == k1_want, f"dropout: K1 launches {launches['render_frames']} != {k1_want}")
    for k in ("deep_resnet_embed_fwd", "deep_resnet_embed_bwd"):
        check(launches[k] == k23_want, f"dropout: {k} launches {launches[k]} != {k23_want}")

    # (d) one replay of the batch-16 graph with dropout and at dropout 0
    # (after the counts: these replays are not the main path's)
    twin = build(16, True, dropout=0.0)
    twin.run(1)
    per_replay = {}
    for what, exp in (("dropout", cap), ("no_dropout", twin)):
        unit = next(iter(exp.engine.units.values()))
        unit.counter.zero_()
        _, _, device_ms, n_kernels, _ = _profiled(torch, unit.graph.replay)
        per_replay[what] = {"kernels": n_kernels, "device_ms": device_ms}
    emit({"phase": "dropout", "card": card, "arm": DROPOUT_ARM, "dropout": DROPOUT, "sequences": n_seq,
          "a": {"batch": 16, "cycles": 2, "bitwise_equal": True, "captures": cap.engine.captures,
                "replays": cap.engine.replays},
          "b": {"key": key, "idx0": int(first), "hooked_attention_masks": hooked, "card_equals_cpu": card_equal,
                "kept_share_by_site": kept},
          "c": {"batch": 1, "train_loss": losses}, "d_one_batch16_replay": per_replay,
          "launches": {k: v for k, v in launches.items() if v}, "phase_s": time.perf_counter() - t_phase})
    return launches


MESH_SEQS_PER_D = 4
# The first step of a sharded arm against the same step unsharded, the
# bounds of tests/test_torch_parallel.py's one-step cases: losses at 1e-5
# relative (continuous in the rounding: 6e-8 to 3e-7 on the card, where
# per-rank BatchNorm statistics give 1e-3 to 6e-2); gradients at 1e-3 of
# the largest (a grid's: of each member's own; some, such as an attention
# key bias's, are zero but for rounding), but a ResNet arm's at 1e-1: its
# training forward sums BatchNorm's statistics in another order when its
# rows are split, so an element of a residual block's output lying within
# that rounding of ReLU's kink can land on the other side, and BatchNorm's
# backward, which centres the channel's gradient, spreads the change over
# the channel's convolution weights (the baseline's ResNet at data=2 read
# 1.29e-2 in one layer2 channel on the card, the same step in float64
# 0 and 8e-6 in two f32 orders; a gradient not summed over the ranks is off
# by 50 %); parameters at 2.5·lr (Adam's first update is ±lr·sign(g), so
# they cannot see a fault); BatchNorm running statistics, which that
# step's batch statistics set, at 1e-3 of the tensor's largest (they carry
# the data's scale: a noisy psfnoise cell's first variance is ~1e4). A
# per-rank-BatchNorm mutation of the baseline must miss the losses' and the
# gradients' bounds.
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_RTOL = 1e-3
MESH_GRAD_RTOL_RESNET = 1e-1
MESH_LR_ATOL = 2.5
MESH_BUFFER_RTOL = 1e-3
MESH_RANK_TIMEOUT_S = 120


def _mesh_build(name, fused=False):
    """Phase mesh's experiment ``name`` (``baseline``, ``psfnoise``, or
    ``bf16_dropout``: ``_dropout_experiment`` at bf16) at full width, seed
    0, ``MESH_SEQS_PER_D`` sequences a class, its whole cycle one
    minibatch, on the current card (not built)."""
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline, psfnoise

    if name == "bf16_dropout":
        exp = _dropout_experiment(MESH_SEQS_PER_D, dtype="bfloat16")
    else:
        exp = {"baseline": baseline, "psfnoise": psfnoise}[name].build(
            seed=0, device="cuda", sequences_per_d=MESH_SEQS_PER_D)
    exp.train_cfg = exp.train_cfg.replace(adaptive_batch_size=-1, fixed_batch_size=_sequences(exp))
    exp.fused_cycles = fused
    return exp


def _mesh_record(torch, exp, predictions=True) -> dict:
    """What phase mesh compares of an experiment after its cycle, on the
    CPU: each model's losses and ``val_avg``, each arm's parameters and
    buffers, the step's gradients and, with ``predictions``, every arm's
    validation predictions (a collective on a mesh: every rank calls it in
    one order)."""
    from moleculardiffusion_mivit_tpu_torch.experiments.base import GridArm
    from moleculardiffusion_mivit_tpu_torch.models import MultiImageResNet

    preds = {}
    if predictions:
        combined = exp._combined_val()[0]
        preds = {arm_name: (exp._grid_predictions(arm_name, arm, combined) if isinstance(arm, GridArm)
                            else exp.predict(arm_name, combined)).cpu()
                 for arm_name, arm in exp.arms.items() if arm.model is not None}
    return {"losses": _member_losses(exp), "val_avg": {n: list(h["val_avg"]) for n, h in exp.history.items()},
            "states": {a: {k: v.to("cpu", copy=True) for k, v in st.model.state_dict().items()}
                       for a, st in exp.states.items()},
            "buffers": {a: {n for n, _ in st.model.named_buffers()} for a, st in exp.states.items()},
            "grads": {a: {n: p.grad.to("cpu", copy=True) for n, p in st.model.named_parameters()
                          if p.grad is not None} for a, st in exp.states.items()},
            "preds": preds, "members": {a: (sl.start, sl.stop) for a, sl in exp._members.items()},
            "resnet_arms": {a for a, arm in exp.arms.items() if isinstance(arm.model, MultiImageResNet)}}


# (backend, ranks) -> phase mesh's runs in its rank processes: (key,
# experiment, mesh). Over gloo on one card psfnoise's grids split over
# model and the baseline's batch over data; over NCCL, on two or four
# cards, the same with data over the rest. A key ending in ``per_rank_bn``
# is the baseline with its BatchNorm statistics taken on each rank's rows
# alone (``current_rows`` blinded, as tests/torch_parallel_worker.py
# does), which must miss the losses' and the gradients' bounds.
MESH_RUNS = {
    ("gloo", 2): (("psfnoise", "psfnoise", dict(data=1, model=2)), ("baseline", "baseline", dict(data=2, model=1)),
                  ("baseline_per_rank_bn", "baseline", dict(data=2, model=1)),
                  ("bf16_dropout", "bf16_dropout", dict(data=2, model=1))),
    ("nccl", 2): (("psfnoise", "psfnoise", dict(data=1, model=2)), ("baseline", "baseline", dict(data=2, model=1)),
                  ("baseline_per_rank_bn", "baseline", dict(data=2, model=1)),
                  ("bf16_dropout", "bf16_dropout", dict(data=2, model=1))),
    ("nccl", 4): (("psfnoise", "psfnoise", dict(data=2, model=2)), ("baseline", "baseline", dict(data=4, model=1)),
                  ("baseline_per_rank_bn", "baseline", dict(data=4, model=1)),
                  ("bf16_dropout", "bf16_dropout", dict(data=4, model=1))),
}
# The bf16 run (``bf16_dropout``: one deep-ResNet arm at dropout 0.1, K2-
# bf16/K3-bf16 on the gathered rows, dropout on the global rows) against
# the same step unsharded at bf16, by the JAX package's bounds for its
# sharded bf16 cycle (tests/test_parallel.py): losses at 1e-2 relative
# plus 1e-3, parameters at 4·lr, predictions at 1e-3 relative plus 5e-3;
# its gradients, each rank's K3-bf16 partial rounded to bf16 before the
# f32 sum, at phase bf16's ``BF16_GRAD_MAX_TOL`` of their largest. Its
# launches are listed apart (path ``mesh_bf16_dropout``).
MESH_BF16_LOSS = (1e-2, 1e-3)
MESH_BF16_PARAM_LR = 4.0
MESH_BF16_PRED = (1e-3, 5e-3)


# (backend, ranks) -> phase mesh's generation-only checks in its rank
# processes: (experiment, mesh) at the protocol's size (64 sequences a
# class): the baseline, images-features and denoising split their classes
# over the ranks (denoising's grids of 7 take no model axis of 2 or 4),
# psfnoise its classes over data and its 30 members over model
MESH_GEN_RUNS = {
    ("gloo", 2): (("baseline", dict(data=2, model=1)), ("images_features", dict(data=2, model=1)),
                  ("denoising", dict(data=2, model=1)), ("psfnoise", dict(data=1, model=2))),
    ("nccl", 2): (("baseline", dict(data=2, model=1)), ("images_features", dict(data=2, model=1)),
                  ("denoising", dict(data=2, model=1)), ("psfnoise", dict(data=1, model=2))),
    ("nccl", 4): (("baseline", dict(data=4, model=1)), ("images_features", dict(data=4, model=1)),
                  ("denoising", dict(data=4, model=1)), ("psfnoise", dict(data=2, model=2))),
}
MESH_GEN_REPEATS = 3


def _bitwise(torch, a, b) -> bool:
    """Whether two tensors hold the same bytes in the same shape and dtype."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().flatten().view(torch.uint8), b.contiguous().flatten().view(torch.uint8)))


def _part_is_whole(torch, exp, part, got, whole) -> bool:
    """Whether a rank's gathered cycle ``got`` is bitwise the unsharded
    ``whole``: every value, or where its part holds a grid's members each
    grid arm's slices of those members."""
    if part.members is None:
        return got.keys() == whole.keys() and all(
            _bitwise(torch, got[k], v) if torch.is_tensor(v) else got[k] == v for k, v in whole.items())
    return all((g is None and w is None) or _bitwise(torch, g, w[part.members])
               for arm in exp.arms.values() for g, w in zip(arm.slice_fn(got), arm.slice_fn(whole)))


def _mesh_generation(torch, backend: str, world: int, rank: int) -> dict:
    """Phase mesh's generation-only checks on this rank (``MESH_GEN_RUNS``):
    each experiment at the protocol's size on its mesh, cycle 0's data
    through ``Experiment.generate`` (this rank's part, K1 included, then the
    gather) against the unsharded ``generate_fn`` on the same card: whether
    the gathered cycle is bitwise the unsharded one, the frames K1 renders
    in each (counted at the renderer's frame core and PSF stack), the K1
    launches of one sharded call, and the ms of ``MESH_GEN_REPEATS`` calls
    of each after one of each unmeasured (the device synchronised around
    each)."""
    from moleculardiffusion_mivit_tpu_torch import parallel
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline, denoising, images_features, psfnoise
    from moleculardiffusion_mivit_tpu_torch.sim import render
    from moleculardiffusion_mivit_tpu_torch.train.capture import launch_counts
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    frames = [0]
    core, stack = render.render_frames_core, render.render_psf_stack

    def counted_core(x_hr, *a, **k):
        frames[0] += x_hr.numel() // x_hr.shape[-1]
        return core(x_hr, *a, **k)

    def counted_stack(x_hr, y_hr, intensities, sigmas, *a, **k):
        frames[0] += len(sigmas) * (x_hr.numel() // x_hr.shape[-1])
        return stack(x_hr, y_hr, intensities, sigmas, *a, **k)

    def timed(fn):
        torch.cuda.synchronize()
        frames[0] = 0
        t0 = time.perf_counter()
        data = fn()
        torch.cuda.synchronize()
        return data, (time.perf_counter() - t0) * 1e3, frames[0]

    build_fns = {"baseline": baseline.build,
                 **{name: functools.partial(mod.build, val_d_values=())
                    for name, mod in (("images_features", images_features), ("denoising", denoising),
                                      ("psfnoise", psfnoise))}}
    render.render_frames_core, render.render_psf_stack = counted_core, counted_stack
    out = {}
    try:
        for name, shape in MESH_GEN_RUNS[backend, world]:
            exp = build_fns[name](seed=0, device="cuda").use_mesh(parallel.make_mesh(**shape))
            part, g = exp.generation_part(), seeded_generator("cuda", 1, 0, 0)
            exp.generate(g), exp.generate_fn(g)  # cuFFT plans, the allocator, gloo's buffers
            before = launch_counts()
            got, _, k1_sharded = timed(lambda: exp.generate(g))
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            sharded_ms = [timed(lambda: exp.generate(g))[1] for _ in range(MESH_GEN_REPEATS)]
            whole, _, k1_whole = timed(lambda: exp.generate_fn(g))
            whole_ms = [timed(lambda: exp.generate_fn(g))[1] for _ in range(MESH_GEN_REPEATS)]
            out[name] = {"mesh": shape, "bitwise": _part_is_whole(torch, exp, part, got, whole),
                         "members": None if part.members is None else (part.members.start, part.members.stop),
                         "k1_frames": {"sharded": k1_sharded, "replicated": k1_whole},
                         "launches": launches, "ms": {"sharded": sharded_ms, "replicated": whole_ms},
                         "gathered_mb": sum(v.numel() * v.element_size() for v in got.values()
                                            if torch.is_tensor(v)) / 1e6}
            print(f"mesh rank {rank}: generation {name} {out[name]['ms']}", file=sys.stderr, flush=True)
            del exp, got, whole
            torch.cuda.empty_cache()
    finally:
        render.render_frames_core, render.render_psf_stack = core, stack
    return out


def mesh_rank(torch, backend: str, world: int, rank: int, port: int, out: str) -> None:
    """One rank of phase mesh's parts (b) and (c), started by ``phase_mesh``
    (``chip_smoke.py --mesh-rank``): after ``go`` on stdin, join the world
    over ``backend`` (``gloo``: every rank on card 0; ``nccl``: rank ``r``
    on card ``r``), then for each run of ``MESH_RUNS`` build its
    experiment on its mesh, run its one-step cycle eagerly with the launch
    counters read around it, and write ``_mesh_record`` to
    ``out/rank<r>.pt``. Over gloo a captured cycle must then raise; over
    NCCL two captured cycles follow (a capture and a replay: a captured
    step's gradients live in the graph's pool and are not the first
    step's), and their losses and replicated arms are recorded."""
    from moleculardiffusion_mivit_tpu_torch import parallel
    from moleculardiffusion_mivit_tpu_torch.models import embeddings
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts

    import faulthandler

    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    if sys.stdin.readline().strip() != "go":
        return
    faulthandler.dump_traceback_later(MESH_RANK_TIMEOUT_S - 10, exit=True)  # where a rank hangs, before its kill
    parallel.initialize_distributed(backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                                    timeout_s=MESH_RANK_TIMEOUT_S)
    res, current_rows = {}, embeddings.current_rows
    for key, name, shape in MESH_RUNS[backend, world]:
        mutated = key.endswith("per_rank_bn")
        exp = _mesh_build(name).use_mesh(parallel.make_mesh(**shape))
        exp.build()
        print(f"mesh rank {rank}: {key} built at {time.perf_counter() - T_START:.1f} s", file=sys.stderr, flush=True)
        torch.cuda.synchronize()
        counts0 = launch_counts()
        t0 = time.perf_counter()
        if mutated:
            embeddings.current_rows = lambda: None
        try:
            exp.run(1)
        finally:
            embeddings.current_rows = current_rows
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernel_launches(counts0, [exp.engine])
        print(f"mesh rank {rank}: {key} cycle {seconds:.2f} s", file=sys.stderr, flush=True)
        res[key] = {**_mesh_record(torch, exp, predictions=not mutated), "s_per_cycle": seconds,
                    "launches": launches, "mesh": shape, "all_f32": _all_f32(torch, exp)}
        if not mutated and backend == "gloo":  # a CUDA graph cannot hold gloo's collectives
            exp.fused_cycles = True
            try:
                exp.run(1, start_cycle=1)
                res[key]["gloo_fused_raised"] = False
            except ValueError:
                res[key]["gloo_fused_raised"] = True
        elif not mutated:  # two captured cycles, the collectives in the graphs: a capture, then a replay
            exp.fused_cycles = True
            exp.run(2, start_cycle=1)
            res[key]["captured"] = {
                "losses": _member_losses(exp),
                "replicated": {a: {k: v.cpu() for k, v in st.model.state_dict().items()}
                               for a, st in exp.states.items() if a not in exp._members}}
        del exp
        torch.cuda.empty_cache()
    res["generation"] = _mesh_generation(torch, backend, world, rank)
    torch.save(res, Path(out) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _grad_distance(got: dict, want: dict, grid: bool) -> float:
    """The largest |Δ| of an arm's gradients ``got`` from ``want``, in the
    largest |``want``| (a grid's member by member, each in its own)."""
    if grid:
        return max(_grad_distance({k: g[i] for k, g in got.items()}, {k: w[i] for k, w in want.items()}, False)
                   for i in range(next(iter(want.values())).shape[0]))
    scale = max(float(w.abs().max()) for w in want.values()) or 1.0
    return max(float((got[k] - w).abs().max()) for k, w in want.items()) / scale


def _mesh_against(torch, ranks: list, ref: dict, key: str) -> dict:
    """Every rank's record of run ``key`` against the unsharded ``ref``
    after the one-step cycle: the largest relative |Δ| of the training
    losses, of the gradients (``_grad_distance``; the ResNet arms' apart)
    and of the BatchNorm running statistics (of the tensor's largest), the
    largest |Δ| of the
    parameters, ``val_avg`` and the validation predictions; whether every
    rank's history is the same and the replicated arms are bitwise equal
    on every rank. ``phase_mesh`` holds them."""
    out = {"loss": 0.0, "grad": 0.0, "grad_resnet": 0.0, "buffer": 0.0, "param": 0.0, "val_avg": 0.0, "pred": 0.0,
           "histories_equal": True, "replicated_bitwise": True}
    for res in ranks:
        got = res[key]
        out["histories_equal"] &= got["val_avg"] == ranks[0][key]["val_avg"]
        for model, vals in ref["val_avg"].items():
            for a, b in zip(got["val_avg"][model], vals, strict=True):
                out["val_avg"] = max(out["val_avg"], abs(a - b))
        for model, vals in ref["losses"].items():
            for a, b in zip(got["losses"][model], vals, strict=True):
                out["loss"] = max(out["loss"], abs(a - b) / abs(b))
        for arm, state in got["states"].items():
            grid = arm in got["members"]
            sl = slice(*got["members"][arm]) if grid else slice(None)
            for k, v in state.items():
                w = ref["states"][arm][k]
                w = w[sl] if v.ndim and grid else w
                d = float((v - w).abs().max()) if v.numel() else 0.0
                if k in got["buffers"][arm]:
                    out["buffer"] = max(out["buffer"], d / (float(w.abs().max()) or 1.0))
                else:
                    out["param"] = max(out["param"], d)
                if not grid:
                    out["replicated_bitwise"] &= bool(torch.equal(v, ranks[0][key]["states"][arm][k]))
            which = "grad_resnet" if arm in got["resnet_arms"] else "grad"
            out[which] = max(out[which], _grad_distance(got["grads"][arm],
                                                        {k: w[sl] for k, w in ref["grads"][arm].items()}, grid))
        for arm, p in got["preds"].items():
            out["pred"] = max(out["pred"], float((p - ref["preds"][arm]).abs().max()))
    return out


def _bf16_ratios(ranks: list, ref: dict, key: str) -> dict:
    """The bf16 run's losses and predictions against the unsharded ones,
    the largest |Δ| over its bound (``MESH_BF16_LOSS``, ``MESH_BF16_PRED``):
    at most 1 within it."""
    out = {"loss_of_bound": 0.0, "pred_of_bound": 0.0}
    for res in ranks:
        got = res[key]
        for model, vals in ref["losses"].items():
            for a, b in zip(got["losses"][model], vals, strict=True):
                out["loss_of_bound"] = max(out["loss_of_bound"],
                                           abs(a - b) / (MESH_BF16_LOSS[1] + MESH_BF16_LOSS[0] * abs(b)))
        for arm, p in got["preds"].items():
            q = ref["preds"][arm]
            out["pred_of_bound"] = max(out["pred_of_bound"],
                                       float(((p - q).abs() / (MESH_BF16_PRED[1] + MESH_BF16_PRED[0] * q.abs())).max()))
    return out


def _hold_mesh_runs(torch, part: str, backend: str, ranks: list, refs: dict, launches: dict,
                    apart: dict) -> dict:
    """Part ``part``'s runs (``MESH_RUNS``) held against the unsharded
    ``refs`` by the ``MESH_*`` bounds (``_mesh_against``; the bf16 run by
    ``MESH_BF16_*``, its masters and AdamW state f32 and K2-bf16 launched);
    the mutated run must miss them; captured cycles finite and their
    replicated arms equal on every rank. Adds the unmutated f32 runs'
    launches to ``launches``, the bf16 run's to ``apart``, and returns each
    run's line."""
    by_run = {}
    for key, name, _ in MESH_RUNS[backend, len(ranks)]:
        ref, where = refs[name], f"mesh ({part}) {key}"
        d = _mesh_against(torch, ranks, ref, key)
        if "captured" in ranks[0][key]:
            cap = [r[key]["captured"] for r in ranks]
            check(all(math.isfinite(v) for c in cap for vals in c["losses"].values() for v in vals),
                  f"{where}: a captured cycle's loss is not finite")
            check(all(torch.equal(v, cap[0]["replicated"][a][k]) for c in cap
                      for a, st in c["replicated"].items() for k, v in st.items()),
                  f"{where}: a replicated arm differs between ranks after the captured cycles")
        if key.endswith("per_rank_bn"):
            check(d["loss"] > MESH_LOSS_RTOL and d["grad"] > MESH_GRAD_RTOL,
                  f"{where}: per-rank BatchNorm statistics kept the losses ({d['loss']}) or the gradients "
                  f"({d['grad']}) within their bounds: the checks cannot see them")
        elif key == "bf16_dropout":
            d.update(_bf16_ratios(ranks, ref, key))
            check(d["histories_equal"], f"{where}: the ranks' histories differ")
            check(d["replicated_bitwise"], f"{where}: a replicated arm differs between ranks")
            check(all(r[key]["all_f32"] for r in ranks), f"{where}: a master, AdamW state or buffer is not f32")
            check(all(r[key]["launches"]["deep_resnet_embed_fwd_bf16"] > 0 for r in ranks),
                  f"{where}: a rank launched no K2-bf16")
            check(d["loss_of_bound"] <= 1, f"{where}: losses differ by {d['loss_of_bound']} of their bound")
            check(d["pred_of_bound"] <= 1, f"{where}: predictions differ by {d['pred_of_bound']} of their bound")
            check(d["grad"] <= BF16_GRAD_MAX_TOL, f"{where}: gradients differ by {d['grad']} of their largest")
            check(d["param"] <= MESH_BF16_PARAM_LR * ref["lr"], f"{where}: parameters differ by {d['param']}")
            check(d["buffer"] <= MESH_BUFFER_RTOL, f"{where}: BatchNorm statistics differ by {d['buffer']}")
            for r in ranks:
                for k, v in r[key]["launches"].items():
                    apart[k] = apart.get(k, 0) + v
        else:
            check(d["histories_equal"], f"{where}: the ranks' histories differ")
            check(d["replicated_bitwise"], f"{where}: a replicated arm differs between ranks")
            check(d["loss"] <= MESH_LOSS_RTOL, f"{where}: losses differ by {d['loss']} relative")
            check(d["grad"] <= MESH_GRAD_RTOL, f"{where}: gradients differ by {d['grad']} of their largest")
            check(d["grad_resnet"] <= MESH_GRAD_RTOL_RESNET,
                  f"{where}: a ResNet arm's gradients differ by {d['grad_resnet']} of their largest")
            check(d["param"] <= MESH_LR_ATOL * ref["lr"], f"{where}: parameters differ by {d['param']}")
            check(d["buffer"] <= MESH_BUFFER_RTOL, f"{where}: BatchNorm statistics differ by {d['buffer']}")
            for r in ranks:
                for k, v in r[key]["launches"].items():
                    launches[k] += v
        by_run[key] = {"mesh": ranks[0][key]["mesh"], "batch": ref["batch"], "max_abs_diff": d,
                       "s_per_cycle": {"sharded_by_rank": [r[key]["s_per_cycle"] for r in ranks],
                                       "unsharded": ref["s_per_cycle"]},
                       "launches_by_rank": [{k: v for k, v in r[key]["launches"].items() if v} for r in ranks]}
    return by_run


def _route_b_cost(torch) -> dict:
    """What route (b) repeats: K2 and K3 device ms (``time_ms``, device
    only) on a baseline deep arm's batch of 16 sequences of 30 frames (the
    rows every ``data`` rank runs, gathered) against the 8 and 4 of one
    rank at ``data`` = 2 and 4 (what a kernel on the rank's rows alone,
    route (a), would run). These launches compare, they are not the main
    path's."""
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe

    out = {}
    for b in (16, 8, 4):
        args = _kernel_args(fe, *_embedding_inputs(torch, b, 30, 9, seed=3))
        _, _, saved = fe.deep_resnet_embed_fwd(*args)
        g_emb = torch.ones(b * 30, 64, device="cuda")
        out[f"{b}x30"] = {"rows": b * 30 * 81,
                          "k2_device_ms": time_ms(torch, lambda: fe.deep_resnet_embed_fwd(*args), device_only=True),
                          "k3_device_ms": time_ms(torch, lambda: fe.deep_resnet_embed_bwd(*args, saved, g_emb),
                                                  device_only=True)}
    return out


def _member_count_witness(torch) -> dict:
    """Whether a grid's step depends on how many members it holds: each of
    psfnoise's grid arms (``MESH_SEQS_PER_D``, seed 0, unsharded, in this
    process) takes its first full-batch step once with all 30 members and
    once with members 0-14 alone (``parallel.shard_grid`` as rank 0 of a
    ``model`` = 2 mesh holds them); per arm, whether members 0-14's losses
    and gradients are bitwise equal, and their largest relative |Δ|
    (gradients by ``_grad_distance``). No sum crosses ranks at ``model`` =
    2, so what psfnoise there reads against its unsharded run and this
    reads are the same thing."""
    import types

    from moleculardiffusion_mivit_tpu_torch import parallel
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    exp = _mesh_build("psfnoise")
    exp.build()
    data = exp.generate_fn(seeded_generator(exp.device, 1, 0, 0))
    out = {}
    for arm_name in ("tr_grid", "res_grid"):
        arm, impls, whole = exp.arms[arm_name], exp._impls[arm_name], exp.states[arm_name]
        half = parallel.shard_grid(whole, types.SimpleNamespace(model=2, model_index=0))
        videos, _, labels = arm.slice_fn(data)
        m, n = videos.shape[:2]
        idx = torch.arange(n, device=videos.device).expand(m, n)
        got = {}
        for what, state, size in (("30", whole, m), ("15", half, m // 2)):
            losses = impls.train_step(state, videos[:size], labels[:size], idx[:size])
            got[what] = (losses[:m // 2].cpu(), {k: p.grad[:m // 2].cpu() for k, p in state.model.named_parameters()})
        (l30, g30), (l15, g15) = got["30"], got["15"]
        out[arm_name] = {"bitwise": bool(torch.equal(l30, l15)) and all(torch.equal(g15[k], g) for k, g in g30.items()),
                         "loss": float(((l15 - l30).abs() / l30.abs()).max()),
                         "grad": _grad_distance(g15, g30, grid=True)}
    return out


def _resnet_order_witness(torch) -> dict:
    """Why a ResNet arm's sharded step is held at ``MESH_GRAD_RTOL_RESNET``:
    the baseline's ResNet arm (``MESH_SEQS_PER_D``, seed 0, its initial
    weights, cycle 0's data) takes its first full-batch step here in
    float64 and in f32 with BatchNorm's sums over all 16 × 30 frames at
    once and in two halves (the order of ``data`` = 2); each f32 step's
    largest |Δ| from the float64 one, in its largest gradient
    (``_grad_distance``), and its loss's relative |Δ|."""
    import copy

    from moleculardiffusion_mivit_tpu_torch.models import embeddings
    from moleculardiffusion_mivit_tpu_torch.ops.fused_embedding import f32_convolutions
    from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

    exp = _mesh_build("baseline")
    exp.build()
    videos, _, labels = exp.arms["resnet"].slice_fn(exp.generate_fn(seeded_generator(exp.device, 1, 0, 0)))
    forward = embeddings.BatchNorm.forward

    def summed_in(parts):
        def fwd(self, x):  # the training forward in x's dtype, its sums over ``parts`` blocks of rows
            axes, shape, n = [0, *range(2, x.ndim)], (1, -1) + (1,) * (x.ndim - 2), x.numel() // x.shape[1]
            sums = sum(torch.stack([p.sum(dim=axes), (p * p).sum(dim=axes)]) for p in x.chunk(parts))
            mean = sums[0] / n
            mul = torch.rsqrt(torch.clamp(sums[1] / n - mean * mean, min=0.0) + embeddings.BN_EPS) * self.weight
            return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return fwd

    def step(dtype, parts):
        model = copy.deepcopy(exp.states["resnet"].model).to(dtype)
        embeddings.BatchNorm.forward = summed_in(parts)
        try:
            with f32_convolutions():
                loss = ((model(videos.to(dtype)) - labels.to(dtype)) ** 2).mean()
                loss.backward()
        finally:
            embeddings.BatchNorm.forward = forward
        return float(loss.detach()), {k: p.grad.double() for k, p in model.named_parameters()}

    loss64, grads64 = step(torch.float64, 1)
    out = {}
    for what, parts in (("f32_one_sum", 1), ("f32_two_halves", 2)):
        loss, grads = step(torch.float32, parts)
        out[what] = {"loss": abs(loss / loss64 - 1), "grad": _grad_distance(grads, grads64, grid=False)}
    return out


def mesh_witness(torch, card) -> None:
    """``chip_smoke.py --mesh-witness``: one-off measurements beside phase
    mesh, not part of the smoke: ``_member_count_witness``,
    ``_resnet_order_witness`` and ``_route_b_cost``, each a JSON line."""
    emit({"mesh_witness": "member_count", "card": card, "by_arm": _member_count_witness(torch)})
    emit({"mesh_witness": "resnet_order", "card": card, "from_float64": _resnet_order_witness(torch)})
    torch.cuda.empty_cache()
    emit({"mesh_witness": "route_b_k2_k3", "card": card, "by_rows": _route_b_cost(torch)})


def phase_mesh(torch, card):
    """The mesh (``parallel``, ``Experiment.use_mesh``) on the card, at full
    width and ``MESH_SEQS_PER_D`` sequences a class, every cycle one step.
    (a) NCCL at world size 1: the baseline, two cycles on ``use_mesh(data=1,
    model=1)`` captured and two eager, and two captured without a mesh: all
    three bitwise equal (the world's sums are copies, the collectives
    captured in the graphs); each second cycle timed. (b) Two ranks on this
    one card over gloo (NCCL refuses a card twice), eager, in processes of
    their own: psfnoise with ``model=2`` (each rank's ``tr_grid`` runs K2/K3
    over its 15 members) and the baseline with ``data=2`` (the deep arms'
    K2/K3 on the gathered rows, global BatchNorm), each step held against
    the same step unsharded on the card, run beside the ranks
    (``_mesh_against``, the ``MESH_*`` bounds); the baseline again with
    per-rank BatchNorm statistics, whose gradients must miss their bound;
    a captured cycle over gloo must raise. (c) Where the machine has two or
    more cards: NCCL across up to four, the same comparisons of the first
    (eager) step, then two captured cycles, whose losses must be finite
    and whose replicated arms bitwise equal on every rank. In (b) and (c)
    the ranks then check generation alone (``_mesh_generation``): each
    rank's gathered cycle must be the unsharded one bitwise, and each must
    render (K1) fewer frames than the whole, the ranks that split classes
    all of them between them.
    Returns the K1/K2/K3 launches of every meshed cycle, (a)'s and every
    rank's of the unmutated runs, and of the ranks' sharded generation
    calls."""
    import socket
    import tempfile

    from moleculardiffusion_mivit_tpu_torch import parallel
    from moleculardiffusion_mivit_tpu_torch.train.capture import kernel_launches, launch_counts

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    def start_ranks(backend, world, out):
        """The ranks' processes; each starts CUDA and waits for ``go``."""
        port, procs = str(free_port()), []
        for r in range(world):
            with open(Path(out, f"rank{r}.log"), "w") as log:  # the child keeps its own descriptor
                procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                                               backend, str(world), str(r), port, out], stdin=subprocess.PIPE,
                                              stdout=log, stderr=subprocess.STDOUT, text=True))
        return procs

    def go(procs):
        """``go`` to every rank at once: each waits for the others."""
        for p in procs:
            p.stdin.write("go\n")
            p.stdin.close()

    def finish_ranks(procs, what, out):
        """Wait for every rank; past ``MESH_RANK_TIMEOUT_S`` kill them all
        and fail."""
        t_end = time.perf_counter() + MESH_RANK_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(t_end - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
        logs = [Path(out, f"rank{r}.log").read_text() for r in range(len(procs))]
        if not all(p.returncode == 0 for p in procs):
            for r, log in enumerate(logs):
                print(f"--- mesh {what} rank {r}\n{log[-6000:]}", file=sys.stderr)
            fail(f"mesh {what}: ranks exited {[p.returncode for p in procs]} (a kill past {MESH_RANK_TIMEOUT_S} s "
                 "is -9)")

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    multi = 4 if n_cards >= 4 else 2 if n_cards >= 2 else 0
    tmp = tempfile.TemporaryDirectory()
    out_b = Path(tmp.name, "b")
    out_b.mkdir()
    procs_b = start_ranks("gloo", 2, str(out_b))  # they start CUDA while part (a) runs
    launches = {k: 0 for k in launch_counts()}

    # (a) NCCL at world size 1
    parallel.initialize_distributed("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0,
                                    timeout_s=MESH_RANK_TIMEOUT_S)
    mesh1 = parallel.make_mesh(data=1, model=1)
    runs = {}
    for key, fused, meshed in (("captured", True, True), ("eager", False, True), ("unmeshed", True, False)):
        exp = _mesh_build("baseline", fused=fused)
        if meshed:
            exp.use_mesh(mesh1)
        exp.build()
        torch.cuda.synchronize()
        counts0 = launch_counts()
        exp.run(1)  # the capture cycle
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run(1, start_cycle=1)
        torch.cuda.synchronize()
        runs[key] = [exp, time.perf_counter() - t0]
        if meshed:
            for k, v in kernel_launches(counts0, [exp.engine]).items():
                launches[k] += v
    torch.distributed.destroy_process_group()
    cap = runs["captured"][0]
    a = {other: _compare_experiments(torch, cap, runs[other][0]) for other in ("eager", "unmeshed")}
    for other, diffs in a.items():
        for model, d in diffs.items():
            check(d["bitwise"], f"mesh (a): {model}: captured on the mesh and {other} differ ({d})")
    emit({"phase": "mesh", "part": "a", "card": card, "backend": "nccl", "world": 1, "batch": _sequences(cap),
          "sequences": _sequences(cap), "cycles": 2, "bitwise_equal": True,
          "s_second_cycle": {k: v[1] for k, v in runs.items()}})
    del runs, cap

    # (b) two ranks on this card over gloo, and beside them on the card the
    # unsharded references (their seconds shared the card with the ranks)
    t0 = time.perf_counter()
    go(procs_b)
    refs = {}
    for name in ("psfnoise", "baseline", "bf16_dropout"):
        exp = _mesh_build(name)
        exp.build()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        exp.run(1)
        torch.cuda.synchronize()
        refs[name] = {**_mesh_record(torch, exp), "s_per_cycle": time.perf_counter() - t1,
                      "lr": exp.train_cfg.lr_for_cycle(0), "batch": _sequences(exp)}
        del exp
    torch.cuda.empty_cache()
    finish_ranks(procs_b, "(b)", out_b)
    ranks = [torch.load(out_b / f"rank{r}.pt", weights_only=False) for r in range(2)]
    parts = {"b": ("gloo", 2, ranks, time.perf_counter() - t0)}
    for res in ranks:
        for key, got in res.items():
            check(got.get("gloo_fused_raised", True), f"mesh (b): a captured {key} cycle over gloo did not raise")
    psf = [res["psfnoise"] for res in ranks]
    check([r["members"]["tr_grid"] for r in psf] == [(0, 15), (15, 30)], "mesh (b): psfnoise members")
    for r in psf:
        check(r["launches"]["deep_resnet_embed_fwd"] > 0, "mesh (b): no K2 launch on a psfnoise rank")

    # (c) NCCL across cards
    if multi:
        out_c = Path(tmp.name, "c")
        out_c.mkdir()
        t0 = time.perf_counter()
        procs = start_ranks("nccl", multi, str(out_c))
        go(procs)
        finish_ranks(procs, "(c)", out_c)
        parts["c"] = ("nccl", multi, [torch.load(out_c / f"rank{r}.pt", weights_only=False)
                                      for r in range(multi)], time.perf_counter() - t0)
    else:
        emit({"phase": "mesh", "part": "c", "skipped": f"{n_cards} card: NCCL across cards needs two or more"})

    apart = {k: 0 for k in launches}
    for part, (backend, world, ranks, wall_s) in parts.items():
        by_run = _hold_mesh_runs(torch, part, backend, ranks, refs, launches, apart)
        emit({"phase": "mesh", "part": part, "card": card, "backend": backend, "world": world,
              "sequences_per_d": MESH_SEQS_PER_D, "by_run": by_run, "ranks_wall_s": wall_s,
              "note": "two ranks and the unsharded references share one card over gloo: correctness, not speed"
              if backend == "gloo" else "eager first steps; the unsharded references' seconds beside part (b)'s ranks"})
        gen = {}
        for name, shape in MESH_GEN_RUNS[backend, world]:
            by_rank = [r["generation"][name] for r in ranks]
            check(all(g["bitwise"] for g in by_rank),
                  f"mesh ({part}) generation {name} {shape}: a rank's gathered cycle is not the unsharded one")
            whole = by_rank[0]["k1_frames"]["replicated"]
            split = [g["k1_frames"]["sharded"] for g in by_rank]
            # classes split over the ranks: their frames add up to the whole;
            # a grid's members: each rank renders its members' PSF settings
            check(all(0 < f < whole for f in split) and (by_rank[0]["members"] is not None or sum(split) == whole),
                  f"mesh ({part}) generation {name}: K1 frames by rank {split} against {whole} replicated")
            for g in by_rank:
                for k, v in g["launches"].items():
                    launches[k] += v
            gen[name] = {"mesh": shape, "bitwise_equal": True, "members_by_rank": [g["members"] for g in by_rank],
                         "k1_frames_by_rank": [g["k1_frames"]["sharded"] for g in by_rank],
                         "k1_frames_replicated": by_rank[0]["k1_frames"]["replicated"],
                         "k1_launches_by_rank": [g["launches"]["render_frames"] for g in by_rank],
                         "ms_by_rank": [g["ms"] for g in by_rank], "gathered_mb": by_rank[0]["gathered_mb"]}
        emit({"phase": "mesh", "part": f"{part}_generation", "card": card, "backend": backend, "world": world,
              "sequences_per_d": 64, "by_experiment": gen,
              "note": "ms: each rank's Experiment.generate (its part, then the gather) against the unsharded "
                      "generate_fn on the same card, median of the list" + (
                          "; two gloo ranks share one card: correctness, not speed" if backend == "gloo" else "")})
    tmp.cleanup()
    emit({"phase": "mesh", "part": "launches", "launches": launches, "bf16_dropout_launches": apart,
          "phase_s": time.perf_counter() - t_phase})
    return launches, {"mesh_bf16_dropout": apart}


# The main paths, each driven by its phase, in groups that each run in a
# process of their own: in one long process torch.profiler came to lose
# single K1 records (one of 36 in a framerate cycle, one of 5 in a modular
# generation call) once several phases had profiled before it, never in a
# fresh process. The first group ran in one process in every earlier smoke.
PATHS = {"slice": phase_slice, "experiment": phase_experiment, "images_features": phase_images_features,
         "modular": phase_modular, "embeddings": phase_embeddings, "framerate": phase_framerate,
         "psfnoise": phase_psfnoise, "denoising": phase_denoising, "realdata": phase_realdata, "bf16": phase_bf16,
         "constrained": phase_constrained, "changepoint": phase_changepoint, "sim2real": phase_sim2real,
         "changepoint_study": phase_changepoint_study, "ensemble": phase_ensemble, "rescore": phase_rescore,
         "serving": phase_serving, "mesh": phase_mesh, "dropout": phase_dropout}
PATH_GROUPS = (("slice", "experiment", "images_features"), ("modular",), ("embeddings",), ("framerate",),
               ("psfnoise",), ("denoising", "dropout"),
               ("realdata", "constrained", "changepoint", "sim2real", "changepoint_study", "ensemble", "rescore"),
               ("bf16", "serving"), ("mesh",))
GROUP_TIMEOUT_S = 600


def start_paths(names) -> subprocess.Popen:
    """Start this script in a fresh process for the paths ``names`` (the
    kernels are built already). It starts CUDA and imports the package at
    once, while the group before it runs, then waits for ``go`` on its
    stdin; it exits if its stdin closes first."""
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--paths", "--on-go", *names],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)


def run_paths(proc, names) -> dict:
    """Let a started group run its paths; pass its lines on and return each
    path's launches and seconds."""
    try:
        stdout, _ = proc.communicate("go\n", timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"paths {names} ran past {GROUP_TIMEOUT_S} s")
    lines = stdout.splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    check(proc.returncode == 0 and bool(lines), f"paths {names} failed (exit code {proc.returncode})")
    return json.loads(lines[-1])["paths"]


def main() -> None:
    global T_START
    if not (ROOT / PKG / "__init__.py").is_file():
        fail(f"the {PKG} package is not beside this script")
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from moleculardiffusion_mivit_tpu_torch.ops._build import build_all, load_library
    from moleculardiffusion_mivit_tpu_torch.utils.card import card_line

    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase mesh, started by it
        backend, world, rank, port, out = sys.argv[2:7]
        mesh_rank(torch, backend, int(world), int(rank), int(port), out)
        return
    if sys.argv[1:2] == ["--paths"]:  # a group of paths: alone, or in a process start_paths started
        on_go = sys.argv[2:3] == ["--on-go"]
        card, out = card_line(torch.device("cuda")), {}
        torch.empty(1, device="cuda")  # the CUDA context
        from moleculardiffusion_mivit_tpu_torch import run_experiment  # noqa: F401  (most of the package)

        if on_go and sys.stdin.readline().strip() != "go":
            return  # the smoke stopped before this group's turn
        T_START = time.perf_counter()
        for name in sys.argv[3 if on_go else 2:]:
            t = time.perf_counter()
            got = PATHS[name](torch, card)
            launches, apart = got if isinstance(got, tuple) else (got, {})  # a phase's other runs, listed apart
            out[name] = {"launches": launches, "seconds": time.perf_counter() - t}
            out.update({path: {"launches": v, "seconds": None} for path, v in apart.items()})
        emit({"paths": out})
        return

    card = card_line(torch.device("cuda"))
    t0 = time.perf_counter()
    reports = build_all()
    for lib in ("render", "fused_embedding"):
        load_library(lib)
    build_s = time.perf_counter() - t0
    if sys.argv[1:2] == ["--mesh-witness"]:  # one-off measurements beside phase mesh
        mesh_witness(torch, card)
        return
    for stem, text in reports.items():
        print(f"--- nvcc {stem}.cu\n{text}", file=sys.stderr)
    emit({"phase": "device", "card": card, "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda, "build_s": build_s})

    phase_s = {"build": build_s}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    k1 = timed("k1", phase_k1, torch)
    k2, k3 = timed("k2_k3", phase_k2_k3, torch)
    k2_bf16, k3_bf16 = timed("bf16_kernels", _bf16_kernels, torch)
    # the groups' processes get the card's memory: this one keeps no cache
    # (phase serving's graphs at batch 4096 hold ~33-39 GB)
    torch.cuda.empty_cache()
    main_reserved_gb = torch.cuda.memory_reserved() / 1e9
    by_path = {}
    proc = start_paths(PATH_GROUPS[0])
    for i, group in enumerate(PATH_GROUPS):
        # the next group's process starts up while this one runs
        following = start_paths(PATH_GROUPS[i + 1]) if i + 1 < len(PATH_GROUPS) else None
        t = time.perf_counter()
        for name, got in run_paths(proc, group).items():
            by_path[name] = got["launches"]
            if got["seconds"] is not None:
                phase_s[name] = got["seconds"]
        phase_s["+".join(group) + " process"] = time.perf_counter() - t
        proc = following
    names = {k for path in by_path.values() for k in path}
    launches = {k: sum(path.get(k, 0) for path in by_path.values()) for k in names}

    src = f"{PKG}/csrc"
    kernels = [
        dict(name="render_frames", route="cuda", source=f"{src}/render.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/pallas_render.py:240",
             launches=launches["render_frames"],
             launches_by_path={p: v["render_frames"] for p, v in by_path.items()}, library_ms=None, **k1),
        dict(name="deep_resnet_embed_fwd", route="cuda", source=f"{src}/fused_embedding.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/fused_embedding.py:350",
             launches=launches["deep_resnet_embed_fwd"],
             launches_by_path={p: v["deep_resnet_embed_fwd"] for p, v in by_path.items()}, library_ms=None, **k2),
        dict(name="deep_resnet_embed_bwd", route="cuda", source=f"{src}/fused_embedding.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/fused_embedding.py:373",
             launches=launches["deep_resnet_embed_bwd"],
             launches_by_path={p: v["deep_resnet_embed_bwd"] for p, v in by_path.items()}, library_ms=None, **k3),
        dict(name="deep_resnet_embed_fwd_bf16", route="cuda", source=f"{src}/fused_embedding.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/fused_embedding.py:350",
             launches=launches["deep_resnet_embed_fwd_bf16"],
             launches_by_path={p: v.get("deep_resnet_embed_fwd_bf16", 0) for p, v in by_path.items()},
             library_ms=None, **k2_bf16),
        dict(name="deep_resnet_embed_bwd_bf16", route="cuda", source=f"{src}/fused_embedding.cu",
             replaces="moleculardiffusion_mivit_tpu/ops/fused_embedding.py:373",
             launches=launches["deep_resnet_embed_bwd_bf16"],
             launches_by_path={p: v.get("deep_resnet_embed_bwd_bf16", 0) for p, v in by_path.items()},
             library_ms=None, **k3_bf16),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on the main path")
        # "bytes" or "operations"; which operations were counted goes beside it
        what, _, detail = k["bound_by"].partition(" ")
        k["bound_by"] = what
        if detail:
            k["bound_operations"] = detail.strip("()")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start, "by_phase_s": phase_s,
          "main_reserved_gb": main_reserved_gb})
    print(card_line(torch.device("cuda")), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
