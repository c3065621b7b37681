"""Simulator validation: the six checks of ``examples/simulator_validation.py``
with numbers instead of plots.

1. the label layout of ``single_state``: (alpha, D, state) a step;
2. MSD loop closure: D re-estimated from the generated trajectories against
   the true D = 5;
3. coarse sampling: frame-averaged trajectories (10 sub-positions)
   underestimate D;
4. localisation noise (σ = 3 trajectory units) biases the recovered D up;
5. renderer geometry: a 200 nm jump moves the peak 2 px at 100 nm a pixel
   and 1 px at 200 nm;
6. SNR: peak-to-background contrast across background σ of 50, 150, 290 and
   500.

The example's keys 0-4 are the streams ``seeded_generator(device, k)`` here
(a torch draw: checks 2-4 and 6 equal JAX's in distribution only; checks 1
and 5 do not depend on the draw).

Run: python -m moleculardiffusion_mivit_tpu_torch.sim.simulator_validation
     [--out results/torch_simulator_validation] [--device cuda|cpu]

It prints the example's lines and writes ``<out>/simulator_validation.json``:
each check's numbers, unrounded, with the standard error (sd / sqrt(n),
``ddof=1``) of the per-particle D estimates of checks 2-4, the seconds and the
card.

The outcome rule V1, written before the runs on the card;
``rescore_outcome.py`` applies it to the committed report against JAX's
(``results/simulator_validation/jax_report.json``, the example's checks run
under JAX on the CPU by the command in ``tests/test_torch_rescore.py``):

- checks 1 and 5 equal JAX's exactly (the label layout; the 2:1 pixel
  shift);
- checks 2-4: each mean D lies within 3·sqrt(se_P² + se_J²) of JAX's;
- check 6: the contrast falls as the background σ rises, and each of the
  four contrasts lies within 5 % of JAX's.
- A miss is logged as F8 or later in ROADMAP.md section 3, with its test.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS
from moleculardiffusion_mivit_tpu_torch.features import estimate_d_from_msds, mean_square_displacements
from moleculardiffusion_mivit_tpu_torch.sim.render import trajectories_to_video
from moleculardiffusion_mivit_tpu_torch.sim.trajectory import average_trajectories_frames, single_state
from moleculardiffusion_mivit_tpu_torch.utils.card import card_line
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

BG_SIGMAS = (50.0, 150.0, 290.0, 500.0)


def _d_summary(d: torch.Tensor) -> dict:
    """Mean and standard error (``ddof=1``) of per-particle D estimates."""
    d = d.double().cpu().numpy()
    return {"mean": float(d.mean()), "se": float(d.std(ddof=1) / np.sqrt(d.size)), "n": int(d.size)}


def label_layout(labels: torch.Tensor) -> dict:
    """What check 1 compares: the labels' shape, the values of the alpha and
    state columns, and whether D is constant along each trajectory."""
    lab = labels.cpu().numpy()
    return {"shape": list(lab.shape), "alpha_values": sorted({float(v) for v in lab[..., 0].ravel()}),
            "state_values": sorted({float(v) for v in lab[..., 2].ravel()}),
            "d_constant_in_time": bool((lab[..., 1] == lab[:, :1, 1]).all())}


def peak_columns(videos: torch.Tensor) -> list:
    """The column of each frame's maximum, for the first sequence."""
    frames = videos[0].cpu().numpy()
    return [int(np.unravel_index(f.argmax(), f.shape)[1]) for f in frames]


def checks(device) -> dict:
    """The six checks' numbers, unrounded. The example's key ``k`` is the
    stream ``(k)`` on ``device``, drawn afresh wherever the example reuses
    the key."""
    def key(k: int) -> torch.Generator:
        return seeded_generator(device, k)

    out = {}
    # 1. label format
    _, labels = single_state(key(0), 5, 50, Ds=(3.0, 1.0), alphas=1)
    out["labels_first_3"] = labels[:3, 0].cpu().tolist()
    out["check1_label_layout"] = label_layout(labels)

    # 2. loop closure
    trajs, _ = single_state(key(0), 500, 300, Ds=(5.0, 0.0))
    t300 = torch.arange(300, dtype=torch.float32, device=device)
    out["check2_loop_closure"] = _d_summary(estimate_d_from_msds(mean_square_displacements(trajs), t300))

    # 3. coarse sampling
    avg = average_trajectories_frames(trajs, 10)
    t30 = 10 * torch.arange(30, dtype=torch.float32, device=device)
    out["check3_coarse_sampling"] = _d_summary(estimate_d_from_msds(mean_square_displacements(avg), t30))

    # 4. localisation noise
    noisy = avg + 3.0 * torch.randn(avg.shape, generator=key(1), device=device)
    out["check4_localization_noise"] = _d_summary(estimate_d_from_msds(mean_square_displacements(noisy), t30))

    # 5. resolution scaling: a 200 nm jump
    step = torch.zeros((1, 20, 2), device=device)
    step[:, 10:, 0] = 200.0
    optics_100 = BASELINE_OPTICS.replace(trajectory_unit=1.0, background_intensity=(0.0, 0.0), poisson_noise=-1.0)
    optics_200 = optics_100.replace(resolution=200e-9)
    c100 = peak_columns(trajectories_to_video(key(2), step, 10, False, optics_100))
    c200 = peak_columns(trajectories_to_video(key(2), step, 10, False, optics_200))
    out["check5_pixel_shift"] = {"at_100nm": c100[1] - c100[0], "at_200nm": c200[1] - c200[0]}

    # 6. SNR sweep
    snr = []
    for bg_std in BG_SIGMAS:
        optics = BASELINE_OPTICS.replace(background_intensity=(1420.0, bg_std))
        trajs, _ = single_state(key(3), 32, 300, Ds=(3.0, 0.0))
        vids = trajectories_to_video(key(4), trajs / 100, 10, True, optics).cpu().numpy()
        peak, bg = float(vids.max(axis=(2, 3)).mean()), float(np.median(vids))
        snr.append({"bg_sigma": bg_std, "peak": peak, "bg": bg, "contrast": (peak - bg) / bg_std})
    out["check6_snr"] = snr
    return out


def main(argv=None) -> dict:
    """Run the checks, print the example's lines; returns the written
    report."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_simulator_validation")
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    c = checks(dev)
    print("labels (alpha, D, state) of first 3 particles:")
    print(np.asarray(c["labels_first_3"], dtype=np.float32))
    print(f"\nloop closure: true D=5.0, MSD-estimated D={c['check2_loop_closure']['mean']:.3f}")
    print(f"coarse sampling (10 sub-positions averaged): D={c['check3_coarse_sampling']['mean']:.3f} "
          "(exposure averaging biases D down)")
    print(f"+ localization noise sigma=0.5: D={c['check4_localization_noise']['mean']:.3f} (biased up)")
    shift = c["check5_pixel_shift"]
    print(f"\nresolution scaling: 200nm jump moves peak by {shift['at_100nm']} px at "
          f"100nm/px, {shift['at_200nm']} px at 200nm/px")
    print("\nSNR sweep (peak-to-background contrast):")
    for row in c["check6_snr"]:
        print(f"  bg sigma {row['bg_sigma']:5.0f}: peak {row['peak']:7.0f}, bg {row['bg']:7.0f}, "
              f"contrast {row['contrast']:5.1f}σ")
    report = {**c, "seconds": time.perf_counter() - t0, "card": card_line(dev)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "simulator_validation.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
