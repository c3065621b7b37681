"""Poster illustration gallery: example trajectories, rendered frames and
frame strips, regenerated from the port's simulator.

Port of ``examples/poster_gallery.py`` (the renders of the reference's
``outPoster/posterImages.ipynb`` and ``outPoster/VideosIABM.ipynb``), with
the same PNG names:

1. ``traj_D{d}_f{n}.png``: one particle's trajectory at D = d, coloured by
   frame, over its first n = 5, 10, 20 and 30 frames;
2. ``frame_D{d}_{nonoise_hr,nonoise,noisy,normalized}.png``: the middle
   frame of that trajectory under the four variants of the multi-noise
   renderer (``sim.trajectories_to_video_multiple_settings``: noise-free,
   with background, with shot noise, filtered);
3. ``strip_D{d}.png``: six frames of the trajectory's normalised training
   render.

For D in 1, 3, 5, 7 and 10, from the streams of the example's key layout:
``fold_in((seed), d)`` simulates, ``fold_in(.., 1)`` and ``fold_in(.., 2)``
render (a torch draw: the pictures equal JAX's in distribution only).
matplotlib is imported inside ``main`` alone, and ``main`` raises naming it
where it does not import (the card machine has none): run the gallery with
``--device cpu``.

Run: python -m moleculardiffusion_mivit_tpu_torch.evaluation.poster_gallery
     [--out results/torch_poster_gallery] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
from moleculardiffusion_mivit_tpu_torch.sim import single_state
from moleculardiffusion_mivit_tpu_torch.sim.render import (
    normalize_images,
    trajectories_to_video,
    trajectories_to_video_multiple_settings,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

D_VALUES = (1, 3, 5, 7, 10)
VARIANTS = ("nonoise_hr", "nonoise", "noisy", "normalized")
SUB_LENGTHS = (5, 10, 20, 30)


def gallery(seed: int, device) -> Dict[int, dict]:
    """For each D: the trajectory ``(T, 2)``, the four renderer variants of
    it ``(F, S, S)`` and its normalised render ``(F, S, S)``, as numpy."""
    cfg, optics = TrainConfig(), BASELINE_OPTICS
    p, f = cfg.n_pos_per_frame, cfg.n_frames
    key = seeded_generator(device, seed)
    out = {}
    for d in D_VALUES:
        kd = fold_in(key, d)
        trajs, _ = single_state(kd, 1, f * p, Ds=(float(d), 0.0))
        scaled = trajs / cfg.traj_div_factor
        variants = trajectories_to_video_multiple_settings(fold_in(kd, 1), scaled, p, True, optics)
        vid = trajectories_to_video(fold_in(kd, 2), scaled, p, True, optics)
        vid, _ = normalize_images(vid, optics.background_intensity[0], optics.background_intensity[1],
                                  optics.particle_intensity[0] + optics.background_intensity[0])
        out[d] = {"traj": trajs[0].cpu().numpy(), "variants": [v[0].cpu().numpy() for v in variants],
                  "frames": vid[0].cpu().numpy()}
    return out


def plot_one_particle_trajectory(plt, traj, n_frames, path, max_scale=None):
    """Frame-coloured single-particle path (VideosIABM.ipynb
    ``plot1ParticleTrajectory``): each frame's sub-positions share a colour
    from a continuous map, so the diffusion speed reads as colour spread."""
    per = traj.shape[0] // n_frames
    cmap = plt.get_cmap("viridis")
    fig, ax = plt.subplots(figsize=(4, 4))
    for i in range(n_frames):
        seg = traj[i * per: (i + 1) * per + 1]
        ax.plot(seg[:, 0], seg[:, 1], color=cmap(i / max(n_frames - 1, 1)), lw=1.2)
    ax.set_aspect("equal")
    if max_scale:
        ax.set_xlim(-max_scale, max_scale)
        ax.set_ylim(-max_scale, max_scale)
    ax.axis("off")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def save_frame(plt, img, path, vmin=None, vmax=None):
    fig = plt.figure(figsize=(3, 3))
    plt.imshow(np.asarray(img), cmap="gray", vmin=vmin, vmax=vmax)
    plt.axis("off")
    fig.savefig(path, dpi=150, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def main(argv=None) -> list:
    """Draw the gallery; returns the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="results/torch_poster_gallery")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from moleculardiffusion_mivit_tpu_torch.evaluation.plots import require_matplotlib

    plt = require_matplotlib()
    os.makedirs(args.out, exist_ok=True)
    p, f = TrainConfig().n_pos_per_frame, TrainConfig().n_frames
    written = []
    for d, g in gallery(args.seed, dev).items():
        for sub in SUB_LENGTHS:
            path = os.path.join(args.out, f"traj_D{d}_f{sub}.png")
            plot_one_particle_trajectory(plt, g["traj"][: sub * p], sub, path)
            written.append(path)
        vmax = float(np.max(g["variants"][2]))  # over the shown sequence, the only one rendered
        for name, vid in zip(VARIANTS, g["variants"]):
            path = os.path.join(args.out, f"frame_D{d}_{name}.png")
            scaled = name != "normalized"
            save_frame(plt, vid[f // 2], path, vmin=0.0 if scaled else None, vmax=vmax if scaled else None)
            written.append(path)
        fig, axes = plt.subplots(1, 6, figsize=(12, 2.2))
        for ax, i in zip(axes, np.linspace(0, f - 1, 6).astype(int)):
            ax.imshow(g["frames"][i], cmap="gray")
            ax.set_title(f"frame {i}", fontsize=8)
            ax.axis("off")
        fig.suptitle(f"D = {d}", fontsize=10)
        path = os.path.join(args.out, f"strip_D{d}.png")
        fig.savefig(path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    print(f"{len(written)} figures -> {args.out}")
    return written


if __name__ == "__main__":
    main()
