"""Frozen validation sets.

Port of the main-path part of
``moleculardiffusion_mivit_tpu/evaluation/validation.py``: generate a
validation suite from a seed (equal to the JAX one in distribution, not in
bits: the random streams differ), load the reference's frozen assets when a
directory holds them, and render them the way the experiments do.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.sim import (
    normalize_images,
    single_state,
    trajectories_to_video,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator

# Directory of the reference's frozen trajectory assets
# (<dir>/<length>/val{1,3,5,7,9}.npy, <dir>/valTrajsInOrder.npy), if any.
REFERENCE_VAL_DIR = os.environ.get("MIVIT_REFERENCE_VAL_DIR")
IN_ORDER_D_VALUES = np.round(np.arange(0.1, 7.01, 0.1), 10)


def generate_frozen_validation(
    seed: int = 2025,
    d_values: Sequence[float] = (1, 3, 5, 7, 9),
    n_particles: int = 50,
    t_steps: int = 300,
    in_order_particles: int = 10,
    device=None,
) -> Dict[str, np.ndarray]:
    """A validation suite from ``seed``: one ``(N, T, 2)`` trajectory array
    per D at fixed D, plus an in-order grid ``(70, P, T, 2)`` over
    D = 0.1..7.0, in trajectory units before the ``traj_div_factor``
    scaling. Simulated on ``device`` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    out: Dict[str, np.ndarray] = {}
    for i, d in enumerate(d_values):
        trajs, _ = single_state(seeded_generator(dev, seed, i), n_particles, t_steps, Ds=(float(d), 0.0))
        out[f"val{d:g}"] = trajs.double().cpu().numpy()
    grid = []
    for j, d in enumerate(IN_ORDER_D_VALUES):
        trajs, _ = single_state(
            seeded_generator(dev, seed, 1000 + j), in_order_particles, t_steps, Ds=(float(d), 0.0)
        )
        grid.append(trajs.double().cpu().numpy())
    out["valTrajsInOrder"] = np.stack(grid)
    return out


def load_reference_validation(length: int = 30, base_dir: Optional[str] = None) -> Optional[Dict[str, np.ndarray]]:
    """The reference's frozen assets from ``base_dir`` (default
    ``REFERENCE_VAL_DIR``) in ``generate_frozen_validation``'s layout, or
    None when absent."""
    base_dir = base_dir or REFERENCE_VAL_DIR
    if not base_dir:
        return None
    subdir = os.path.join(base_dir, str(length))
    if not os.path.isdir(subdir):
        return None
    out: Dict[str, np.ndarray] = {}
    for d in (1, 3, 5, 7, 9):
        path = os.path.join(subdir, f"val{d}.npy")
        if os.path.exists(path):
            out[f"val{d}"] = np.load(path)
    in_order = os.path.join(base_dir, "valTrajsInOrder.npy")
    if os.path.exists(in_order):
        out["valTrajsInOrder"] = np.load(in_order)
    return out or None


def load_validation_trajectories(length: int = 30, seed: int = 2025, device=None):
    """Reference assets when available, otherwise the generated set."""
    ref = load_reference_validation(length)
    if ref is not None:
        return ref
    return generate_frozen_validation(seed=seed, t_steps=length * 10, device=device)


def render_validation_videos(
    trajectories: Dict[str, np.ndarray],
    train_cfg: TrainConfig,
    optics: OpticsConfig,
    seed: int = 7,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Render frozen trajectories as the experiments do: divide by
    ``traj_div_factor``, render with centering, normalise against
    ``(bg_mean, bg_sigma, part_mean + bg_mean)``. The in-order grid's
    (D, P) axes are flattened for rendering and restored after."""
    dev = resolve_device(device)
    bg_mean, bg_sigma = optics.background_intensity
    part_mean = optics.particle_intensity[0]
    out: Dict[str, torch.Tensor] = {}
    for i, (name, trajs) in enumerate(sorted(trajectories.items())):
        g = seeded_generator(dev, seed, i)
        trajs = torch.as_tensor(np.asarray(trajs), dtype=torch.float32, device=dev) / train_cfg.traj_div_factor
        lead = trajs.shape[:-2]
        flat = trajs.reshape((-1,) + trajs.shape[-2:])
        vids = trajectories_to_video(g, flat, train_cfg.n_pos_per_frame, train_cfg.center, optics)
        vids, _ = normalize_images(vids, bg_mean, bg_sigma, part_mean + bg_mean)
        out[name] = vids.reshape(lead + vids.shape[1:])
    return out
