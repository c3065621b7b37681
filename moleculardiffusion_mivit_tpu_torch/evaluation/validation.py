"""Frozen validation sets.

Port of the main-path part of
``moleculardiffusion_mivit_tpu/evaluation/validation.py``: generate a
validation suite from a seed (equal to the JAX one in distribution, not in
bits: the random streams differ), load the reference's frozen assets when a
directory holds them, render them the way the experiments do, return the
published 100-value in-order suite (the JAX package's own array, shipped in
``data/``), build in-order sweeps, and score them as the poster notebooks do
(``error_table``, numpy only).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.sim import (
    render_videos,
    single_state,
)
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

# Directory of the reference's frozen trajectory assets
# (<dir>/<length>/val{1,3,5,7,9}.npy, <dir>/valTrajsInOrder.npy), if any.
REFERENCE_VAL_DIR = os.environ.get("MIVIT_REFERENCE_VAL_DIR")
IN_ORDER_D_VALUES = np.round(np.arange(0.1, 7.01, 0.1), 10)
# The Framerate and ImagesFeatures scripts score on a 100-value grid
# (D = 0.1..10.0); the asset they load is absent from the reference's
# snapshot, so the JAX package generates a deterministic equivalent from
# seed 2026, the suite its published scores were taken on.
IN_ORDER_IMFT_D_VALUES = np.round(np.arange(0.1, 10.01, 0.1), 10)
# That suite exactly: the JAX package's ``generate_in_order_imft()`` at its
# defaults, and its 200-step (20-frame) variant ``t_steps=200``, which is a
# draw of its own and not the first 200 steps of the other; each stored as
# float32 (lossless: every value is an f32 cast).
IN_ORDER_IMFT_PATHS = {
    300: Path(__file__).resolve().parents[1] / "data" / "in_order_imft_seed2026.npy",
    200: Path(__file__).resolve().parents[1] / "data" / "in_order_imft_seed2026_t200.npy",
}


def generate_in_order_imft(seed: int = 2026, t_steps: int = 300, n_particles: int = 10) -> np.ndarray:
    """The published in-order suite: trajectories ``(100, 10, t_steps, 2)``
    in float64 over D = 0.1..10.0 in steps of 0.1, fixed D per slice, in
    trajectory units before the ``traj_div_factor`` scaling. These are the
    JAX package's values bit for bit (``IN_ORDER_IMFT_PATHS``); a torch draw
    would put the scores off the published protocol. Only seed 2026 with 10
    particles at 300 or 200 steps is shipped, so any other ``seed``,
    ``t_steps`` or ``n_particles`` raises."""
    if (seed, n_particles) != (2026, 10) or t_steps not in IN_ORDER_IMFT_PATHS:
        raise ValueError(
            f"only the published in-order suites (seed 2026, t_steps 300 or 200, n_particles 10) are shipped; "
            f"got seed {seed}, t_steps {t_steps}, n_particles {n_particles}"
        )
    return np.load(IN_ORDER_IMFT_PATHS[t_steps]).astype(np.float64)


def build_in_order_data(
    arr,
    d_values,
    generator: torch.Generator,
    train_cfg: TrainConfig,
    optics: OpticsConfig,
    make_dataset: Callable[..., Dict[str, Any]],
) -> Dict[str, Any]:
    """An experiment's ``in_order_data`` from a trajectory grid ``(n_d,
    n_particles, T, 2)`` (trajectory units): the grid flattened, divided by
    ``traj_div_factor`` and put through the experiment's
    ``make_dataset(generator, trajs, train_cfg, optics)`` with the stream
    ``fold_in(generator, 777)`` (the generator's device is the data's), with
    ``labels = None``, ``d_values`` and a ``re_render(generator)`` hook that
    renders the same trajectories under a fresh draw (multi-render scoring,
    ``Experiment.in_order_error_tables(n_renders=K)``)."""
    n_d, n_particles = arr.shape[:2]
    flat = torch.as_tensor(np.asarray(arr), dtype=torch.float32, device=generator.device)
    flat = flat.reshape(n_d * n_particles, arr.shape[2], 2) / train_cfg.traj_div_factor
    data = make_dataset(fold_in(generator, 777), flat, train_cfg, optics)
    data["labels"] = None
    data["d_values"] = np.asarray(d_values)[:n_d]

    def re_render(render_generator: torch.Generator) -> Dict[str, Any]:
        d2 = make_dataset(render_generator, flat, train_cfg, optics)
        d2["labels"] = None
        d2["d_values"] = data["d_values"]
        return d2

    data["re_render"] = re_render
    return data


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
    out: Dict[str, torch.Tensor] = {}
    for i, (name, trajs) in enumerate(sorted(trajectories.items())):
        g = seeded_generator(dev, seed, i)
        trajs = torch.as_tensor(np.asarray(trajs), dtype=torch.float32, device=dev) / train_cfg.traj_div_factor
        lead = trajs.shape[:-2]
        flat = trajs.reshape((-1,) + trajs.shape[-2:])
        vids = render_videos(g, flat, train_cfg, optics)
        out[name] = vids.reshape(lead + vids.shape[1:])
    return out


def error_table(predictions: np.ndarray, d_values: np.ndarray = IN_ORDER_D_VALUES) -> Dict[str, float]:
    """Poster-notebook scoring: ``predictions`` of shape (len(d_values), P),
    already rescaled by D_max; errors = pred − true; mse = mean(err²),
    std = std(err)/4, mae = mean|err|."""
    preds = np.asarray(predictions)
    errors = preds - np.asarray(d_values)[:, None]
    return {
        "mse": float(np.mean(errors**2)),
        "std": float(np.std(errors) / 4.0),
        "mae": float(np.mean(np.abs(errors))),
    }


def save_error_table_csv(rows: Dict[str, Dict[str, float]], path: str) -> None:
    """Write the poster CSV layout: ``model,mse,std``, one row per model."""
    with open(path, "w") as f:
        f.write("model,mse,std\n")
        for name, stats in rows.items():
            f.write(f"{name},{stats['mse']:.6g},{stats['std']:.6g}\n")
