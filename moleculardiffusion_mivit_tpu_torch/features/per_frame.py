"""Per-frame feature tokens for the ModularTransformer.

Port of ``moleculardiffusion_mivit_tpu/features/per_frame.py``: causal
kinematic features of the frame-averaged trajectory, one token per frame.
Every feature at frame ``i`` reads positions up to ``i`` only, so the tokens
also serve sequence mode. Plain torch, batched over trajectories, in the
input's dtype (f32 on the experiments' path): there is no kernel here, as
the JAX package computes them with ``jnp`` outside Pallas.
"""

from __future__ import annotations

import torch

PER_FRAME_FEATURE_NAMES = [
    "dx",  # displacement x since the previous frame (0 at frame 0)
    "dy",  # displacement y since the previous frame
    "step_sq",  # squared step length
    "running_msd1",  # running mean of step_sq up to this frame (MSD tau=1 estimate)
    "dist_from_start",  # |r_i - r_0|
    "time_frac",  # i / (T-1)
]
N_PER_FRAME_FEATURES = len(PER_FRAME_FEATURE_NAMES)


def compute_per_frame_features(trajs_avg: torch.Tensor) -> torch.Tensor:
    """``(N, T, 2)`` frame-averaged positions → ``(N, T, 6)`` causal tokens,
    in trajectory units per frame (displacements, not velocities)."""
    n, t, _ = trajs_avg.shape
    # frame 0 has no displacement yet
    disp = torch.cat([torch.zeros_like(trajs_avg[:, :1]), torch.diff(trajs_avg, dim=1)], dim=1)
    step_sq = (disp**2).sum(-1)
    frames = torch.arange(t, dtype=trajs_avg.dtype, device=trajs_avg.device)
    running_msd1 = torch.cumsum(step_sq, dim=1) / torch.clamp(frames, min=1.0)
    dist_from_start = torch.sqrt(((trajs_avg - trajs_avg[:, :1]) ** 2).sum(-1) + 1e-12)
    time_frac = (frames / max(t - 1, 1)).expand(n, t)
    return torch.stack([disp[..., 0], disp[..., 1], step_sq, running_msd1, dist_from_start, time_frac], dim=-1)
