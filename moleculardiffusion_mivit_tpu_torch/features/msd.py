"""Mean-square-displacement estimators.

Port of ``moleculardiffusion_mivit_tpu/features/msd.py``: the per-lag MSD
of a batch of trajectories and the closed-form D estimators built on it, all
over the batch at once (the lags as one gathered axis, no loop). Products
are written as multiply-and-sum rather than matmuls, so the card computes
them in f32 whatever its TF32 setting.
"""

from __future__ import annotations

import torch


def lag_displacements(trajectories: torch.Tensor, n_lags: int) -> torch.Tensor:
    """``(d, valid, count)``: ``d (N, n_lags, T, 2)`` = ``x(j + lag) − x(j)``
    for lags 1..n_lags and every start ``j``, where starts with
    ``j + lag ≥ T`` wrap around (the JAX package's ``roll``); ``valid
    (n_lags, T)`` masks them out; ``count (n_lags,)`` = valid starts per lag
    (at least 1)."""
    t = trajectories.shape[1]
    dev = trajectories.device
    lags = torch.arange(1, n_lags + 1, device=dev)
    j = torch.arange(t, device=dev)
    rolled = trajectories[:, (j[None, :] + lags[:, None]) % t]
    valid = (j[None, :] < (t - lags[:, None])).to(torch.float32)
    return rolled - trajectories[:, None], valid, torch.clamp(t - lags, min=1)


def mean_square_displacements(trajectories: torch.Tensor) -> torch.Tensor:
    """Per-lag MSD: ``(N, T, 2)`` → ``(N, T)`` with ``msd[:, 0] = 0`` and
    ``msd[:, tau] = mean_t |x(t + tau) − x(t)|²``."""
    trajs = trajectories.to(torch.float32)
    n, t, _ = trajs.shape
    d, valid, count = lag_displacements(trajs, t - 1)
    tail = ((d * d).sum(-1) * valid).sum(-1) / count
    return torch.cat([torch.zeros((n, 1), dtype=torch.float32, device=trajs.device), tail], dim=1)


def mean_square_displacement(trajectory: torch.Tensor) -> torch.Tensor:
    """Single-trajectory variant: ``(T, 2)`` → ``(T,)``."""
    return mean_square_displacements(trajectory[None])[0]


def estimate_d_from_msds(msds: torch.Tensor, time_range: torch.Tensor) -> torch.Tensor:
    """Origin-constrained least-squares slope / 4: ``Σ t·msd / Σ t²``."""
    t = torch.as_tensor(time_range, dtype=torch.float32, device=msds.device)
    return (msds * t).sum(-1) / (t * t).sum() / 4.0


def estimate_d_from_msd(msd: torch.Tensor, time_range: torch.Tensor) -> torch.Tensor:
    return estimate_d_from_msds(msd[None], time_range)[0]


def estimate_d_from_msds_weighted(msds: torch.Tensor, time_range: torch.Tensor) -> torch.Tensor:
    """Tau-weighted estimator: each MSD value over its lag index (1 at lag
    0), weighted T..1, averaged, / 4. ``time_range`` is unused, as in the
    reference."""
    t = msds.shape[1]
    weights = torch.arange(t, 0, -1, dtype=torch.float32, device=msds.device)
    div = torch.arange(t, dtype=torch.float32, device=msds.device)
    div[0] = 1.0
    return ((msds / div) * weights).sum(-1) / weights.sum() / 4.0


def estimate_d_from_msds_polyfit(msds: torch.Tensor, time_range: torch.Tensor) -> torch.Tensor:
    """Degree-1 fit with intercept: slope / 4."""
    t = torch.as_tensor(time_range, dtype=torch.float32, device=msds.device)
    tc = t - t.mean()
    ym = msds.mean(dim=1, keepdim=True)
    return ((msds - ym) * tc).sum(-1) / (tc * tc).sum() / 4.0


def d_from_msd_tau1(trajectories: torch.Tensor) -> torch.Tensor:
    """MSD at lag 1 per trajectory ``(N, T, 2)`` → ``(N,)``: the classical
    baseline the poster scales by 250 (raw sub-positions) or 37.5
    (frame-averaged)."""
    deltas = trajectories[:, 1:] - trajectories[:, :-1]
    return (deltas**2).sum(-1).mean(dim=1)
