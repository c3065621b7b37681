"""Trajectory simulators: the pure-Brownian path.

Port of ``moleculardiffusion_mivit_tpu/sim/trajectory.py``. Random numbers
come from an explicit ``torch.Generator``; results lie on the generator's
device. The streams differ from JAX's, so the tests compare these samplers
with the JAX ones in distribution. The fractional-Brownian branch, drift and
confinement are ROADMAP queue 1 item 9 and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

_LATER = "is not ported yet (ROADMAP.md, queue 1, item 9: the rest of sim/)"


def brownian_motion(
    generator: torch.Generator,
    nparticles: int,
    nframes: int,
    nposframe: int,
    D: Union[float, torch.Tensor],
    dt: float,
    start_at_zero: bool = False,
    drift: Optional[Union[Tuple[float, float], torch.Tensor]] = None,
) -> torch.Tensor:
    """Brownian random walk with per-step sigma ``sqrt(2*D*dt/nposframe)``.

    ``D`` is a scalar or a per-particle ``(nparticles,)`` tensor; ``drift``
    an optional constant velocity ``(vx, vy)``, or ``(nparticles, 2)``.
    Returns ``(nparticles, nframes*nposframe, 2)`` float32 positions.
    """
    dev = generator.device
    num_steps = nframes * nposframe
    sigma = torch.sqrt(2.0 * torch.as_tensor(D, dtype=torch.float32, device=dev) * dt / nposframe)
    sigma = torch.broadcast_to(sigma, (nparticles,))[:, None, None]
    steps = torch.randn((nparticles, num_steps, 2), generator=generator, device=dev) * sigma
    if drift is not None:
        v = torch.broadcast_to(torch.as_tensor(drift, dtype=torch.float32, device=dev), (nparticles, 2))
        steps = steps + v[:, None, :] * (dt / nposframe)
    if start_at_zero:
        steps[:, 0, :] = 0.0
    return torch.cumsum(steps, dim=1)


def average_trajectories_frames(trajectories: torch.Tensor, n_pos_frame: int) -> torch.Tensor:
    """Average ``n_pos_frame`` consecutive sub-positions into one per-frame
    position: ``(N, T, 2)`` → ``(N, T // n_pos_frame, 2)``."""
    n, t, d = trajectories.shape
    n_full = t // n_pos_frame
    reshaped = trajectories[:, : n_full * n_pos_frame].reshape(n, n_full, n_pos_frame, d)
    return reshaped.mean(dim=2)


def _truncated_normal_at_zero(generator: torch.Generator, mean: float, sigma: float, shape) -> torch.Tensor:
    """Sample N(mean, sigma^2) conditioned on being >= 0, by inverse CDF in
    float64; the constant ``mean`` when ``sigma == 0``."""
    dev = generator.device
    if sigma <= 0:
        return torch.full(shape, float(mean), dtype=torch.float32, device=dev)
    lower = torch.tensor(-mean / sigma, dtype=torch.float64, device=dev)
    cdf_lo = torch.special.ndtr(lower)
    u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float64)
    tn = torch.special.ndtri(cdf_lo + (1.0 - cdf_lo) * u)
    tn = torch.maximum(tn, lower)  # rounding at the bound
    return (mean + sigma * tn).to(torch.float32)


def _pair(v) -> Tuple[float, float]:
    return (float(v[0]), float(v[1])) if isinstance(v, (tuple, list)) else (float(v), 0.0)


def single_state(
    generator: torch.Generator,
    N: int,
    T: int,
    Ds: Union[float, Tuple[float, float]],
    alphas: Union[float, Tuple[float, float]] = 1.0,
    drift: Optional[Tuple[float, float]] = None,
    L: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equivalent of ``models_phenom().single_state`` on its pure-Brownian
    branch: per-particle D ~ N(mean, sigma) truncated at 0 (``Ds=(mean,
    sigma)``; a scalar is a constant), iid normal steps with variance ``2D``,
    positions their cumulative sum. Returns ``trajs (N, T, 2)`` and labels
    ``(N, T, 3)`` = ``(alpha, D, state)`` per step.
    """
    d_mean, d_sigma = _pair(Ds)
    a_mean, a_sigma = _pair(alphas)
    if not (a_mean == 1.0 and a_sigma == 0.0):
        raise NotImplementedError(f"single_state: fractional Brownian motion (alphas != 1) {_LATER}")
    if float(L) > 0.0:
        raise NotImplementedError(f"single_state: confinement (L > 0) {_LATER}")
    if drift is not None:
        raise NotImplementedError(f"single_state: drift {_LATER}")
    dev = generator.device
    ds = _truncated_normal_at_zero(generator, d_mean, d_sigma, (N,))
    sigma = torch.sqrt(2.0 * ds)[:, None, None]
    steps = torch.randn((N, T, 2), generator=generator, device=dev) * sigma
    trajs = torch.cumsum(steps, dim=1)
    labels = torch.stack(
        [
            torch.ones((N, T), dtype=torch.float32, device=dev),
            torch.broadcast_to(ds[:, None], (N, T)),
            torch.zeros((N, T), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    return trajs, labels
