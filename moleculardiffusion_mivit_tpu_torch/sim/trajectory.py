"""Trajectory simulators.

Port of ``moleculardiffusion_mivit_tpu/sim/trajectory.py``: Brownian walks,
fractional Gaussian noise by circulant embedding (Davies-Harte, on
``torch.fft``), fractional Brownian motion, reflection into a box, and
``single_state`` with its fBm, drift and confinement branches. Random
numbers come from an explicit ``torch.Generator``; results lie on the
generator's device. The streams differ from JAX's, so the tests compare
these samplers with the JAX ones in distribution, and the fGn's
deterministic part (``_fgn_from_normals``) on JAX's own normal draws.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


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


def _fgn_from_normals(hurst: torch.Tensor, zr: torch.Tensor, zi: torch.Tensor) -> torch.Tensor:
    """The deterministic part of ``fractional_gaussian_noise``: ``batch``
    fGn series of length ``n`` from the real and imaginary standard normals
    ``zr``, ``zi`` ``(batch, 2n)`` and the Hurst exponents ``hurst
    (batch,)``, in the normals' dtype (f32 on every path; f64 gives the
    exact series a check compares with). The autocovariance ``γ(k) =
    ½(|k+1|^2H − 2|k|^2H + |k−1|^2H)`` is embedded in a circulant of size
    ``2n``; its eigenvalues (the FFT of the first row) are clamped at 0, and
    ``Re(F diag(sqrt(λ/2n)) z)`` has the embedding's covariance. In f32, γ
    at large k cancels terms ~k^2H down to ~k^(2H−2), so for H > ½ an f32
    series lies off the exact one by far more than f32 rounding: 0.56 % of
    the sd at H = 0.75 and n = 300 on the CPU (JAX's f32 series the same)."""
    batch, m = zr.shape
    n = m // 2
    k = torch.arange(n + 1, dtype=zr.dtype, device=zr.device)
    two_h = (2.0 * hurst.to(zr.dtype))[:, None]
    gamma = 0.5 * ((k + 1.0).abs() ** two_h - 2.0 * k.abs() ** two_h + (k - 1.0).abs() ** two_h)
    row = torch.cat([gamma, gamma[:, 1:-1].flip(1)], dim=1)  # [g0..gn, g(n-1)..g1]
    eig = torch.clamp(torch.fft.fft(row, dim=1).real, min=0.0)
    z = torch.complex(zr, zi)
    return torch.fft.fft(torch.sqrt(eig / m).to(z.dtype) * z, dim=1)[:, :n].real


def fractional_gaussian_noise(
    generator: torch.Generator, hurst: Union[float, torch.Tensor], n: int, batch: int = 1
) -> torch.Tensor:
    """``batch`` independent fGn series ``(batch, n)`` with Hurst exponent
    ``hurst`` (scalar or ``(batch,)``), unit step and unit variance, by
    circulant embedding (Davies-Harte). Draws the real, then the imaginary
    normals ``(batch, 2n)`` from ``generator``."""
    dev = generator.device
    hurst = torch.broadcast_to(torch.as_tensor(hurst, dtype=torch.float32, device=dev), (batch,))
    zr = torch.randn((batch, 2 * n), generator=generator, device=dev)
    zi = torch.randn((batch, 2 * n), generator=generator, device=dev)
    return _fgn_from_normals(hurst, zr, zi)


def fbm_trajectories(
    generator: torch.Generator,
    nparticles: int,
    num_steps: int,
    alpha: Union[float, torch.Tensor],
    D: Union[float, torch.Tensor],
    dt: float = 1.0,
) -> torch.Tensor:
    """2-D fractional Brownian motion ``(nparticles, num_steps, 2)``:
    displacements are fGn of Hurst ``alpha/2`` scaled to std ``sqrt(2·D·dt)``
    at every alpha, positions their cumulative sum (no prepended origin).
    ``alpha`` and ``D`` are scalars or per-particle tensors; x is drawn
    before y."""
    dev = generator.device
    alpha = torch.broadcast_to(torch.as_tensor(alpha, dtype=torch.float32, device=dev), (nparticles,))
    D = torch.broadcast_to(torch.as_tensor(D, dtype=torch.float32, device=dev), (nparticles,))
    hurst = alpha / 2.0
    disp_x = fractional_gaussian_noise(generator, hurst, num_steps, nparticles)
    disp_y = fractional_gaussian_noise(generator, hurst, num_steps, nparticles)
    scale = torch.sqrt(2.0 * D * dt)[:, None]
    return torch.cumsum(torch.stack([disp_x * scale, disp_y * scale], dim=-1), dim=1)


def reflect_into_box(positions: torch.Tensor, L: Union[float, torch.Tensor]) -> torch.Tensor:
    """Fold free positions into ``[0, L]`` with reflecting boundaries: the
    triangle wave ``L − |mod(x, 2L) − L|``, with ``torch.remainder`` (the
    sign of the divisor, as ``jnp.mod``; ``torch.fmod`` keeps the sign of
    ``x`` and would fold negative positions wrongly)."""
    L = torch.as_tensor(L, dtype=torch.float32, device=positions.device)
    return L - torch.abs(torch.remainder(positions, 2.0 * L) - L)


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
    """Equivalent of ``models_phenom().single_state``: per-particle D ~ N(mean,
    sigma) truncated at 0 (``Ds=(mean, sigma)``; a scalar is a constant), and
    the same for ``alphas``, clipped to [0, 2]. ``alphas == 1`` is the
    pure-Brownian branch (iid normal steps with variance ``2D``, positions
    their cumulative sum); otherwise the displacements are fGn of Hurst α/2
    (``fbm_trajectories``). ``drift (vx, vy)`` moves step ``i`` by
    ``drift·(i+1)``. ``L > 0`` starts each particle uniformly in ``[0,
    L]²`` and folds the path into the box (``reflect_into_box``); drift with
    ``L > 0`` raises ``ValueError``, as in the JAX package: the fold is exact
    only for driftless increments.

    Draws, in order: D (when sigma > 0), then on the pure-Brownian branch the
    steps, otherwise α (when its sigma > 0) and the fGn; then the start in the
    box when ``L > 0``. So the pure-Brownian branch without drift or box draws
    exactly what it always drew. Returns ``trajs (N, T, 2)`` and labels
    ``(N, T, 3)`` = ``(alpha, D, state)`` per step.
    """
    d_mean, d_sigma = _pair(Ds)
    a_mean, a_sigma = _pair(alphas)
    confined = float(L) > 0.0
    if drift is not None and confined and any(float(v) != 0.0 for v in drift):
        raise ValueError(
            "drift combined with confinement (L > 0) is unsupported: the triangle-wave fold is only "
            "exact for driftless increments"
        )
    dev = generator.device
    ds = _truncated_normal_at_zero(generator, d_mean, d_sigma, (N,))
    if a_mean == 1.0 and a_sigma == 0.0:
        a = torch.ones((N,), dtype=torch.float32, device=dev)
        sigma = torch.sqrt(2.0 * ds)[:, None, None]
        steps = torch.randn((N, T, 2), generator=generator, device=dev) * sigma
        trajs = torch.cumsum(steps, dim=1)
    else:
        a = torch.clamp(_truncated_normal_at_zero(generator, a_mean, a_sigma, (N,)), 0.0, 2.0)
        trajs = fbm_trajectories(generator, N, T, a, ds)
    if drift is not None:
        times = torch.arange(1, T + 1, dtype=torch.float32, device=dev)
        v = torch.as_tensor(drift, dtype=torch.float32, device=dev)
        trajs = trajs + v[None, None, :] * times[None, :, None]
    if confined:
        start = torch.rand((N, 1, 2), generator=generator, device=dev) * torch.tensor(float(L), dtype=torch.float32)
        trajs = reflect_into_box(trajs + start, float(L))
    labels = torch.stack(
        [
            torch.broadcast_to(a[:, None], (N, T)),
            torch.broadcast_to(ds[:, None], (N, T)),
            torch.zeros((N, T), dtype=torch.float32, device=dev),
        ],
        dim=-1,
    )
    return trajs, labels
