"""The 25-dimensional hand-crafted trajectory feature vector.

Port of ``moleculardiffusion_mivit_tpu/features/features.py`` with the same
feature order (``FEATURE_NAMES``) and semantics, over a batch ``(N, T, 2)``
at once where the JAX package ``vmap``s one trajectory:

- MSD over lags 1..n_msd−1 with n_msd = T/2 when T > 20 else T;
- the bounded power-law fit 2·d·D·t^α + offset (``ops.curve_fit``);
- efficiency (and its log), Katz-George fractal dimension, gaussianity,
  kurtosis along the dominant covariance eigenvector, MSD ratio,
  trappedness ``1 − exp(0.2045 − 0.25117·(D·T)/r0²)``, convex hull area
  (``ops.hull``), consecutive-step dot-product statistics, step-length
  statistics.

The JAX branch structure is kept: ``where`` guards evaluate both sides,
``std`` has ddof 1, sign equality counts 0 == 0. The batch wrapper replaces
NaN and ±inf by 0. Products are multiply-and-sum (no matmul), so the card
computes them in f32 whatever its TF32 setting.
"""

from __future__ import annotations

import math

import torch

from moleculardiffusion_mivit_tpu_torch.features.msd import lag_displacements
from moleculardiffusion_mivit_tpu_torch.ops.curve_fit import fit_power_law_msd
from moleculardiffusion_mivit_tpu_torch.ops.hull import convex_hull_area
from moleculardiffusion_mivit_tpu_torch.sim.trajectory import average_trajectories_frames

FEATURE_NAMES = [
    "alpha",
    "diffusion_coefficient",
    "r_squared",
    "efficiency_log",
    "efficiency",
    "fractal_dimension",
    "gaussianity",
    "kurtosis",
    "msd_ratio",
    "trappedness",
    "trajectory_length",
    "mean_step_length",
    "mean_msd",
    "mean_dot_product",
    "fraction_same_direction",
    "fraction_positive_direction",
    "total_distance",
    "min_step",
    "max_step",
    "step_range",
    "avg_velocity",
    "step_cv",
    "fraction_small_steps",
    "fraction_large_steps",
    "convex_hull_area",
]
N_FEATURES = len(FEATURE_NAMES)

# (rtol, atol) per feature at which two f32 implementations agree on
# Brownian trajectories of 30 frames: the JAX package and this port, or this
# port on the card and on the CPU. The fit's cost is flat in α to within f32
# rounding over about ±1e-3 around its minimum, so the golden-section steps
# branch on rounding noise there: α, D and trappedness (which reads D) are
# held looser; r² (the fit's quality) is not.
PARITY_TOLERANCE = {
    **{name: (1e-5, 1e-6) for name in FEATURE_NAMES},
    "alpha": (0.0, 5e-3),
    "diffusion_coefficient": (1e-2, 0.0),
    "trappedness": (0.0, 5e-3),
}


def _lagged_moments(trajs: torch.Tensor, n_lags: int):
    """For lags 1..n_lags: ``msd(lag) = mean_j |x(j+lag) − x(j)|²`` and
    ``r4(lag) = mean_j (dx⁴ + dy⁴)``, each ``(N, n_lags)``."""
    d, valid, count = lag_displacements(trajs, n_lags)
    msd = ((d * d).sum(-1) * valid).sum(-1) / count
    r4 = ((d**4).sum(-1) * valid).sum(-1) / count
    return msd, r4


def _kurtosis_dominant(trajs: torch.Tensor) -> torch.Tensor:
    """Kurtosis (non-excess, population moments) of each trajectory's
    projection onto the dominant eigenvector of its covariance (ddof 1)."""
    t = trajs.shape[1]
    x = trajs - trajs.mean(dim=1, keepdim=True)
    a = (x[..., 0] * x[..., 0]).sum(1) / (t - 1)
    b = (x[..., 0] * x[..., 1]).sum(1) / (t - 1)
    c = (x[..., 1] * x[..., 1]).sum(1) / (t - 1)
    disc = torch.sqrt(torch.clamp(((a - c) / 2.0) ** 2 + b * b, min=0.0))
    lam_max = (a + c) / 2.0 + disc
    v1 = torch.stack([b, lam_max - a], dim=-1)
    v2 = torch.stack([lam_max - c, b], dim=-1)
    v = torch.where((v1.norm(dim=-1) > v2.norm(dim=-1))[:, None], v1, v2)
    norm = v.norm(dim=-1, keepdim=True)
    unit = torch.tensor([1.0, 0.0], device=trajs.device)
    v = torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-12), unit)
    proj = trajs[..., 0] * v[:, None, 0] + trajs[..., 1] * v[:, None, 1]
    centred = proj - proj.mean(dim=1, keepdim=True)
    m2 = (centred**2).mean(dim=1)
    m4 = (centred**4).mean(dim=1)
    return torch.where(m2 > 0, m4 / torch.clamp(m2, min=1e-30) ** 2, torch.nan)


def _sign_mean(cond: torch.Tensor) -> torch.Tensor:
    return cond.to(torch.float32).mean(dim=1)


def compute_diffusion_features(trajectories: torch.Tensor, dt: float = 1.0) -> torch.Tensor:
    """The 25 features of each trajectory: ``(N, T, 2)`` → ``(N, 25)``, T ≥ 3.
    NaN where the reference gives NaN (see the batch wrapper)."""
    trajs = trajectories.to(torch.float32)
    n, t, _ = trajs.shape
    if t < 3:
        raise ValueError("trajectory must have at least 3 points")
    nan = torch.full((n,), torch.nan, device=trajs.device)

    n_msd = int(t * 0.5) if t > 20 else t
    n_lags = n_msd - 1
    msd_vals, r4_vals = _lagged_moments(trajs, n_lags)

    diff = trajs[:, :, None, :] - trajs[:, None, :, :]
    max_dist = (diff * diff).sum(-1).flatten(1).max(dim=1).values

    steps = trajs[:, 1:] - trajs[:, :-1]
    sq_steps = (steps * steps).sum(-1)
    sl = torch.sqrt(sq_steps)  # (N, T-1)
    dots = (steps[:, :-1] * steps[:, 1:]).sum(-1)  # (N, T-2)

    d_fit, alpha, _offset, r_squared = fit_power_law_msd(msd_vals, dt, dim=2)

    end_to_end = trajs[:, -1] - trajs[:, 0]
    top = (end_to_end * end_to_end).sum(-1)
    bottom = sq_steps.sum(-1)
    eff = torch.where(bottom > 0, top / ((t - 1) * torch.clamp(bottom, min=1e-30)), 0.0)
    eff_log = torch.where(bottom > 0, torch.log(torch.clamp(eff, min=1e-30)), -torch.inf)

    total_len = sl.sum(1)
    log_t = math.log(float(t))
    spread = torch.clamp(torch.sqrt(max_dist) / torch.clamp(total_len, min=1e-30), min=1e-30)
    fractal = torch.where(total_len > 0, log_t / (log_t + torch.log(spread)), 1.0)

    valid = msd_vals > 0
    gauss_terms = r4_vals / (2.0 * torch.clamp(msd_vals, min=1e-30) ** 2)
    n_valid = valid.sum(1)
    gaussianity = torch.where(
        n_valid > 0, torch.where(valid, gauss_terms, 0.0).sum(1) / torch.clamp(n_valid, min=1), torch.nan
    )

    kurt = _kurtosis_dominant(trajs)

    if n_lags >= 2:
        ratio_t = (torch.arange(1, n_lags, dtype=torch.float32, device=trajs.device)
                   / torch.arange(2, n_lags + 1, dtype=torch.float32, device=trajs.device))
        msd_ratio = (msd_vals[:, :-1] / torch.clamp(msd_vals[:, 1:], min=1e-30) - ratio_t).mean(1)
    else:
        msd_ratio = nan

    r0 = torch.sqrt(max_dist) / 2.0
    trapped = torch.where(
        (r0 > 0) & (d_fit != 0),
        1.0 - torch.exp(0.2045 - 0.25117 * (d_fit * t) / torch.clamp(r0, min=1e-30) ** 2),
        0.0,
    )

    hull = convex_hull_area(trajs)

    mean_sl = sl.mean(1)
    n_dots = dots.shape[1]
    mean_dots = dots.mean(1) if n_dots > 0 else nan
    signs = torch.sign(dots)
    same_dir = _sign_mean(signs[:, 1:] == signs[:, :-1]) if n_dots > 1 else nan
    pos_dir = _sign_mean(signs > 0) if n_dots > 0 else nan
    sl_std = sl.std(dim=1, correction=1)
    step_cv = torch.where(
        (mean_sl > 0) & (sl.shape[1] > 1), sl_std / torch.clamp(mean_sl, min=1e-30), torch.nan
    )
    sl_min, sl_max = sl.min(dim=1).values, sl.max(dim=1).values

    return torch.stack(
        [
            alpha,
            d_fit,
            r_squared,
            eff_log,
            eff,
            fractal,
            gaussianity,
            kurt,
            msd_ratio,
            trapped,
            torch.full((n,), float(t), device=trajs.device),
            mean_sl,
            msd_vals.mean(1),
            mean_dots,
            same_dir,
            pos_dir,
            total_len,
            sl_min,
            sl_max,
            sl_max - sl_min,
            total_len / t,
            step_cv,
            _sign_mean(sl < 0.1),
            _sign_mean(sl > 0.4),
            hull,
        ],
        dim=1,
    )


def compute_features_for_multiple_trajectories(
    trajectories: torch.Tensor, dt: float = 1.0, n_pos_per_frame: int = 1
) -> torch.Tensor:
    """Batch wrapper: optional sub-position averaging (``n_pos_per_frame``
    consecutive positions into one), the 25 features, NaN and ±inf → 0."""
    trajs = trajectories.to(torch.float32)
    if n_pos_per_frame != 1:
        trajs = average_trajectories_frames(trajs, n_pos_per_frame)
    return torch.nan_to_num(compute_diffusion_features(trajs, dt), nan=0.0, posinf=0.0, neginf=0.0)
