"""The bounded MSD power-law fit, batched over trajectories.

Port of ``_profiled_power_law_cost`` and ``fit_power_law_msd`` from
``moleculardiffusion_mivit_tpu/ops/curve_fit.py``: the model
``2·dim·D·t^α + offset`` with D ≥ 1e-5, 1e-5 ≤ α ≤ 10 and offset ≥ 0. For a
fixed α it is linear in (D, offset), which are solved in closed form among
four box-constrained candidates; α comes from a 96-point grid (first index
on a tie, as ``jnp.argmin``) refined by 40 golden-section steps. Each step
evaluates both of its interior points in one call. The Levenberg-Marquardt
solver and the Gaussian localisation fit of the JAX module serve the
real-data pipeline only and are not ported here (ROADMAP.md, queue 1, item
13).
"""

from __future__ import annotations

from typing import Tuple

import torch

D_MIN = 1e-5
ALPHA_LO, ALPHA_HI = 1e-5, 10.0
GOLDEN = 0.6180339887


def _profiled_power_law_cost(alpha, t, y, dim):
    """For each α of ``alpha (N, K)``, the least squares of ``2·dim·D·t^α + c``
    against ``y (N, m)`` at ``t (m,)`` over the box D ≥ 1e-5, c ≥ 0. Returns
    ``(cost, D, c)``, each ``(N, K)``; an infeasible candidate costs inf."""
    f = 2.0 * dim * t ** alpha[..., None]  # (N, K, m)
    yk = y[:, None, :]
    m = t.shape[0]
    sff = (f * f).sum(-1)
    sf = f.sum(-1)
    sfy = (f * yk).sum(-1)
    sy = yk.sum(-1)
    det = sff * m - sf * sf

    d_min = torch.full_like(sff, D_MIN)
    zero = torch.zeros_like(sff)
    d_u = (sfy * m - sf * sy) / torch.where(det.abs() > 1e-30, det, 1e-30)  # unconstrained
    c_u = (sy - sf * d_u) / m
    c_d = torch.clamp((sy - sf * D_MIN) / m, min=0.0)  # D at its bound, c free
    d_c = torch.clamp(sfy / torch.clamp(sff, min=1e-30), min=D_MIN)  # c at 0, D free

    cands_d = torch.stack([d_u, d_min, d_c, d_min], dim=-1)  # (N, K, 4)
    cands_c = torch.stack([c_u, c_d, zero, zero], dim=-1)
    r = f[..., None, :] * cands_d[..., None] + cands_c[..., None] - yk[..., None, :]
    costs = (r * r).sum(-1)
    feasible = torch.stack([(d_u >= D_MIN) & (c_u >= 0.0)] + [torch.ones_like(det, dtype=torch.bool)] * 3, dim=-1)
    costs = torch.where(feasible, costs, torch.inf)
    best = torch.argmin(costs, dim=-1, keepdim=True)
    pick = lambda v: v.gather(-1, best)[..., 0]  # noqa: E731
    return pick(costs), pick(cands_d), pick(cands_c)


def _alpha_grid(points: int, device) -> torch.Tensor:
    """``jnp.linspace(1e-5, 10, points)`` in float32, computed as JAX does:
    ``lo·(1 - s) + hi·s`` at ``s = i / (points - 1)``, then ``hi``."""
    lo = torch.tensor(ALPHA_LO, dtype=torch.float32, device=device)
    hi = torch.tensor(ALPHA_HI, dtype=torch.float32, device=device)
    s = torch.arange(points - 1, dtype=torch.float32, device=device) / float(points - 1)
    return torch.cat([lo * (1 - s) + hi * s, hi[None]])


def fit_power_law_msd(
    msds: torch.Tensor,
    dt: float = 1.0,
    dim: int = 2,
    grid_points: int = 96,
    refine_iters: int = 40,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit each row of ``msds (N, m)`` (lags 1..m at spacing ``dt``).
    Returns ``(D, alpha, offset, r_squared)``, each ``(N,)``; a row with any
    non-finite result gives zeros."""
    y = msds.to(torch.float32)
    num, m = y.shape
    dev = y.device
    t = torch.arange(1, m + 1, dtype=torch.float32, device=dev) * dt

    alphas = _alpha_grid(grid_points, dev)
    costs, _, _ = _profiled_power_law_cost(alphas.expand(num, grid_points), t, y, dim)
    best = torch.argmin(costs, dim=1)
    lo = torch.tensor(ALPHA_LO, dtype=torch.float32, device=dev)
    hi = torch.tensor(ALPHA_HI, dtype=torch.float32, device=dev)
    step = (hi - lo) / (grid_points - 1)
    a = torch.maximum(alphas[best] - step, lo)
    b = torch.minimum(alphas[best] + step, hi)

    gr = torch.tensor(GOLDEN, dtype=torch.float32, device=dev)
    for _ in range(refine_iters):
        c = b - gr * (b - a)
        d = a + gr * (b - a)
        fcd, _, _ = _profiled_power_law_cost(torch.stack([c, d], dim=1), t, y, dim)
        left = fcd[:, 0] < fcd[:, 1]
        a, b = torch.where(left, a, c), torch.where(left, d, b)
    alpha = (a + b) / 2.0
    ss_res, d_fit, offset = (v[:, 0] for v in _profiled_power_law_cost(alpha[:, None], t, y, dim))

    ss_tot = ((y - y.mean(dim=1, keepdim=True)) ** 2).sum(dim=1)
    r_squared = 1.0 - ss_res / torch.where(ss_tot > 0, ss_tot, 1.0)
    ok = torch.isfinite(d_fit) & torch.isfinite(alpha) & torch.isfinite(offset) & torch.isfinite(r_squared)
    zero = torch.zeros_like(alpha)
    return (torch.where(ok, d_fit, zero), torch.where(ok, alpha, zero),
            torch.where(ok, offset, zero), torch.where(ok, r_squared, zero))
