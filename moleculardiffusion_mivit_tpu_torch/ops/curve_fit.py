"""Bounded least-squares fits, batched over problems.

Port of ``moleculardiffusion_mivit_tpu/ops/curve_fit.py``:

- the MSD power-law fit (``_profiled_power_law_cost``,
  ``fit_power_law_msd``): the model ``2·dim·D·t^α + offset`` with D ≥ 1e-5,
  1e-5 ≤ α ≤ 10 and offset ≥ 0. For a fixed α it is linear in (D, offset),
  which are solved in closed form among four box-constrained candidates; α
  comes from a 96-point grid (first index on a tie, as ``jnp.argmin``)
  refined by 40 golden-section steps. Each step evaluates both of its
  interior points in one call.
- the projected Levenberg-Marquardt solver (``levenberg_marquardt``) and the
  2-D Gaussian localisation fit on it (``fit_gaussian_2d``): N problems in
  one call, each with its own damping and its own accept/reject, a fixed
  number of steps, as ``jax.vmap`` of the JAX functions. The Jacobian is
  analytic where JAX takes ``jax.jacfwd``.
"""

from __future__ import annotations

from typing import Callable, Tuple

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


def levenberg_marquardt(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    jacobian_fn: Callable[[torch.Tensor], torch.Tensor],
    p0: torch.Tensor,
    lower: torch.Tensor,
    upper: torch.Tensor,
    num_iters: int = 50,
    lam0: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimise ``sum(residual_fn(p)**2)`` subject to ``lower <= p <= upper``
    for each row of ``p0 (N, n)``: ``residual_fn (N, n) → (N, m)``,
    ``jacobian_fn (N, n) → (N, m, n)``, bounds ``(n,)``.

    Returns ``(p (N, n), final_cost (N,))``. A step solves
    ``(JᵀJ + λ·diag(max(diag JᵀJ, 1e-12)) + 1e-12·I) δ = −Jᵀr``, projects
    ``p + δ`` onto the box and is accepted when its cost is finite and
    lower; λ falls ×0.1 on an accepted step (to 1e-12 at least) and rises
    ×10 on a rejected one (to 1e12 at most). A singular system gives a
    non-finite step, which is rejected, as in JAX."""
    p = torch.clamp(p0.to(torch.float32), lower, upper)
    n = p.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=p.device)

    def cost(q):
        r = residual_fn(q)
        return (r * r).sum(-1)

    c = cost(p)
    lam = torch.full(c.shape, lam0, dtype=torch.float32, device=p.device)
    for _ in range(num_iters):
        r = residual_fn(p)
        j = jacobian_fn(p)
        jt = j.transpose(-1, -2)
        jtj = jt @ j
        jtr = (jt @ r[..., None])[..., 0]
        damping = lam[:, None, None] * torch.diag_embed(torch.clamp(torch.diagonal(jtj, dim1=-2, dim2=-1), min=1e-12))
        step = torch.linalg.solve_ex(jtj + damping + 1e-12 * eye, -jtr)[0]
        p_new = torch.clamp(p + step, lower, upper)
        c_new = cost(p_new)
        accept = torch.isfinite(c_new) & (c_new < c)
        p = torch.where(accept[:, None], p_new, p)
        c = torch.where(accept, c_new, c)
        lam = torch.where(accept, torch.clamp(lam * 0.1, min=1e-12), torch.clamp(lam * 10.0, max=1e12))
    return p, c


def gaussian_2d_problem(patches: torch.Tensor):
    """The least-squares problem of ``fit_gaussian_2d`` for ``patches (N, h,
    w)``: ``(residual_fn, jacobian_fn, p0, lower, upper)`` in
    ``levenberg_marquardt``'s form, parameters (A, x0, y0, σ, offset), x
    along a row."""
    patches = patches.to(torch.float32)
    n, h, w = patches.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=patches.device),
        torch.arange(w, dtype=torch.float32, device=patches.device),
        indexing="ij",
    )
    xs, ys = xs.reshape(1, -1), ys.reshape(1, -1)
    target = patches.reshape(n, -1)

    def terms(p):
        amp, x0, y0, sigma, offset = (v[:, None] for v in p.unbind(-1))
        dx, dy = xs - x0, ys - y0
        q = dx**2 + dy**2
        return amp, sigma, offset, dx, dy, q, torch.exp(-(q / (2.0 * sigma**2)))

    def residual(p):
        amp, _, offset, _, _, _, e = terms(p)
        return offset + amp * e - target

    def jacobian(p):
        amp, sigma, _, dx, dy, q, e = terms(p)
        ae = amp * e
        return torch.stack(
            [e, ae * dx / sigma**2, ae * dy / sigma**2, ae * q / sigma**3, torch.ones_like(e)], dim=-1
        )

    ones = torch.ones_like(target[:, 0])
    p0 = torch.stack([target.amax(-1), ones * float((w - 1) // 2), ones * float((h - 1) // 2), ones,
                      target.amin(-1)], dim=-1)
    inf = float("inf")
    lower = torch.tensor([-inf, -inf, -inf, 1e-3, -inf], dtype=torch.float32, device=patches.device)
    upper = torch.full((5,), inf, dtype=torch.float32, device=patches.device)
    return residual, jacobian, p0, lower, upper


def fit_gaussian_2d(patches: torch.Tensor, num_iters: int = 40) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric 2-D Gaussian fit of each patch of ``patches (N, h, w)``,
    for sub-pixel localisation: the model ``offset + A·exp(-((x-x0)² +
    (y-y0)²)/(2σ²))`` from (max, centre, centre, 1.0, min), σ ≥ 1e-3.
    Returns ``(params (N, 5) as (A, x0, y0, σ, offset), final_cost (N,))``."""
    return levenberg_marquardt(*gaussian_2d_problem(patches), num_iters)
