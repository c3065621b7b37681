"""Fluorescence video renderer.

Port of ``moleculardiffusion_mivit_tpu/sim/render.py`` (the main-path part).
A frame before noise is ``Σ_p w_p · pool(g_y,p) ⊗ pool(g_x,p)``: the 2-D
Gaussian on the upsampled grid is an outer product of 1-D Gaussians, and
both the u×u mean pooling and the grid maximum factor over it, so only
``O(P·S·u)`` exponentials are needed per frame. ``render_frames_core``
sends CUDA tensors to kernel K1 (``ops/render.py``) and CPU tensors to its
plain version. Noise is drawn from an explicit ``torch.Generator`` on the
data's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig, TrainConfig


def hr_grid_coords(output_size: int, upsampling_factor: int, device=None) -> torch.Tensor:
    """``linspace(-limit, limit, S*u)`` with ``limit=(S*u-1)//2``; unit
    spacing iff ``S*u`` is odd."""
    grid = output_size * upsampling_factor
    limit = (grid - 1) // 2
    return torch.linspace(-float(limit), float(limit), grid, dtype=torch.float32, device=device)


def _pooled_gaussian_1d(
    centers: torch.Tensor, sigma_hr, output_size: int, upsampling_factor: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D unit-peak Gaussians on the HR grid, mean-pooled by ``u``.
    Returns ``(pooled (..., S), gmax (...,))``."""
    coords = hr_grid_coords(output_size, upsampling_factor, device=centers.device)
    d = coords - centers[..., None]
    sig = torch.as_tensor(sigma_hr, dtype=torch.float32, device=centers.device)
    if sig.ndim > 0:
        sig = sig[..., None]
    g = torch.exp(-(d * d) / (2.0 * sig * sig))
    gmax = g.amax(dim=-1)
    pooled = g.reshape(g.shape[:-1] + (output_size, upsampling_factor)).mean(dim=-1)
    return pooled, gmax


def render_frames_core(x_hr, y_hr, intensities, sigma_hr, output_size: int, upsampling_factor: int):
    """Render noise-free frames ``(..., S, S)`` from ``(..., P)`` HR-grid
    sub-positions and intensities, with peak renormalisation. CUDA tensors go
    through kernel K1 (scalar sigma only; anything else raises); CPU tensors
    through its plain version, which also takes a broadcastable sigma."""
    from moleculardiffusion_mivit_tpu_torch.ops.render import (
        render_frames,
        render_frames_reference,
    )

    if not x_hr.is_cuda:
        return render_frames_reference(
            x_hr, y_hr, intensities, sigma_hr, output_size, upsampling_factor
        )
    lead, p, s = x_hr.shape[:-1], x_hr.shape[-1], output_size
    flat = render_frames(
        x_hr.reshape(-1, p).contiguous(),
        y_hr.reshape(-1, p).contiguous(),
        intensities.reshape(-1, p).contiguous(),
        sigma_hr,
        output_size,
        upsampling_factor,
    )
    return flat.reshape(lead + (s, s))


def _prepare_subpositions(
    trajectories: torch.Tensor, n_pos_per_frame: int, center: bool, optics: OpticsConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """y-axis inversion, trajectory-unit → pixel conversion, framing into
    ``(N, F, P)``, optional per-frame centering, scaling to HR coordinates."""
    n, t, _ = trajectories.shape
    if t % n_pos_per_frame != 0:
        raise ValueError("T is not divisible by n_pos_per_frame")
    n_frames = t // n_pos_per_frame
    trajs = trajectories.to(torch.float32)
    trajs = trajs * torch.tensor([1.0, -1.0], dtype=torch.float32, device=trajs.device)
    trajs = trajs * torch.tensor(optics.pixels_per_unit, dtype=torch.float32)
    seg = trajs.reshape(n, n_frames, n_pos_per_frame, 2)
    if center:
        seg = seg - seg.mean(dim=2, keepdim=True)
    seg = seg * torch.tensor(float(optics.upsampling_factor), dtype=torch.float32)
    return seg[..., 0], seg[..., 1]


def _clipped_background(generator: torch.Generator, shape, bg_mean: float, bg_std: float) -> torch.Tensor:
    """``clip(N(mean, std), 0, mean + 3 std)`` additive background."""
    noise = torch.randn(shape, generator=generator, device=generator.device) * torch.tensor(
        bg_std, dtype=torch.float32
    )
    hi = torch.tensor(bg_mean + 3.0 * bg_std, dtype=torch.float32)
    return torch.clamp(torch.tensor(bg_mean, dtype=torch.float32) + noise, 0.0, float(hi))


def _poisson(generator: torch.Generator, lam: torch.Tensor) -> torch.Tensor:
    return torch.poisson(lam, generator=generator)


def trajectories_to_video(
    generator: torch.Generator,
    trajectories: torch.Tensor,
    n_pos_per_frame: int,
    center: bool = False,
    optics: OpticsConfig = OpticsConfig(),
) -> torch.Tensor:
    """Trajectories ``(N, T, 2)`` (trajectory units) → noisy videos
    ``(N, T // n_pos_per_frame, S, S)`` float32: per-sub-position intensity
    ~ N(μ/P, σ/P), peak renormalisation, u×u pooling, clipped Gaussian
    background, multiplicative Poisson noise ``Pois(k)/k`` when k != -1.
    ``generator`` must lie on the trajectories' device."""
    n, t, _ = trajectories.shape
    p = n_pos_per_frame
    n_frames = t // p
    s, u = optics.output_size, optics.upsampling_factor
    part_mean, part_std = optics.particle_intensity
    bg_mean, bg_std = optics.background_intensity
    dev = trajectories.device

    x_hr, y_hr = _prepare_subpositions(trajectories, p, center, optics)
    if part_mean > 1e-4 and part_std > 1e-4:
        intensities = part_mean / p + (part_std / p) * torch.randn(
            (n, n_frames, p), generator=generator, device=dev
        )
        frames = render_frames_core(x_hr, y_hr, intensities, optics.gaussian_sigma_hr, s, u)
    else:
        frames = torch.zeros((n, n_frames, s, s), dtype=torch.float32, device=dev)

    frames = frames + _clipped_background(generator, frames.shape, bg_mean, bg_std)
    if optics.poisson_noise != -1:
        k = float(optics.poisson_noise)
        lam = torch.full(frames.shape, k, dtype=torch.float32, device=dev)
        frames = frames * (_poisson(generator, lam) / k)
    return frames


def normalize_images(
    images: torch.Tensor,
    background_mean: Optional[float] = None,
    background_sigma: Optional[float] = None,
    theoretical_max: Optional[float] = None,
    clip_image: bool = False,
):
    """``(im - (bg_mean - bg_sigma)) / (theo_max - (bg_mean - bg_sigma))``,
    optionally clipped to [0, 1.5]. Missing statistics come from the images
    (population std). Returns ``(normalized, (bg_mean, bg_sigma, theo_max))``."""
    if background_mean is None:
        background_mean = images.mean()
    if background_sigma is None:
        background_sigma = images.std(correction=0)
    if theoretical_max is None:
        theoretical_max = images.max()
    low = background_mean - background_sigma
    denom = theoretical_max - low
    normalized = (images - low) / denom
    if clip_image:
        normalized = torch.clamp(normalized, 0.0, 1.5)
    return normalized, (background_mean, background_sigma, theoretical_max)


def render_videos(
    generator: torch.Generator, trajectories: torch.Tensor, train_cfg: TrainConfig, optics: OpticsConfig
) -> torch.Tensor:
    """Trajectories ``(N, T, 2)`` (already divided by ``traj_div_factor``) →
    the videos every experiment trains and validates on:
    ``trajectories_to_video`` with ``train_cfg``'s sub-positions per frame
    and centering, normalised against ``(bg_mean, bg_sigma, part_mean +
    bg_mean)``."""
    bg_mean, bg_sigma = optics.background_intensity
    part_mean = optics.particle_intensity[0]
    videos = trajectories_to_video(generator, trajectories, train_cfg.n_pos_per_frame, train_cfg.center, optics)
    return normalize_images(videos, bg_mean, bg_sigma, part_mean + bg_mean)[0]
