"""Fluorescence video renderer.

Port of ``moleculardiffusion_mivit_tpu/sim/render.py``: the renderers the
experiments and the real-data pipeline use, the one-call helper
``generate_traj_and_videos_brownian`` and the legacy generator
``generate_images_legacy`` (plain torch on any device: in the JAX package
too it runs outside the Pallas kernel).
A frame before noise is ``Σ_p w_p · pool(g_y,p) ⊗ pool(g_x,p)``: the 2-D
Gaussian on the upsampled grid is an outer product of 1-D Gaussians, and
both the u×u mean pooling and the grid maximum factor over it, so only
``O(P·S·u)`` exponentials are needed per frame. ``render_frames_core``
sends CUDA tensors to kernel K1 (``ops/render.py``) and CPU tensors to its
plain version. Noise is drawn from an explicit ``torch.Generator`` on the
data's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.sim.trajectory import single_state


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
    sub-positions and intensities, with peak renormalisation. ``sigma_hr``
    is one sigma, or a tuple of K (one per PSF setting: the frames, flattened
    to ``(B, P)``, are K equal runs, run k rendered with ``sigma_hr[k]``).
    CUDA tensors go through kernel K1 (``ops/render.py``, one launch for all
    settings; a sigma tensor with axes raises); CPU tensors through its plain
    version, which also takes a sigma tensor broadcastable to ``(..., P)``."""
    from moleculardiffusion_mivit_tpu_torch.ops.render import (
        render_frames,
        render_frames_reference,
    )

    if not x_hr.is_cuda and not isinstance(sigma_hr, (tuple, list)):
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


def _clip_background(noise: torch.Tensor, bg_mean: float, bg_std: float) -> torch.Tensor:
    """``clip(mean + std·noise, 0, mean + 3 std)`` of standard normal ``noise``."""
    noise = noise * torch.tensor(bg_std, dtype=torch.float32)
    hi = torch.tensor(bg_mean + 3.0 * bg_std, dtype=torch.float32)
    return torch.clamp(torch.tensor(bg_mean, dtype=torch.float32) + noise, 0.0, float(hi))


def _clipped_background(generator: torch.Generator, shape, bg_mean: float, bg_std: float) -> torch.Tensor:
    """``clip(N(mean, std), 0, mean + 3 std)`` additive background."""
    return _clip_background(torch.randn(shape, generator=generator, device=generator.device), bg_mean, bg_std)


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
    return trajectories_to_videos([generator], trajectories, n_pos_per_frame, center, optics)[0]


def trajectories_to_videos(
    generators: Sequence[torch.Generator],
    trajectories: torch.Tensor,
    n_pos_per_frame: int,
    center: bool = False,
    optics: OpticsConfig = OpticsConfig(),
) -> torch.Tensor:
    """``trajectories_to_video`` of the same trajectories once per generator,
    ``(R, N, F, S, S)``: render ``r`` draws from ``generators[r]`` alone, as
    ``trajectories_to_video(generators[r], ...)`` does, and all R render in
    one call of the frame core (one K1 launch on the card)."""
    n, t, _ = trajectories.shape
    p = n_pos_per_frame
    n_frames = t // p
    r = len(generators)
    s, u = optics.output_size, optics.upsampling_factor
    part_mean, part_std = optics.particle_intensity
    bg_mean, bg_std = optics.background_intensity
    dev = trajectories.device

    x_hr, y_hr = _prepare_subpositions(trajectories, p, center, optics)
    if part_mean > 1e-4 and part_std > 1e-4:
        intensities = torch.stack([
            part_mean / p + (part_std / p) * torch.randn((n, n_frames, p), generator=g, device=dev)
            for g in generators
        ])
        frames = render_frames_core(x_hr.expand((r,) + x_hr.shape), y_hr.expand((r,) + y_hr.shape), intensities,
                                    optics.gaussian_sigma_hr, s, u)
    else:
        frames = torch.zeros((r, n, n_frames, s, s), dtype=torch.float32, device=dev)

    frames = frames + torch.stack([_clipped_background(g, frames.shape[1:], bg_mean, bg_std) for g in generators])
    if optics.poisson_noise != -1:
        k = float(optics.poisson_noise)
        lam = torch.full(frames.shape[1:], k, dtype=torch.float32, device=dev)
        frames = frames * torch.stack([_poisson(g, lam) / k for g in generators])
    return frames


def trajectories_to_video_blocks(
    generators: Sequence[torch.Generator],
    trajectories: torch.Tensor,
    n_pos_per_frame: int,
    center: bool = False,
    optics: OpticsConfig = OpticsConfig(),
) -> torch.Tensor:
    """``trajectories_to_video`` of ``len(generators)`` equal blocks of the
    rows, ``(N, F, S, S)``: block ``b`` draws from ``generators[b]`` alone,
    as ``trajectories_to_video(generators[b], block)`` does, and all blocks
    render in one call of the frame core (one K1 launch on the card), whose
    frames are each their own sub-positions'."""
    n, t, _ = trajectories.shape
    p = n_pos_per_frame
    n_frames, nb = t // p, n // len(generators)
    s, u = optics.output_size, optics.upsampling_factor
    part_mean, part_std = optics.particle_intensity
    bg_mean, bg_std = optics.background_intensity
    dev = trajectories.device

    x_hr, y_hr = _prepare_subpositions(trajectories, p, center, optics)
    if part_mean > 1e-4 and part_std > 1e-4:
        intensities = torch.cat([part_mean / p + (part_std / p) * torch.randn((nb, n_frames, p), generator=g,
                                                                              device=dev) for g in generators])
        frames = render_frames_core(x_hr, y_hr, intensities, optics.gaussian_sigma_hr, s, u)
    else:
        frames = torch.zeros((n, n_frames, s, s), dtype=torch.float32, device=dev)

    block = (nb,) + tuple(frames.shape[1:])
    frames = frames + torch.cat([_clipped_background(g, block, bg_mean, bg_std) for g in generators])
    if optics.poisson_noise != -1:
        k = float(optics.poisson_noise)
        lam = torch.full(block, k, dtype=torch.float32, device=dev)
        frames = frames * torch.cat([_poisson(g, lam) / k for g in generators])
    return frames


def trajectories_to_video_multiple_settings(
    generator: torch.Generator,
    trajectories: torch.Tensor,
    n_pos_per_frame: int,
    center: bool = False,
    optics: OpticsConfig = OpticsConfig(),
    filter_sigma: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Four aligned noise variants of each video (the denoising experiment),
    as the JAX package's: trajectories ``(N, T, 2)`` → ``(no_noise, gauss,
    poisson, filtered)``, each ``(N, T // n_pos_per_frame, S, S)`` float32,
    not normalised.

    - ``no_noise``: one intensity draw ``N(μ, σ)`` per *frame*, split evenly
      over its P sub-positions (``trajectories_to_video`` draws one per
      sub-position), rendered at ``optics``' sigma; zeros when μ or σ ≤ 1e-4.
    - ``gauss``: ``no_noise`` plus the clipped background.
    - ``poisson``: ``Pois(max(gauss, 0) · k) / k`` with ``k =
      optics.poisson_noise``.
    - ``filtered``: ``poisson`` blurred by ``gaussian_filter_2d`` at
      ``filter_sigma``.

    Streams, in the JAX key layout: intensities ``fold_in(g, 0)``,
    background ``fold_in(g, 1)``, shot noise ``fold_in(g, 2)``.
    ``generator`` lies on the trajectories' device."""
    from moleculardiffusion_mivit_tpu_torch.ops.filters import gaussian_filter_2d
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in

    n, t, _ = trajectories.shape
    p = n_pos_per_frame
    n_frames = t // p
    s, u = optics.output_size, optics.upsampling_factor
    part_mean, part_std = optics.particle_intensity
    bg_mean, bg_std = optics.background_intensity
    dev = trajectories.device

    x_hr, y_hr = _prepare_subpositions(trajectories, p, center, optics)
    if part_mean > 1e-4 and part_std > 1e-4:
        frame_intensity = part_mean + part_std * torch.randn((n, n_frames), generator=fold_in(generator, 0),
                                                             device=dev)
        intensities = (frame_intensity / p)[..., None].expand(n, n_frames, p)
        no_noise = render_frames_core(x_hr, y_hr, intensities, optics.gaussian_sigma_hr, s, u)
    else:
        no_noise = torch.zeros((n, n_frames, s, s), dtype=torch.float32, device=dev)

    gauss = no_noise + _clipped_background(fold_in(generator, 1), no_noise.shape, bg_mean, bg_std)
    k = torch.tensor(float(optics.poisson_noise), dtype=torch.float32)
    poisson = _poisson(fold_in(generator, 2), torch.clamp(gauss, min=0.0) * k) / k
    return no_noise, gauss, poisson, gaussian_filter_2d(poisson, filter_sigma)


def psf_sigmas(optics: OpticsConfig, psf_settings: Tuple[float, ...]) -> Tuple[float, ...]:
    """The PSF grid's sigma per setting (HR pixels, rounded to f32):
    ``optics``' sigma with ``psf_division_factor = 1``, divided by each
    setting (the reference recomputes the PSF width without the factor and
    divides per grid cell)."""
    base = optics.replace(psf_division_factor=1.0).gaussian_sigma_hr
    return tuple(float(np.float32(base / ps)) for ps in psf_settings)


def render_psf_stack(x_hr, y_hr, intensities, sigmas: Tuple[float, ...], output_size: int,
                     upsampling_factor: int) -> torch.Tensor:
    """Noise-free frames of every PSF setting, ``(K, ..., S, S)`` from
    ``(..., P)`` sub-positions and intensities shared by the settings and K
    ``sigmas``: one K1 launch for all settings on the card (a sigma per
    setting), the plain version on the CPU."""
    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames

    k, lead, p = len(sigmas), x_hr.shape[:-1], x_hr.shape[-1]
    flat = [v.reshape(1, -1, p).expand(k, -1, -1).reshape(-1, p).contiguous() for v in (x_hr, y_hr, intensities)]
    frames = render_frames(*flat, tuple(sigmas), output_size, upsampling_factor)
    return frames.reshape((k,) + tuple(lead) + (output_size, output_size))


def trajectories_to_video_psf_noise_grid(
    generator: torch.Generator,
    trajectories: torch.Tensor,
    n_pos_per_frame: int,
    center: bool = False,
    optics: OpticsConfig = OpticsConfig(),
    psf_settings: Tuple[float, ...] = (2.0, 1.75, 1.5, 1.25, 1.0),
    noise_settings: Tuple[float, ...] = (0.0, 1 / 50, 1 / 25, 1 / 20, 1 / 10, 1 / 5),
    members: Optional[slice] = None,
) -> torch.Tensor:
    """The PSF-size × noise-level grid (the published PSFNoise sweep), as
    the JAX package's: trajectories ``(N, T, 2)`` → ``(N, N_PSF, N_NOISE, F,
    S, S)`` float32, not normalised.

    - PSF setting ``i`` renders with ``psf_sigmas(optics, psf_settings)[i]``,
      all settings in one K1 launch on the card (``render_psf_stack``), from
      one per-frame intensity draw ``N(μ, σ)`` shared by the whole grid
      (``μ/P`` a sub-position).
    - Noise cascade, reproduced from the reference: arm 0 is
      ``Pois((clean + bg_mean)·k)/k``; arm ``j > 0`` adds a clipped
      background of std ``μ · noise_settings[j]`` to the *noised arm 0*,
      then draws shot noise ``Pois(·k)/k`` again.

    Streams: intensities ``fold_in(g, 0)``; PSF ``i``'s arm 0 shot noise
    ``fold_in(g, 2, i)``, its arm ``j``'s background ``fold_in(g, 1, j, i)``
    and shot noise ``fold_in(g, 3, j, i)``: each PSF setting draws from its
    own streams, so a part of the grid is exactly that part of the whole.
    ``members`` (a slice of the cells, cell (``i``, ``j``) = member ``i ·
    N_NOISE + j``): those cells alone, ``(N, n_members, F, S, S)`` in member
    order, each bitwise the whole grid's: K1 renders their PSF settings
    alone, and each such setting's arm 0 is drawn. ``generator`` lies on the
    trajectories' device."""
    from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in

    n, t, _ = trajectories.shape
    p = n_pos_per_frame
    n_frames = t // p
    s, u = optics.output_size, optics.upsampling_factor
    part_mean, part_std = optics.particle_intensity
    bg_mean = optics.background_intensity[0]
    n_psf, n_noise = len(psf_settings), len(noise_settings)
    cells = range(n_psf * n_noise)[members or slice(None)]
    psfs = sorted({m // n_noise for m in cells})
    dev = trajectories.device

    x_hr, y_hr = _prepare_subpositions(trajectories, p, center, optics)
    if part_mean > 1e-4 and part_std > 1e-4:
        g_int = fold_in(generator, 0)
        frame_intensity = part_mean + part_std * torch.randn((n, n_frames), generator=g_int, device=dev)
        intensities = (frame_intensity / p)[..., None].expand(n, n_frames, p)
        sigmas = psf_sigmas(optics, psf_settings)
        clean = render_psf_stack(x_hr, y_hr, intensities, tuple(sigmas[i] for i in psfs), s, u)
    else:
        clean = torch.zeros((len(psfs), n, n_frames, s, s), dtype=torch.float32, device=dev)

    k = torch.tensor(float(optics.poisson_noise), dtype=torch.float32)
    out = []
    for i, frames in zip(psfs, clean):
        arm0 = _poisson(fold_in(generator, 2, i), torch.clamp(frames + torch.tensor(bg_mean, dtype=torch.float32),
                                                               min=0.0) * k) / k
        for j in range(n_noise):
            if i * n_noise + j not in cells:
                continue
            if j == 0:
                out.append(arm0)
                continue
            noised = arm0 + _clipped_background(fold_in(generator, 1, j, i), arm0.shape, bg_mean,
                                                part_mean * noise_settings[j])
            out.append(_poisson(fold_in(generator, 3, j, i), torch.clamp(noised, min=0.0) * k) / k)
    grid = torch.stack(out, dim=1)
    return grid if members is not None else grid.reshape((n, n_psf, n_noise) + tuple(grid.shape[2:]))


def widefield_subpositions(
    trajectories_px: torch.Tensor, n_pos_per_frame: int, field_size: int, upsampling_factor: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute pixel positions ``(..., K, T, 2)`` (x, y; y = row, no
    inversion) → HR-grid sub-positions ``(x_hr, y_hr)``, each ``(..., F,
    K·p)``: the ``K`` particles of a frame side by side, particle-major,
    ``p = n_pos_per_frame`` sub-positions each. A pixel's centre maps to the
    centre of its ``u``-cell: ``pos·u + (u−1)/2 − L``."""
    *lead, k, t, _ = trajectories_px.shape
    p = n_pos_per_frame
    if t % p != 0:
        raise ValueError("T is not divisible by n_pos_per_frame")
    n_frames, u = t // p, upsampling_factor
    limit = (field_size * u - 1) // 2
    seg = trajectories_px.to(torch.float32).reshape(*lead, k, n_frames, p, 2)
    hr = seg * u + (u - 1) / 2.0 - limit

    def frame_major(v):  # (..., K, F, p) -> (..., F, K·p)
        return v.transpose(-3, -2).reshape(*lead, n_frames, k * p)

    return frame_major(hr[..., 0]), frame_major(hr[..., 1])


def render_widefield(
    generator: torch.Generator,
    trajectories_px: torch.Tensor,
    n_pos_per_frame: int = 1,
    field_size: int = 63,
    optics: OpticsConfig = OpticsConfig(),
) -> torch.Tensor:
    """Render several particles into one shared field of view, as the JAX
    package's: every particle's sub-positions of a frame go into that frame.
    ``trajectories_px (K, T, 2)`` absolute (x, y) pixel positions (rows =
    y) → ``(T // n_pos_per_frame, S, S)`` with ``S = field_size``; a leading
    batch axis of independent movies, ``(N, K, T, 2)`` → ``(N, F, S, S)``,
    renders all ``N·F`` frames in one K1 launch on the card.

    Each (frame, sub-position) draws its intensity ``mean/p + (std/p)·N``;
    then the clipped background is added and the frames are multiplied by
    ``Pois(k)/k`` (a fixed rate ``k = optics.poisson_noise``; -1 disables
    it). ``generator`` lies on the trajectories' device. It is the
    one-member ``render_widefield_panel``."""
    return render_widefield_panel(generator, trajectories_px, n_pos_per_frame, field_size, (optics,))


def _per_member(panel, fn, *tensors) -> torch.Tensor:
    """``fn(optics, *runs)`` on each member's equal run of the tensors'
    leading axis, concatenated (one member: ``fn(panel[0], *tensors)``)."""
    if len(panel) == 1:
        return fn(panel[0], *tensors)
    runs = zip(*(t.chunk(len(panel)) for t in tensors))
    return torch.cat([fn(o, *run) for o, run in zip(panel, runs)])


def render_widefield_panel(
    generator: torch.Generator,
    trajectories_px: torch.Tensor,
    n_pos_per_frame: int = 1,
    field_size: int = 63,
    panel: Tuple[OpticsConfig, ...] = (OpticsConfig(),),
) -> torch.Tensor:
    """``render_widefield`` over a panel of optics, as the JAX example
    ``sim2real_robustness.py`` renders its randomized arm (a ``jax.vmap`` of
    ``render_widefield`` per member): ``trajectories_px (N, K, T, 2)`` →
    ``(N, F, S, S)``, the N movies split into ``len(panel)`` equal runs,
    run m rendered with ``panel[m]``'s PSF sigma, intensity, clipped
    background and Poisson level (every member with shot noise, or none).
    All ``N·F`` frames render in one K1
    launch on the card, with a sigma per member (at most ``ops.render.
    MAX_SETTINGS``). Each draw (intensities, background, shot noise) is one
    call for the whole panel, so a one-member panel is ``render_widefield``
    draw for draw. ``generator`` lies on the trajectories' device."""
    if len({o.upsampling_factor for o in panel}) != 1:
        raise ValueError("render_widefield_panel: the panel's members differ in upsampling factor")
    if len({o.poisson_noise == -1 for o in panel}) != 1:
        raise ValueError("render_widefield_panel: the panel mixes members with and without shot noise")
    p, s, u = n_pos_per_frame, field_size, panel[0].upsampling_factor
    if len(panel) > 1 and (trajectories_px.ndim != 4 or trajectories_px.shape[0] % len(panel)):
        raise ValueError(f"render_widefield_panel: {len(panel)} members need (N, K, T, 2) trajectories with N a "
                         f"multiple of {len(panel)}, got {tuple(trajectories_px.shape)}")
    x_hr, y_hr = widefield_subpositions(trajectories_px, p, s, u)
    z = torch.randn(x_hr.shape, generator=generator, device=x_hr.device)
    intensities = _per_member(panel, lambda o, z: o.particle_intensity[0] / p + (o.particle_intensity[1] / p) * z, z)
    sigmas = tuple(o.gaussian_sigma_hr for o in panel)
    frames = render_frames_core(x_hr, y_hr, intensities, sigmas if len(set(sigmas)) > 1 else sigmas[0], s, u)
    z = torch.randn(frames.shape, generator=generator, device=frames.device)
    frames = frames + _per_member(panel, lambda o, z: _clip_background(z, *o.background_intensity), z)
    if panel[0].poisson_noise != -1:
        lam = _per_member(panel, lambda o, f: torch.full(f.shape, float(o.poisson_noise), dtype=torch.float32,
                                                         device=f.device), frames)
        frames = _per_member(panel, lambda o, f, c: f * c / float(o.poisson_noise), frames, _poisson(generator, lam))
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


def generate_images_legacy(
    generator: torch.Generator,
    trajectory: torch.Tensor,
    nframes: int,
    npixel: int,
    factor_hr: int,
    nposframe: int,
    fwhm_psf: float,
    pixelsize: float,
    flux: float,
    background: float,
    gaussian_noise: float,
):
    """The legacy image generator, as the JAX package's: one trajectory
    ``(≥ nframes·nposframe, 2)`` (HR-grid coordinates) → ``(frame_hr (F,
    S·u, S·u), frame_lr (F, S, S), frame_noisy (F, S, S))``. Unlike the main
    renderer: sigma = ``2.35·fwhm/pixel`` (the constant multiplies), a
    constant ``flux`` for every sub-position, no peak renormalisation, and
    only a clipped Gaussian background ``clip(background + N(0, σ²), 0,
    background + 3σ)`` (``σ = gaussian_noise``, drawn from ``generator`` on
    the trajectory's device)."""
    dev = trajectory.device
    seg = trajectory[: nframes * nposframe].to(torch.float32).reshape(nframes, nposframe, 2)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    sigma = f32(fwhm_psf) * 2.35 / f32(pixelsize)
    coords = hr_grid_coords(npixel, factor_hr, device=dev)
    gx = torch.exp(-((coords - seg[..., 0, None]) ** 2) / (2.0 * sigma**2))
    gy = torch.exp(-((coords - seg[..., 1, None]) ** 2) / (2.0 * sigma**2))
    frame_hr = torch.einsum("fps,fpt->fst", f32(flux) * gy, gx)
    frame_lr = frame_hr.reshape(nframes, npixel, factor_hr, npixel, factor_hr).mean(dim=(2, 4))
    noise = torch.randn(frame_lr.shape, generator=generator, device=dev) * f32(gaussian_noise)
    bg, sd = f32(background), f32(gaussian_noise)
    frame_noisy = frame_lr + torch.clamp(bg + noise, min=f32(0.0), max=bg + 3.0 * sd)
    return frame_hr, frame_lr, frame_noisy


def generate_traj_and_videos_brownian(
    generator: torch.Generator,
    Ds: Tuple[float, float],
    n_particles: int,
    n_images: int,
    n_pos_per_frame: int,
    optics: OpticsConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulate and render in one call, as the JAX package's: pure-Brownian
    ``single_state`` trajectories (in trajectory units, not divided) rendered
    with per-frame centering by ``trajectories_to_video`` (K1 on the card).
    Returns ``(videos (N, F, S, S), D labels (N,))``; both draws come from
    ``generator``, on its device."""
    trajs, labels = single_state(generator, n_particles, n_images * n_pos_per_frame, Ds, alphas=1)
    videos = trajectories_to_video(generator, trajs, n_pos_per_frame, True, optics)
    return videos, labels[:, 0, 1]


def render_videos(
    generator: torch.Generator, trajectories: torch.Tensor, train_cfg: TrainConfig, optics: OpticsConfig
) -> torch.Tensor:
    """Trajectories ``(N, T, 2)`` (already divided by ``traj_div_factor``) →
    the videos every experiment trains and validates on:
    ``trajectories_to_video`` with ``train_cfg``'s sub-positions per frame
    and centering, normalised against ``(bg_mean, bg_sigma, part_mean +
    bg_mean)``."""
    return render_videos_many([generator], trajectories, train_cfg, optics)[0]


def render_videos_blocks(
    generators: Sequence[torch.Generator], trajectories: torch.Tensor, train_cfg: TrainConfig, optics: OpticsConfig
) -> torch.Tensor:
    """``render_videos`` of equal blocks of the rows, block ``b`` from
    ``generators[b]`` alone, in one K1 launch (``trajectories_to_video_blocks``)."""
    bg_mean, bg_sigma = optics.background_intensity
    part_mean = optics.particle_intensity[0]
    videos = trajectories_to_video_blocks(generators, trajectories, train_cfg.n_pos_per_frame, train_cfg.center,
                                          optics)
    return normalize_images(videos, bg_mean, bg_sigma, part_mean + bg_mean)[0]


def render_videos_many(
    generators: Sequence[torch.Generator], trajectories: torch.Tensor, train_cfg: TrainConfig, optics: OpticsConfig
) -> torch.Tensor:
    """``render_videos`` of the same trajectories once per generator, ``(R,
    N, F, S, S)``, every render in one K1 launch (``trajectories_to_videos``)."""
    bg_mean, bg_sigma = optics.background_intensity
    part_mean = optics.particle_intensity[0]
    videos = trajectories_to_videos(generators, trajectories, train_cfg.n_pos_per_frame, train_cfg.center, optics)
    return normalize_images(videos, bg_mean, bg_sigma, part_mean + bg_mean)[0]
