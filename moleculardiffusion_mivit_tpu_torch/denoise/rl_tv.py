"""Richardson-Lucy deconvolution with total-variation regularisation.

Port of ``moleculardiffusion_mivit_tpu/denoise/rl_tv.py`` (the reference's
helpers/helpersGeneration.py:539-658): the FFT convolution, the TV
gradient, RL-TV on one frame and its iteration-snapshot variant, the
Gaussian PSF, the batched wrappers and the render → normalise → deconvolve
pipeline of the denoising experiment's seven-variant stack.

Every function here takes frames ``(..., H, W)`` with any leading axes and
runs them all at once: the JAX package vmaps a per-frame function over
``(batch, frame)``, the reference loops over both in Python. The
convolutions are zero-padded linear FFT products (``torch.fft``: cuFFT on a
card, as ``jnp.fft`` is XLA's own FFT; neither is a hand-written kernel).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig


def fft_convolve_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """2-D linear convolution of the last two axes, 'same' mode centred as
    ``scipy.signal.fftconvolve(x, k, mode='same')``: the full ``(h + kh −
    1, w + kw − 1)`` result cropped at ``((kh − 1)//2, (kw − 1)//2)``."""
    h, w = x.shape[-2:]
    kh, kw = k.shape[-2:]
    shape = (h + kh - 1, w + kw - 1)
    full = torch.fft.irfft2(torch.fft.rfft2(x, s=shape) * torch.fft.rfft2(k, s=shape), s=shape)
    sh, sw = (kh - 1) // 2, (kw - 1) // 2
    return full[..., sh:sh + h, sw:sw + w]


def tv_gradient(image: torch.Tensor) -> torch.Tensor:
    """Gradient of the smoothed total variation over the last two axes
    (helpersGeneration.py:542-555): forward differences with the last one
    0, normalised by ``sqrt(dx² + dy² + 1e-8)``, scattered back in the
    reference's order."""
    dx = torch.diff(image, dim=-1, append=image[..., :, -1:])
    dy = torch.diff(image, dim=-2, append=image[..., -1:, :])
    mag = torch.sqrt(dx * dx + dy * dy + 1e-8)
    dxn, dyn = dx / mag, dy / mag
    grad = torch.zeros_like(image)
    grad[..., :, :-1] -= dxn[..., :, :-1]
    grad[..., :, 1:] += dxn[..., :, :-1]
    grad[..., :-1, :] -= dyn[..., :-1, :]
    grad[..., 1:, :] += dyn[..., :-1, :]
    return grad


def _rl_tv_step(estimate, image, psf, psf_mirror, tv_weight: float) -> torch.Tensor:
    """One RL-TV step: the multiplicative RL update with the mirrored PSF,
    a TV gradient step, a clip to [0, 1]."""
    relative_blur = image / (fft_convolve_same(estimate, psf) + 1e-6)
    estimate = estimate * fft_convolve_same(relative_blur, psf_mirror)
    return torch.clamp(estimate - tv_weight * tv_gradient(estimate), 0.0, 1.0)


def _rl_tv_estimates(image, psf, n_steps: int, tv_weight: float):
    """The estimate after each of ``n_steps`` RL-TV steps of frames
    ``image`` (already clipped to ≥ 1e-6), from 0.5 everywhere."""
    psf = torch.as_tensor(psf, dtype=torch.float32, device=image.device)
    psf_mirror = psf.flip(-2, -1)
    estimate = torch.full_like(image, 0.5)
    for _ in range(n_steps):
        estimate = _rl_tv_step(estimate, image, psf, psf_mirror, tv_weight)
        yield estimate


def _clipped_image(image) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(image, dtype=torch.float32), min=1e-6)


def richardson_lucy_tv(image, psf, iterations: int = 20, tv_weight: float = 0.01) -> torch.Tensor:
    """RL-TV deconvolution of frames ``(..., H, W)`` (helpersGeneration.py:
    557-569): the estimate after ``iterations`` steps."""
    image = _clipped_image(image)
    estimate = torch.full_like(image, 0.5)
    for estimate in _rl_tv_estimates(image, psf, iterations, tv_weight):
        pass
    return estimate


def richardson_lucy_tv_iter_list(
    image, psf, iterations_list: Tuple[int, ...] = (2, 5, 10), tv_weight: float = 0.01
) -> torch.Tensor:
    """The snapshot variant (helpersGeneration.py:571-587): the estimates at
    the 0-based loop indices ``iterations_list`` (index ``i`` is the
    estimate after ``i + 1`` steps, as the reference's ``if i in
    iterations_list``), stacked first: ``(len(iterations_list), ..., H,
    W)``. Runs ``iterations_list[-1] + 1`` steps."""
    image = _clipped_image(image)
    steps = list(_rl_tv_estimates(image, psf, iterations_list[-1] + 1, tv_weight))
    return torch.stack([steps[i] for i in iterations_list])


def create_gaussian_psf(size: int = 9, sigma: float = 1.3) -> np.ndarray:
    """Normalised Gaussian PSF kernel, ``(size, size)`` f32, an even size
    made odd (helpersGeneration.py:591-598)."""
    if size % 2 == 0:
        size += 1
    ax = np.arange(-size // 2 + 1, size // 2 + 1)
    x, y = np.meshgrid(ax, ax)
    psf = np.exp(-(x**2 + y**2) / (2 * sigma**2))
    return (psf / psf.sum()).astype(np.float32)


def apply_rl_tv_batch(videos: torch.Tensor, psf, n_iters: int = 10, tv_weight: float = 0.01) -> torch.Tensor:
    """RL-TV of a video batch ``(B, T, H, W)`` (helpersGeneration.py:603-614)."""
    return richardson_lucy_tv(videos, psf, n_iters, tv_weight)


def apply_rl_tv_iter_list_batch(
    videos: torch.Tensor, psf, iterations_list: Tuple[int, ...] = (2, 5, 10), tv_weight: float = 0.01
) -> torch.Tensor:
    """The snapshot variant over a batch: ``(B, T, H, W)`` → ``(B,
    len(iterations_list), T, H, W)`` (helpersGeneration.py:616-630)."""
    return richardson_lucy_tv_iter_list(videos, psf, iterations_list, tv_weight).transpose(0, 1)


def trajs_to_vid_norm_rl(
    generator: torch.Generator,
    trajectories: torch.Tensor,
    n_pos_per_frame: int,
    center: bool,
    optics: OpticsConfig,
    rl_iterations: Tuple[int, ...] = (2, 5, 10),
    poisson_index: int = 2,
) -> torch.Tensor:
    """Render the four noise variants (``sim.trajectories_to_video_multiple_
    settings``), normalise them against ``(bg_mean, bg_sigma, part_mean +
    bg_mean)``, RL-TV-deconvolve the normalised Poisson variant with a
    sigma-1 9×9 PSF at the snapshot iterations, and concatenate: ``(N, 4 +
    len(rl_iterations), F, S, S)`` (helpersGeneration.py:635-658).
    ``generator`` lies on the trajectories' device."""
    from moleculardiffusion_mivit_tpu_torch.sim.render import (
        normalize_images,
        trajectories_to_video_multiple_settings,
    )

    bg_mean, bg_sigma = optics.background_intensity
    part_mean = optics.particle_intensity[0]
    variants = trajectories_to_video_multiple_settings(generator, trajectories, n_pos_per_frame, center, optics)
    videos, _ = normalize_images(torch.stack(variants, dim=1), bg_mean, bg_sigma, part_mean + bg_mean)
    rl = apply_rl_tv_iter_list_batch(videos[:, poisson_index], create_gaussian_psf(sigma=1.0), rl_iterations)
    return torch.cat([videos, rl], dim=1)
