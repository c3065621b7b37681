"""Separable Gaussian image filters.

Port of ``moleculardiffusion_mivit_tpu/ops/filters.py``: the conventions of
``scipy.ndimage.gaussian_filter`` and ``skimage.filters.gaussian`` that the
reference calls (``truncate = 4``, 'nearest' edge-replicate boundaries,
separable 1-D correlations). Each axis is ``2r + 1`` shifted slices of the
edge-padded image, multiplied by their tap and summed in f32: no
convolution library call, so neither cuDNN's TF32 nor its algorithm choice
reaches the result on a card.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Normalised 1-D Gaussian taps of radius ``int(truncate·sigma + 0.5)``
    (scipy's convention, shared by skimage), f32."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _correlate_axis(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """``Σ_i taps[i] · x_padded[j + i]`` along ``dim``, edge-replicate
    padded by the taps' radius."""
    radius = (len(taps) - 1) // 2
    n = x.shape[dim]
    idx = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
    xp = x.index_select(dim, idx)
    out = None
    for i, w in enumerate(taps):
        term = xp.narrow(dim, i, n) * float(w)
        out = term if out is None else out + term
    return out


def gaussian_filter_2d(images: torch.Tensor, sigma: float, truncate: float = 4.0) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes, edge-replicate
    padded; leading axes are batch axes. Returns f32."""
    taps = gaussian_kernel_1d(sigma, truncate)
    x = images.to(torch.float32)
    return _correlate_axis(_correlate_axis(x, taps, -2), taps, -1)


def difference_of_gaussians(
    images: torch.Tensor, sigma1: float = 1.0, sigma2: float = 2.0, truncate: float = 4.0
) -> torch.Tensor:
    """Band-pass ``gaussian(im, sigma1) − gaussian(im, sigma2)`` (the
    reference's spot detector)."""
    return gaussian_filter_2d(images, sigma1, truncate) - gaussian_filter_2d(images, sigma2, truncate)
