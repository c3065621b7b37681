"""Particle detection: Difference-of-Gaussians and local-maximum peaks.

Port of ``moleculardiffusion_mivit_tpu/realdata/detect.py`` (the
reference's ``detect_particles``: DoG with σ1 = 1, σ2 = 2, an absolute
threshold of ``threshold_percentage · max(dog)`` per frame, and
``peak_local_max`` with a ``min_distance`` square footprint and
``exclude_border=False``).

The DoG (``ops.filters.difference_of_gaussians``) and the non-maximum
suppression (a ``(2·min_distance+1)²`` max-pool with −inf padding, tested
for equality) run over the whole stack at once on the device; only the
variable-length coordinate extraction runs on the host, as in JAX.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.ops.filters import difference_of_gaussians


def _dog_and_peak_mask(images: torch.Tensor, sigma1: float, sigma2: float, threshold_percentage: float,
                       min_distance: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, H, W) → (dog (F, H, W), peak mask (F, H, W)): a pixel is a peak
    iff it equals the maximum over its (2·min_distance+1)² neighbourhood and
    exceeds the fraction ``threshold_percentage`` of its frame's DoG
    maximum."""
    dog = difference_of_gaussians(images, sigma1, sigma2)
    k = 2 * min_distance + 1
    neighborhood_max = F.max_pool2d(dog[:, None], k, stride=1, padding=min_distance)[:, 0]
    frame_max = dog.amax(dim=(1, 2), keepdim=True)
    mask = (dog >= neighborhood_max) & (dog > threshold_percentage * frame_max)
    return dog, mask


def _mask_to_coords(mask_np: np.ndarray, dog_np: np.ndarray, min_distance: int) -> np.ndarray:
    """Extract (y, x) peak coordinates from a mask, resolving plateau ties
    (several equal-valued pixels within one footprint) by greedy suppression
    in descending intensity order, like peak_local_max."""
    ys, xs = np.nonzero(mask_np)
    if len(ys) == 0:
        return np.zeros((0, 2), np.int64)
    order = np.argsort(-dog_np[ys, xs])
    ys, xs = ys[order], xs[order]
    kept: List[Tuple[int, int]] = []
    for y, x in zip(ys, xs):
        if all(max(abs(y - ky), abs(x - kx)) > min_distance for ky, kx in kept):
            kept.append((int(y), int(x)))
    return np.asarray(kept, np.int64).reshape(-1, 2)


def detect_particles_stack(
    images: np.ndarray,
    sigma1: float = 1.0,
    sigma2: float = 2.0,
    threshold_percentage: float = 0.1,
    min_distance: int = 3,
    device=None,
):
    """Whole-stack detection in one pass on ``device`` (CUDA unless the
    caller passes another). Returns ``(coords_per_frame: list of (n_f, 2)
    arrays as (y, x), dog (F, H, W) numpy)``."""
    dev = resolve_device(device)
    stack = torch.tensor(np.asarray(images, np.float32), device=dev)
    dog, mask = _dog_and_peak_mask(stack, sigma1, sigma2, threshold_percentage, min_distance)
    dog_np, mask_np = dog.cpu().numpy(), mask.cpu().numpy()
    coords = [_mask_to_coords(mask_np[f], dog_np[f], min_distance) for f in range(len(mask_np))]
    return coords, dog_np


def detect_particles(
    image: np.ndarray,
    sigma1: float = 1.0,
    sigma2: float = 2.0,
    threshold_percentage: float = 0.1,
    min_distance: int = 3,
    device=None,
):
    """Single-frame detection. Returns ``(coords (n, 2) as (y, x), dog)``."""
    coords, dog = detect_particles_stack(
        np.asarray(image)[None], sigma1, sigma2, threshold_percentage, min_distance, device
    )
    return coords[0], dog[0]
