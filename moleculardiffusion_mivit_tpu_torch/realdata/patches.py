"""Patch extraction around tracked particle positions.

Port of ``moleculardiffusion_mivit_tpu/realdata/patches.py`` (the
reference's ``extract_particle_patches``): odd square patches centred on
the rounded track position, zero-padded at the image borders. Numpy on the
host.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def extract_particle_patches(
    image_3d: np.ndarray, tracks: Dict[int, List[Tuple[int, float, float]]], patch_size: int = 7
) -> Dict[int, np.ndarray]:
    """Returns track_id → (n_positions, patch_size, patch_size) float32."""
    if patch_size % 2 != 1:
        raise ValueError("patch_size must be an odd number")
    half = patch_size // 2
    stack = np.asarray(image_3d, np.float32)
    padded = np.pad(stack, ((0, 0), (half, half), (half, half)), mode="constant")

    patches: Dict[int, np.ndarray] = {}
    for track_id, positions in tracks.items():
        track_patches = []
        for frame, y, x in positions:
            yi, xi = int(round(y)) + half, int(round(x)) + half
            track_patches.append(
                padded[int(frame), yi - half: yi + half + 1, xi - half: xi + half + 1]
            )
        patches[track_id] = np.stack(track_patches)
    return patches
