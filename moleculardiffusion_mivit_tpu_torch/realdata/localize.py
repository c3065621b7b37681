"""Sub-pixel localisation by symmetric 2-D Gaussian fitting.

Port of ``moleculardiffusion_mivit_tpu/realdata/localize.py`` (the
reference's ``add_refined_localization_to_dataframe``: a per-patch
``curve_fit`` of ``offset + A·exp(-((x-x0)²+(y-y0)²)/2σ²)`` from (max,
centre, centre, 1.0, min); on failure the integer position is kept with the
sentinel σ = 10).

All patches of all tracks go through one batched projected-LM fit
(``ops.curve_fit.fit_gaussian_2d``) on the device. A non-finite fit, a
centre far outside the patch or an absurd width counts as the reference's
failure and gives the sentinel.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.ops.curve_fit import fit_gaussian_2d

FALLBACK_SIGMA = 10.0


def refine_localizations(
    tracks: Dict[int, List[Tuple[int, float, float]]],
    patches: Dict[int, np.ndarray],
    patch_size: int,
    device=None,
):
    """Returns a dict keyed by ``(track_id, frame)`` with refined x/y, PSF
    sigma and max intensity: the quantities the reference adds as DataFrame
    columns. The fit runs on ``device`` (CUDA unless the caller passes
    another)."""
    half = patch_size // 2
    keys, all_patches, int_pos = [], [], []
    for track_id, positions in tracks.items():
        tp = patches[track_id]
        for i, (frame, y_int, x_int) in enumerate(positions):
            keys.append((track_id, int(frame)))
            all_patches.append(tp[i])
            int_pos.append((y_int, x_int))
    if not keys:
        return {}

    stacked = torch.as_tensor(np.stack(all_patches).astype(np.float32), device=resolve_device(device))
    params, _ = fit_gaussian_2d(stacked)
    params = params.cpu().numpy()
    amp, x0, y0, sigma, offset = params.T

    # Failure emulation: the reference's curve_fit raises when it cannot
    # converge; the LM always returns numbers, so non-finite or
    # out-of-patch centres and absurd widths count as failures.
    bad = (
        ~np.isfinite(params).all(axis=1)
        | (x0 < -patch_size)
        | (x0 > 2 * patch_size)
        | (y0 < -patch_size)
        | (y0 > 2 * patch_size)
        | (np.abs(sigma) > 10 * patch_size)
    )

    out = {}
    for k, (key, (y_int, x_int)) in enumerate(zip(keys, int_pos)):
        if bad[k]:
            out[key] = {
                "x_refined": float(x_int),
                "y_refined": float(y_int),
                "psf_size": FALLBACK_SIGMA,
                "max_intensity": float(np.max(all_patches[k])),
            }
        else:
            out[key] = {
                "x_refined": float(x_int - half + x0[k]),
                "y_refined": float(y_int - half + y0[k]),
                "psf_size": float(abs(sigma[k])),
                "max_intensity": float(np.max(all_patches[k])),
            }
    return out
