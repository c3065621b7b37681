"""K1, the frame renderer: CUDA kernel wrapper and its plain version.

Port of ``moleculardiffusion_mivit_tpu/ops/pallas_render.py``
(``pallas_render_frames``). ``render_frames`` launches ``csrc/render.cu``
on CUDA tensors and runs ``render_frames_reference`` on CPU tensors; on a
CUDA tensor it never falls back, it raises on what the kernel does not take.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch.sim.render import (
    _pooled_gaussian_1d,
    hr_grid_coords,
)

MAX_GRID = 13 * 5  # largest S*u the kernel takes (the Framerate patch)
_SMEM_LIMIT = 48 * 1024


def render_frames_reference(x_hr, y_hr, intensities, sigma_hr, output_size, upsampling_factor):
    """Plain PyTorch version of K1 (port of ``sim/render.py:_render_frames_xla``).

    ``x_hr, y_hr, intensities``: ``(..., P)``; ``sigma_hr`` scalar or
    broadcastable to ``(..., P)``. Returns ``(..., S, S)`` frames, rows = y.
    """
    px, mx = _pooled_gaussian_1d(x_hr, sigma_hr, output_size, upsampling_factor)
    py, my = _pooled_gaussian_1d(y_hr, sigma_hr, output_size, upsampling_factor)
    w = intensities / (mx * my)
    return torch.einsum("...ps,...pt->...st", py * w[..., None], px)


def _lib():
    from moleculardiffusion_mivit_tpu_torch.ops._build import load_library

    lib = load_library("render")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.render_frames.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        lib.render_frames.restype = i
        lib.render_frames_smem_bytes.argtypes = [i, i, i]
        lib.render_frames_smem_bytes.restype = i
        lib._typed = True
    return lib


def _scalar_sigma(sigma_hr) -> float:
    if isinstance(sigma_hr, torch.Tensor) and sigma_hr.ndim != 0:
        raise ValueError(
            "render_frames: the CUDA kernel takes a scalar sigma; a "
            "per-element sigma (the PSF-grid renderer) is not ported yet"
        )
    return float(sigma_hr)


def render_frames(x_hr, y_hr, intensities, sigma_hr, output_size: int, upsampling_factor: int):
    """Render ``(B, P)`` sub-positions into ``(B, S, S)`` noise-free frames.

    On CUDA tensors this launches K1 (``csrc/render.cu``) on the current
    stream and adds one to ``render_frames.launches``; on CPU tensors it
    returns ``render_frames_reference``.
    """
    if not x_hr.is_cuda:
        return render_frames_reference(
            x_hr, y_hr, intensities, sigma_hr, output_size, upsampling_factor
        )
    s, u = int(output_size), int(upsampling_factor)
    sigma = np.float32(_scalar_sigma(sigma_hr))
    for name, t in (("x_hr", x_hr), ("y_hr", y_hr), ("intensities", intensities)):
        if not t.is_cuda or t.device != x_hr.device:
            raise ValueError(f"render_frames: {name} must be on {x_hr.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"render_frames: {name} must be float32, got {t.dtype}")
        if t.ndim != 2 or t.shape != x_hr.shape:
            raise ValueError(f"render_frames: {name} must be (B, P) like x_hr, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"render_frames: {name} must be contiguous")
    b, p = x_hr.shape
    if s * u > MAX_GRID or s < 1 or u < 1:
        raise ValueError(f"render_frames: S*u={s * u} outside the kernel's 1..{MAX_GRID}")
    lib = _lib()
    if lib.render_frames_smem_bytes(p, s, u) > _SMEM_LIMIT:
        raise ValueError(f"render_frames: P={p}, S={s}, u={u} needs more than 48 KB of shared memory")
    out = torch.empty((b, s, s), dtype=torch.float32, device=x_hr.device)
    if b == 0:
        return out
    coords = hr_grid_coords(s, u, device=x_hr.device)
    two_s2 = float(np.float32(np.float32(2.0) * sigma) * sigma)
    stream = torch.cuda.current_stream(x_hr.device).cuda_stream
    err = lib.render_frames(
        x_hr.data_ptr(), y_hr.data_ptr(), intensities.data_ptr(), coords.data_ptr(),
        out.data_ptr(), b, p, s, u, two_s2, stream,
    )
    if err != 0:
        raise RuntimeError(f"render_frames: kernel launch failed (cudaError {err})")
    render_frames.launches += 1
    return out


render_frames.launches = 0
