"""K1, the frame renderer: CUDA kernel wrapper and its plain version.

Port of ``moleculardiffusion_mivit_tpu/ops/pallas_render.py``
(``pallas_render_frames``). ``render_frames`` launches ``csrc/render.cu``
on CUDA tensors and runs ``render_frames_reference`` on CPU tensors; on a
CUDA tensor it never falls back, it raises on what the kernel does not take.

The kernel's layout arithmetic is computed here, in Python, and passed to
the launch (``block_layout``, ``shared_memory_bytes``, ``grid_step``), so
the CPU tests reach it: ``tests/test_torch_render.py`` holds it against a
Python copy of the kernel's index arithmetic.

One launch also renders several PSF settings (the PSF x noise grid,
``sim.render.trajectories_to_video_psf_noise_grid``): with a sigma per
setting, the ``(B, P)`` frames are K equal runs, run k rendered with
``sigma[k]``; the kernel reads each frame's factor from a table of K.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch.sim.render import _pooled_gaussian_1d

# The kernel's limits, here and in csrc/render.cu: S up to 32 lanes x 3
# cells a lane (the generic instantiation's kCellsPerLane), S*u up to S's
# limit at u = 5 (every grid coordinate the tests hold), and the dynamic
# shared memory a Hopper block can have (above 48 KB the launch opts in).
MAX_OUTPUT = 32 * 3
MAX_GRID = MAX_OUTPUT * 5
WARPS_PER_BLOCK = 10  # kWarps in csrc/render.cu
MAX_SETTINGS = 8  # kMaxSettings in csrc/render.cu
_SMEM_LIMIT = 227 * 1024


def render_frames_reference(x_hr, y_hr, intensities, sigma_hr, output_size, upsampling_factor):
    """Plain PyTorch version of K1 (port of ``sim/render.py:_render_frames_xla``).

    ``x_hr, y_hr, intensities``: ``(..., P)``; ``sigma_hr`` scalar or
    broadcastable to ``(..., P)``. Returns ``(..., S, S)`` frames, rows = y.
    """
    px, mx = _pooled_gaussian_1d(x_hr, sigma_hr, output_size, upsampling_factor)
    py, my = _pooled_gaussian_1d(y_hr, sigma_hr, output_size, upsampling_factor)
    w = intensities / (mx * my)
    return torch.einsum("...ps,...pt->...st", py * w[..., None], px)


def block_layout(p: int, s: int) -> Tuple[int, int, int]:
    """``(lanes_per_segment, segments_per_warp, frames_per_block)`` of a K1
    block. A segment is the ``s`` pooled cells of one (frame, sub-position),
    on ``min(s, 32)`` neighbouring lanes of one warp; a block of
    ``WARPS_PER_BLOCK`` warps takes as many whole frames of ``p`` segments
    as fit its warps in one pass, and at least one."""
    lanes = min(s, 32)
    segments = 32 // lanes
    return lanes, segments, max(1, WARPS_PER_BLOCK * segments // p)


def shared_memory_bytes(p: int, s: int) -> int:
    """Dynamic shared memory of a K1 block: pooled x and y rows, f32."""
    return 4 * 2 * block_layout(p, s)[2] * p * s


def grid_step(grid: int) -> np.float32:
    """Spacing of ``linspace(-L, L, grid)``, ``L = (grid - 1) // 2``, in f32."""
    limit = (grid - 1) // 2
    return np.float32(2 * limit) / np.float32(grid - 1) if grid > 1 else np.float32(0.0)


def _exp2_factor(sigma: float) -> float:
    sig = np.float32(sigma)
    two_s2 = np.float32(np.float32(2.0) * sig) * sig  # the plain version's 2·σ·σ in f32
    return float(np.float32(-np.log2(np.e) / np.float64(two_s2)))


@functools.lru_cache(maxsize=64)
def _launch_constants(sigma, p: int, s: int, u: int):
    """``(frames_per_block, -log2(e)/(2 sigma^2), grid step)`` for a launch,
    after the checks that depend on the shape alone. The kernel takes a
    Gaussian as ``2 ** (d*d * factor)``. ``sigma`` is a float, or a tuple of
    one per PSF setting (its count checked by ``_kernel_sigma``), and then
    the factor is the tuple of theirs."""
    if not (1 <= s <= MAX_OUTPUT and 1 <= u and s * u <= MAX_GRID):
        raise ValueError(
            f"render_frames: S={s}, S*u={s * u} outside the kernel's S <= {MAX_OUTPUT}, S*u <= {MAX_GRID}"
        )
    if shared_memory_bytes(p, s) > _SMEM_LIMIT:
        raise ValueError(f"render_frames: P={p}, S={s}, u={u} needs more than 227 KB of shared memory")
    factor = tuple(_exp2_factor(v) for v in sigma) if isinstance(sigma, tuple) else _exp2_factor(sigma)
    return block_layout(p, s)[2], factor, float(grid_step(s * u))


def _lib():
    from moleculardiffusion_mivit_tpu_torch.ops._build import load_library

    lib = load_library("render")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.render_frames.argtypes = [p, p, p, p, i, i, i, i, i, f, f, p]
        lib.render_frames.restype = i
        lib.render_frames_settings.argtypes = [p, p, p, p, i, i, i, i, i, p, i, i, f, p]
        lib.render_frames_settings.restype = i
        lib.launch_noop.argtypes = [p]
        lib.launch_noop.restype = i
        lib._typed = True
    return lib


def _kernel_sigma(sigma_hr, b: int):
    """A float for one sigma, or a tuple for one per PSF setting (a tuple or
    list of K floats, 1 <= K <= ``MAX_SETTINGS``, K dividing the ``b``
    frames). A sigma tensor with axes (a per-frame or per-sub-position
    sigma) raises. Both devices check, so the plain version refuses what the
    kernel refuses."""
    if isinstance(sigma_hr, torch.Tensor):
        if sigma_hr.ndim != 0:
            raise ValueError(
                "render_frames: the CUDA kernel takes a scalar sigma or a tuple of one sigma per "
                f"PSF setting, got a tensor of shape {tuple(sigma_hr.shape)}"
            )
        return float(sigma_hr)
    if isinstance(sigma_hr, (tuple, list)):
        k = len(sigma_hr)
        if not 1 <= k <= MAX_SETTINGS:
            raise ValueError(f"render_frames: {k} PSF settings outside the kernel's 1..{MAX_SETTINGS}")
        if b % k != 0:
            raise ValueError(f"render_frames: {k} PSF settings do not divide B={b} frames into equal runs")
        return tuple(float(v) for v in sigma_hr)
    return float(sigma_hr)


def _check_input(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"render_frames: {name} must be on {like.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"render_frames: {name} must be float32, got {t.dtype}")
    if t.ndim != 2 or t.shape != like.shape:
        raise ValueError(f"render_frames: {name} must be (B, P) like x_hr, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"render_frames: {name} must be contiguous")


def render_frames(x_hr, y_hr, intensities, sigma_hr, output_size: int, upsampling_factor: int):
    """Render ``(B, P)`` sub-positions into ``(B, S, S)`` noise-free frames.

    ``sigma_hr`` is one sigma, or a tuple of K sigmas (one per PSF setting,
    K dividing B), and then frame ``b`` is rendered with
    ``sigma_hr[b // (B // K)]``. On CUDA tensors this launches K1
    (``csrc/render.cu``) once on the current stream, for all settings, and
    adds one to ``render_frames.launches``; on CPU tensors it returns
    ``render_frames_reference``. A call allocates the frames and launches
    one kernel: the grid coordinates are computed in the kernel.
    """
    if not x_hr.is_cuda:
        if isinstance(sigma_hr, (tuple, list)):
            sig = _kernel_sigma(sigma_hr, x_hr.shape[0])
            k, p = len(sig), x_hr.shape[1]
            runs = [t.reshape(k, -1, p) for t in (x_hr, y_hr, intensities)]
            sig = torch.tensor(sig, dtype=torch.float32).view(k, 1, 1)
            return render_frames_reference(*runs, sig, output_size, upsampling_factor).reshape(
                -1, output_size, output_size
            )
        return render_frames_reference(
            x_hr, y_hr, intensities, sigma_hr, output_size, upsampling_factor
        )
    _check_input("x_hr", x_hr, x_hr)
    _check_input("y_hr", y_hr, x_hr)
    _check_input("intensities", intensities, x_hr)
    s, u = int(output_size), int(upsampling_factor)
    b, p = x_hr.shape
    if b * max(p, s * s) >= 2 ** 31:
        raise ValueError(f"render_frames: B={b} frames are more than the kernel's 32-bit indices take")
    sigma = _kernel_sigma(sigma_hr, b)
    if b == 0 or p == 0:
        return torch.zeros((b, s, s), dtype=torch.float32, device=x_hr.device)
    frames, exp2_factor, step = _launch_constants(sigma, p, s, u)
    out = torch.empty((b, s, s), dtype=torch.float32, device=x_hr.device)
    stream = torch.cuda.current_stream(x_hr.device).cuda_stream
    if isinstance(sigma, tuple):
        table = (ctypes.c_float * len(exp2_factor))(*exp2_factor)
        err = _lib().render_frames_settings(
            x_hr.data_ptr(), y_hr.data_ptr(), intensities.data_ptr(), out.data_ptr(),
            b, p, s, u, frames, ctypes.cast(table, ctypes.c_void_p), len(sigma), b // len(sigma), step, stream,
        )
    else:
        err = _lib().render_frames(
            x_hr.data_ptr(), y_hr.data_ptr(), intensities.data_ptr(), out.data_ptr(),
            b, p, s, u, frames, exp2_factor, step, stream,
        )
    if err != 0:
        raise RuntimeError(f"render_frames: kernel launch failed (cudaError {err})")
    render_frames.launches += 1
    return out


render_frames.launches = 0


def launch_floor(out_shape, device) -> torch.Tensor:
    """One allocation of ``out_shape`` f32 and one launch of an empty kernel
    through the same binding as K1: the least any single-launch wrapper can
    cost on this card. A measurement aid; it adds to no launch count."""
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    err = _lib().launch_noop(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_floor: kernel launch failed (cudaError {err})")
    return out
