"""Kernel K1 (the frame renderer) and its plain version against the JAX
package: ``render_frames_core`` on the CPU vs ``_render_frames_xla`` and vs
the Pallas kernel in interpret mode, on identical numpy inputs. The kernel
itself is held against its plain version on the card in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.ops.pallas_render import pallas_render_frames
from moleculardiffusion_mivit_tpu.sim.render import _render_frames_xla
from moleculardiffusion_mivit_tpu_torch.ops import render as trender_ops
from moleculardiffusion_mivit_tpu_torch.sim.render import hr_grid_coords, render_frames_core


def _inputs(b, p, seed):
    rng = np.random.default_rng(seed)
    x = (4.0 * rng.normal(size=(b, p))).astype(np.float32)
    y = (4.0 * rng.normal(size=(b, p))).astype(np.float32)
    w = (500.0 + rng.normal(size=(b, p))).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize(
    "b,p,s,u",
    [(19, 10, 9, 5), (8, 10, 13, 5), (16, 4, 10, 5)],  # flagship, Framerate, even grid
)
def test_render_core_matches_xla_and_pallas(b, p, s, u):
    x, y, w = _inputs(b, p, seed=s)
    sigma = 5.96
    got = render_frames_core(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), sigma, s, u).numpy()
    xla = np.asarray(_render_frames_xla(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), sigma, s, u))
    pallas = np.asarray(
        pallas_render_frames(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), sigma, s, u, interpret=True)
    )
    assert got.shape == (b, s, s)
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)


def test_render_core_leading_axes_and_broadcast_sigma():
    """The plain path keeps leading axes and takes a broadcastable sigma (the
    PSF-grid renderer's per-PSF axis), as the JAX XLA path does."""
    x, y, w = _inputs(6, 10, seed=1)
    xs, ys, ws = (v.reshape(2, 3, 10) for v in (x, y, w))
    sig = np.array([5.0, 6.0], np.float32)[:, None, None]
    got = render_frames_core(*(torch.from_numpy(v) for v in (xs, ys, ws)), torch.from_numpy(sig), 9, 5)
    want = _render_frames_xla(*(jnp.asarray(v) for v in (xs, ys, ws)), jnp.asarray(sig), 9, 5)
    assert got.shape == (2, 3, 9, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_render_frames_wrapper_on_cpu_is_the_plain_version():
    x, y, w = (torch.from_numpy(v) for v in _inputs(5, 10, seed=2))
    before = trender_ops.render_frames.launches
    got = trender_ops.render_frames(x, y, w, 5.96, 9, 5)
    want = trender_ops.render_frames_reference(x, y, w, 5.96, 9, 5)
    assert torch.equal(got, want)
    assert trender_ops.render_frames.launches == before


def test_hr_grid_coords_match_jax():
    from moleculardiffusion_mivit_tpu.sim.render import hr_grid_coords as j_coords

    for s, u in ((9, 5), (13, 5), (10, 5)):
        np.testing.assert_allclose(hr_grid_coords(s, u).numpy(), np.asarray(j_coords(s, u)), rtol=1e-6, atol=0)


# --- K1's index arithmetic and reciprocal arithmetic, emulated on the CPU ---
# (the kernel itself runs only on a card; its layout is computed in Python by
# the wrapper module, and these tests hold that Python against what the
# kernel needs.)


def thread_cells(tid: int, frames: int, p: int, s: int) -> list:
    """The ``(local frame, sub-position, cell)`` triples thread ``tid`` of a
    K1 block computes when the block holds ``frames`` frames (for both axes:
    the pooled x cell and the pooled y cell). Mirrors phase 1 of
    ``render_frames_kernel`` (``csrc/render.cu``) line by line."""
    lanes, segments, _ = trender_ops.block_layout(p, s)
    lane, warp = tid % 32, tid // 32
    sub, place = divmod(lane, lanes)
    cells = []
    for base in range(warp * segments, frames * p, trender_ops.WARPS_PER_BLOCK * segments):
        seg = base + sub
        if sub < segments and seg < frames * p:
            cells += [(seg // p, seg % p, c) for c in range(place, s, lanes)]
    return cells


def grid_coord_value(k: int, grid: int) -> np.float32:
    """Coordinate ``k`` of the upsampled grid as K1 computes it from the
    index (``grid_coord`` in ``csrc/render.cu``): the integer ``k - L`` when
    ``grid`` is odd, else one fused multiply-add from the nearer end, as
    PyTorch's CUDA ``linspace`` does. A product of an f32 and a small integer
    and its sum with a small integer are exact in f64, so rounding that once
    to f32 is the fused operation."""
    limit = (grid - 1) // 2
    if grid % 2:
        return np.float32(k - limit)
    step = np.float64(trender_ops.grid_step(grid))
    if k < grid // 2:
        return np.float32(step * k - limit)
    return np.float32(limit - step * (grid - 1 - k))


@pytest.mark.parametrize("parity", ["odd", "even"])
def test_kernel_grid_coords_match_hr_grid_coords(parity):
    """K1 derives a grid coordinate from its index. For every S*u in 1..480:
    at odd sizes it equals ``hr_grid_coords`` to the bit (the integers
    k - L); at even sizes to 2 ulp of the largest coordinate (one fused
    multiply-add from the nearer end, where ``linspace`` on the CPU rounds
    twice), which moves a Gaussian that matters to a frame (|d| <= 15) by
    less than 2e-6 of its value, inside K1's 1e-5 gate."""
    grids = [g for g in range(1, trender_ops.MAX_GRID + 1) if g % 2 == (parity == "odd")]
    assert len(grids) >= 32
    for grid in grids:
        s, u = next((grid // u, u) for u in (5, 4, 3, 2, 1) if grid % u == 0)
        want = hr_grid_coords(s, u).numpy()
        got = np.array([grid_coord_value(k, grid) for k in range(grid)], np.float32)
        assert got.dtype == want.dtype == np.float32
        if parity == "odd":
            np.testing.assert_array_equal(got, want, err_msg=f"grid {grid}")
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * np.spacing(np.float32(31)), err_msg=f"grid {grid}")
            np.testing.assert_array_equal(got, -got[::-1], err_msg=f"grid {grid} is not symmetric")


@pytest.mark.parametrize(
    "p,s,frames_expected",
    [(10, 9, 3), (10, 13, 2), (4, 10, 7), (1, 1, 320), (40, 9, 1), (3, 65, 3), (10, 33, 1), (7, 32, 1),
     (60, 63, 1), (100, 63, 1)],  # the last two: the wide-field movies
)
def test_kernel_block_layout_gives_every_cell_to_one_thread(p, s, frames_expected):
    """Over the 320 threads of a block, every (frame, sub-position, cell) of
    the block's frames is computed exactly once, for a full block and for
    the last, partial one; segments never straddle a warp; a lane holds at
    most the kernel's 3 cells of a segment; and the shared memory is what
    the pooled rows need (50,400 bytes at P = 100, S = 63: above 48 KB)."""
    lanes, segments, frames = trender_ops.block_layout(p, s)
    assert frames == frames_expected and lanes * segments <= 32 and lanes == min(s, 32)
    assert trender_ops.shared_memory_bytes(p, s) == 8 * frames * p * s
    threads = 32 * trender_ops.WARPS_PER_BLOCK
    for nf in {frames, 1}:
        seen = {}
        for tid in range(threads):
            for cell in thread_cells(tid, nf, p, s):
                assert cell not in seen, f"{cell} computed by threads {seen[cell]} and {tid}"
                seen[cell] = tid
        assert set(seen) == {(f, q, c) for f in range(nf) for q in range(p) for c in range(s)}
        assert all(len(thread_cells(t, nf, p, s)) <= 3 * len({c[:2] for c in thread_cells(t, nf, p, s)})
                   for t in range(threads))
        # the lanes of one segment lie in one warp (the peak is a warp shuffle)
        for f in range(nf):
            for q in range(p):
                assert len({seen[(f, q, c)] // 32 for c in range(s)}) == 1
    if frames > 1:  # one pass: no thread holds cells of two segments
        assert all(len({c[:2] for c in thread_cells(t, frames, p, s)}) <= 1 for t in range(threads))


def _render_as_kernel(x, y, w, sigma, s, u):
    """K1's arithmetic in numpy f32: coordinates from the index, a Gaussian
    as ``2 ** (d² · factor)`` with ``factor = -log2(e) / 2σ²`` taken once, the
    division by u as a multiplication by its reciprocal, the peak as the
    maximum over the grid, one division per (frame, p), the frame as a
    p-ordered sum of fused multiply-adds. (On the card the power of two and
    the division are 2-ulp approximations.)"""
    grid = s * u
    c = np.array([grid_coord_value(k, grid) for k in range(grid)], np.float32)
    _, factor, _ = trender_ops._launch_constants(float(sigma), x.shape[1], s, u)
    factor, inv_u = np.float32(factor), np.float32(1.0) / np.float32(u)

    def pooled(center):
        d = c - center[..., None]
        g = np.exp2((d * d) * factor, dtype=np.float32)
        return g.reshape(g.shape[:-1] + (s, u)).sum(-1, dtype=np.float32) * inv_u, g.max(-1)

    px, mx = pooled(x)
    py, my = pooled(y)
    py = py * (w / (mx * my))[..., None]
    out = np.zeros((x.shape[0], s, s), np.float64)
    for q in range(x.shape[1]):  # fmaf: the product is exact in f64, one rounding per term
        out = (py[:, q, :, None].astype(np.float64) * px[:, q, None, :] + out).astype(np.float32).astype(np.float64)
    return out.astype(np.float32)


@pytest.mark.parametrize(
    "b,p,s,u", [(64, 10, 9, 5), (32, 10, 13, 5), (16, 4, 10, 5), (5, 3, 65, 1), (4, 60, 63, 5), (2, 100, 63, 5)]
)
def test_kernel_arithmetic_stays_inside_the_gate(b, p, s, u):
    """What K1's pre-scaled power of two, its reciprocal of u and, at even
    grids, its own coordinates do against the plain version: the
    frames differ by at most 1e-5 of the largest pixel, the gate the kernel
    is held to on the card."""
    x, y, w = _inputs(b, p, seed=b + s)
    want = trender_ops.render_frames_reference(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), 5.96, s, u
    ).numpy()
    got = _render_as_kernel(x, y, w, 5.96, s, u)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_render_wrapper_shape_checks_need_no_card():
    """The checks that depend on the shape alone raise before any launch."""
    with pytest.raises(ValueError, match="S\\*u"):
        trender_ops._launch_constants(5.96, 10, 97, 5)
    with pytest.raises(ValueError, match="S\\*u"):
        trender_ops._launch_constants(5.96, 10, 63, 8)
    with pytest.raises(ValueError, match="shared memory"):
        trender_ops._launch_constants(5.96, 30000, 1, 1)
    assert trender_ops._launch_constants(5.96, 100, 63, 5)[0] == 1  # 50,400 bytes: the opt-in
    assert trender_ops.shared_memory_bytes(100, 63) == 50_400
    frames, factor, step = trender_ops._launch_constants(5.96, 10, 9, 5)
    assert frames == 3 and step == 1.0
    np.testing.assert_allclose(factor, -np.log2(np.e) / (2 * 5.96 ** 2), rtol=1e-6)
