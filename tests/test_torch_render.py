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
