"""The port's simulators and render preprocessing against the JAX package.

Deterministic functions get identical numpy inputs on both sides; samplers
(torch and JAX streams differ) are compared in distribution, at sample sizes
where the stated tolerances are several standard errors wide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu import sim as jsim
from moleculardiffusion_mivit_tpu.config import BASELINE_OPTICS as J_OPTICS
from moleculardiffusion_mivit_tpu.sim import render as jrender
from moleculardiffusion_mivit_tpu.sim import trajectory as jtraj
from moleculardiffusion_mivit_tpu_torch import sim as tsim
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS as T_OPTICS
from moleculardiffusion_mivit_tpu_torch.sim import render as trender
from moleculardiffusion_mivit_tpu_torch.sim import trajectory as ttraj


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_optics_copy_matches_jax_config():
    for name in ("gaussian_sigma_hr", "pixels_per_unit", "fwhm_psf"):
        assert getattr(T_OPTICS, name) == getattr(J_OPTICS, name)
    assert T_OPTICS == type(T_OPTICS)(**{f: getattr(J_OPTICS, f) for f in T_OPTICS.__dataclass_fields__})


@pytest.mark.parametrize("ds", [(1.0, 1.0), (7.0, 1.0), (3.0, 0.0)])
def test_single_state_d_and_step_moments_match_jax(ds):
    """D ~ N(mean, sigma) truncated at 0: mean, std and minimum of the drawn
    D, and the per-axis step variance 2·D, agree with the JAX sampler."""
    n, t = 4000, 20
    jt, jl = jtraj.single_state(jax.random.key(0), n, t, Ds=ds)
    tt, tl = ttraj.single_state(_gen(), n, t, Ds=ds)
    assert tt.shape == (n, t, 2) and tl.shape == (n, t, 3)
    jd, td = np.asarray(jl[:, 0, 1]), tl[:, 0, 1].numpy()
    assert td.min() >= 0.0
    np.testing.assert_allclose(td.mean(), jd.mean(), atol=0.05)
    np.testing.assert_allclose(td.std(), jd.std(), atol=0.05)
    # labels: alpha 1, D constant along the trajectory, state 0
    assert (tl[..., 0] == 1).all() and (tl[..., 2] == 0).all()
    assert (tl[..., 1] == tl[:, :1, 1]).all()
    # step variance / (2 D) is 1 on both sides
    for traj, d in ((np.asarray(jt), jd), (tt.numpy(), td)):
        steps = np.diff(traj, axis=1) / np.sqrt(2.0 * np.maximum(d, 1e-12))[:, None, None]
        np.testing.assert_allclose(steps[d > 0].var(), 1.0, atol=0.03)


def test_truncated_normal_far_tail_and_constant():
    """mean 7, sigma 1 truncated at 0 is N(7, 1) in practice; sigma 0 is
    the constant mean."""
    v = ttraj._truncated_normal_at_zero(_gen(1), 7.0, 1.0, (20000,))
    assert v.dtype == torch.float32 and v.min() >= 0
    np.testing.assert_allclose(float(v.mean()), 7.0, atol=0.03)
    np.testing.assert_allclose(float(v.std()), 1.0, atol=0.03)
    c = ttraj._truncated_normal_at_zero(_gen(1), 2.5, 0.0, (5,))
    assert (c == 2.5).all()


@pytest.mark.parametrize(
    "kwargs", [dict(alphas=0.5), dict(alphas=(1.0, 0.1)), dict(L=5.0), dict(drift=(0.1, 0.0))]
)
def test_single_state_off_brownian_raises(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttraj.single_state(_gen(), 4, 10, Ds=1.0, **kwargs)


def test_brownian_motion_and_frame_average():
    rng = np.random.default_rng(0)
    traj = rng.normal(size=(3, 40, 2)).astype(np.float32)
    got = ttraj.average_trajectories_frames(torch.from_numpy(traj), 10).numpy()
    want = np.asarray(jtraj.average_trajectories_frames(jnp.asarray(traj), 10))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    d = torch.tensor([0.5, 2.0])
    bm = ttraj.brownian_motion(_gen(2), 2, 500, 10, d, 10.0, start_at_zero=True)
    assert bm.shape == (2, 5000, 2) and (bm[:, 0] == 0).all()
    var = torch.diff(bm, dim=1).var(dim=(1, 2))
    np.testing.assert_allclose(var.numpy(), 2.0 * d.numpy(), rtol=0.05)


def test_prepare_subpositions_matches_jax():
    """Bit-exact without centering; with centering the per-frame mean is a
    float reduction whose order differs, so the result agrees to a few ulps
    of the uncentred positions."""
    rng = np.random.default_rng(1)
    traj = (rng.normal(size=(5, 60, 2)).cumsum(axis=1) * 0.02).astype(np.float32)
    for center in (False, True):
        jx, jy = jrender._prepare_subpositions(jnp.asarray(traj), 10, center, J_OPTICS)
        tx, ty = trender._prepare_subpositions(torch.from_numpy(traj), 10, center, T_OPTICS)
        for got, want in ((tx, jx), (ty, jy)):
            if center:
                scale = np.abs(traj).max() * J_OPTICS.pixels_per_unit * J_OPTICS.upsampling_factor
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 * scale)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="divisible"):
        trender._prepare_subpositions(torch.zeros(1, 15, 2), 10, True, T_OPTICS)


def test_normalize_images_matches_jax():
    """Bit-exact with the statistics the training path passes; statistics
    computed from the images are float reductions (order differs)."""
    rng = np.random.default_rng(2)
    im = rng.normal(1500.0, 300.0, size=(4, 3, 9, 9)).astype(np.float32)
    for clip in (False, True):
        jn, _ = jsim.normalize_images(jnp.asarray(im), 1420.0, 290.0, 6000.0, clip_image=clip)
        tn, stats = tsim.normalize_images(torch.from_numpy(im), 1420.0, 290.0, 6000.0, clip_image=clip)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert stats == (1420.0, 290.0, 6000.0)
    jn, jstats = jsim.normalize_images(jnp.asarray(im))
    tn, tstats = tsim.normalize_images(torch.from_numpy(im))
    np.testing.assert_allclose([float(v) for v in tstats], [float(v) for v in jstats], rtol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-5)


def test_background_and_poisson_distribution():
    """Clipped background: inside [0, mean + 3 std] with the JAX sampler's
    mean; Poisson multiplier: E[Pois(k)/k] = 1, Var = 1/k."""
    shape = (200, 30, 9, 9)
    tb = trender._clipped_background(_gen(3), shape, 1420.0, 290.0)
    jb = np.asarray(jrender._clipped_background(jax.random.key(3), shape, 1420.0, 290.0))
    assert float(tb.min()) >= 0.0 and float(tb.max()) <= 1420.0 + 3 * 290.0
    np.testing.assert_allclose(float(tb.mean()), jb.mean(), rtol=2e-3)
    np.testing.assert_allclose(float(tb.std()), jb.std(), rtol=5e-3)
    k = 100.0
    mult = trender._poisson(_gen(4), torch.full(shape, k)) / k
    np.testing.assert_allclose(float(mult.mean()), 1.0, atol=1e-3)
    np.testing.assert_allclose(float(mult.var()), 1.0 / k, rtol=0.02)


def test_trajectories_to_video_distribution_matches_jax():
    """Same trajectories, fresh noise on each side: per-pixel mean video and
    overall spread agree."""
    rng = np.random.default_rng(5)
    traj = (rng.normal(size=(64, 300, 2)).cumsum(axis=1) * np.sqrt(2.0) / 100.0).astype(np.float32)
    jv = np.asarray(jsim.trajectories_to_video(jax.random.key(5), jnp.asarray(traj), 10, True, J_OPTICS))
    tv = tsim.trajectories_to_video(_gen(5), torch.from_numpy(traj), 10, True, T_OPTICS).numpy()
    assert tv.shape == jv.shape == (64, 30, 9, 9)
    np.testing.assert_allclose(tv.mean(axis=(0, 1)), jv.mean(axis=(0, 1)), rtol=0.03)
    np.testing.assert_allclose(tv.std(), jv.std(), rtol=0.03)
