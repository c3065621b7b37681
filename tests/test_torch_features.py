"""The port's trajectory features against the JAX package on the CPU: the
convex hull area, the MSD power-law fit, the MSD estimators and the 25
features, on trajectories made from a seed with numpy, and the features
through ``generate_cycle_data``. Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.features import compute_diffusion_features as j_raw
from moleculardiffusion_mivit_tpu.features import compute_features_for_multiple_trajectories as j_features
from moleculardiffusion_mivit_tpu.features import msd as jmsd
from moleculardiffusion_mivit_tpu.ops.curve_fit import fit_power_law_msd as j_fit
from moleculardiffusion_mivit_tpu.ops.hull import convex_hull_area as j_hull
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
from moleculardiffusion_mivit_tpu_torch.features import FEATURE_NAMES, N_FEATURES
from moleculardiffusion_mivit_tpu_torch.features import compute_features_for_multiple_trajectories as t_features
from moleculardiffusion_mivit_tpu_torch.features import msd as tmsd
from moleculardiffusion_mivit_tpu_torch.features.features import PARITY_TOLERANCE
from moleculardiffusion_mivit_tpu_torch.ops import curve_fit as tcurve
from moleculardiffusion_mivit_tpu_torch.ops.hull import convex_hull_area as t_hull
from moleculardiffusion_mivit_tpu_torch.sim import average_trajectories_frames
from moleculardiffusion_mivit_tpu_torch.train import loop as tloop


def _brownian(seed, n, t):
    """``n`` Brownian trajectories of ``t`` points, D ~ U(0.01, 1) each."""
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(2 * rng.uniform(0.01, 1.0, size=(n, 1, 1)))
    return np.cumsum(rng.normal(size=(n, t, 2)) * sigma, axis=1).astype(np.float32)


def _point_sets(kind):
    rng = np.random.default_rng(7)
    if kind == "random":
        return (5 * rng.normal(size=(32, 30, 2))).astype(np.float32)
    if kind == "integer_grid":  # many collinear hull points and exact ties
        return rng.integers(0, 4, size=(32, 30, 2)).astype(np.float32)
    if kind == "collinear":  # exactly: integer points on y = 2x + 1, random points on y = 0.3
        s = rng.integers(-20, 20, size=(4, 30, 1))
        flat = np.concatenate([rng.normal(size=(4, 30, 1)), np.full((4, 30, 1), 0.3)], axis=2)
        return np.concatenate([np.concatenate([s, 2 * s + 1], axis=2), flat]).astype(np.float32)
    if kind == "coincident":
        return np.broadcast_to(rng.normal(size=(8, 1, 2)), (8, 30, 2)).astype(np.float32).copy()
    raise ValueError(kind)


def _tolerance(name, t):
    """``PARITY_TOLERANCE`` (stated for 30 frames), with α at atol 0.2 and D
    at rtol 3e-2 for trajectories of 20 frames or fewer, whose few lags
    (5 at 6 frames) leave the fit's cost flatter in α."""
    rtol, atol = PARITY_TOLERANCE[name]
    if t <= 20 and name == "alpha":
        atol = 0.2
    if t <= 20 and name == "diffusion_coefficient":
        rtol = 3e-2
    return rtol, atol


@pytest.mark.parametrize("kind", ["random", "integer_grid", "collinear", "coincident"])
def test_convex_hull_area_matches_jax(kind):
    """The batched gift wrap gives the JAX area at rtol 1e-6 (atol 1e-5 for
    sums of a few hundred): random sets, integer grids (collinear hull
    points), and degenerate sets, exactly collinear or coincident, which
    give 0. (Points only nearly collinear in f32 give rounding-driven areas
    on both sides, which are not compared.)"""
    pts = _point_sets(kind)
    want = np.asarray(jax.vmap(j_hull)(jnp.asarray(pts)))
    got = t_hull(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    if kind in ("collinear", "coincident"):
        assert (got == 0).all()
    else:
        assert (got > 0).all()


def test_alpha_grid_is_jax_linspace():
    """The fit's 96-point α grid is ``jnp.linspace(1e-5, 10, 96)`` to one
    float32 ulp (XLA rounds a few of its products differently)."""
    want = np.asarray(jnp.linspace(jnp.float32(1e-5), jnp.float32(10.0), 96))
    np.testing.assert_allclose(tcurve._alpha_grid(96, "cpu").numpy(), want, rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("t", [30, 6])
def test_fit_power_law_msd_matches_jax(t):
    """On the MSD curves of 64 Brownian trajectories (the features' input:
    lags 1..14 at 30 frames, 1..5 at 6): r² (the fit's quality) at atol 1e-5;
    α at atol 5e-3 (30 frames) or 0.2 (6 frames) and D at rtol 1e-2 or
    3e-2, because the cost is flat in α to within f32 rounding near its
    minimum and the golden-section steps branch on that noise; a row with a
    non-finite value gives four zeros, as in JAX."""
    trajs = _brownian(1, 64, t)
    n_lags = (t // 2 if t > 20 else t) - 1
    y = np.array(jmsd.mean_square_displacements(jnp.asarray(trajs)))[:, 1:n_lags + 1]
    y[3, 2] = np.nan
    want = np.stack(jax.vmap(j_fit)(jnp.asarray(y)))
    got = np.stack([v.numpy() for v in tcurve.fit_power_law_msd(torch.from_numpy(y))])
    assert (got[:, 3] == 0).all() and (want[:, 3] == 0).all()
    np.testing.assert_allclose(got[3], want[3], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=5e-3 if t == 30 else 0.2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2 if t == 30 else 3e-2)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-2, atol=1e-2 * np.abs(want[2]).max())


@pytest.mark.parametrize("t", [30, 6])
def test_features_match_jax(t):
    """The 25 features of 64 seeded Brownian trajectories of 30 frames (15
    MSD lags) and of 6 (every lag), against
    ``compute_features_for_multiple_trajectories`` of the JAX package, at
    ``_tolerance`` per feature (rtol 1e-5, atol 1e-6; the fit's α, D and
    trappedness looser, see there)."""
    trajs = _brownian(2, 64, t)
    want = np.asarray(j_features(jnp.asarray(trajs)))
    got = t_features(torch.from_numpy(trajs)).numpy()
    assert got.shape == (64, N_FEATURES) and N_FEATURES == 25
    for i, name in enumerate(FEATURE_NAMES):
        rtol, atol = _tolerance(name, t)
        np.testing.assert_allclose(got[:, i], want[:, i], rtol=rtol, atol=atol, err_msg=name)


def test_features_nan_and_degenerate_trajectories_match_jax():
    """Where the reference gives NaN or ±inf (a trajectory that never moves,
    one that moves on a line, one that revisits its start) the batch
    wrapper writes 0 on both sides; with sub-position averaging
    (``n_pos_per_frame=5``: 8 frames) too. Held at rtol 1e-5, atol 1e-5,
    the fit's features at ``_tolerance``."""
    rng = np.random.default_rng(3)
    line = np.cumsum(rng.normal(size=(40, 1)), axis=0)
    loop = np.concatenate([np.cumsum(rng.normal(size=(20, 2)), 0), np.zeros((20, 2))])
    trajs = np.stack([np.zeros((40, 2)), np.concatenate([line, -line], 1), loop, _brownian(4, 1, 40)[0]])
    trajs = trajs.astype(np.float32)
    for p in (1, 5):
        want = np.asarray(j_features(jnp.asarray(trajs), n_pos_per_frame=p))
        got = t_features(torch.from_numpy(trajs), n_pos_per_frame=p).numpy()
        raw = np.asarray(jax.vmap(j_raw)(jnp.asarray(average_trajectories_frames(torch.from_numpy(trajs), p))))
        assert np.isfinite(got).all() and not np.isfinite(raw).all()
        assert (got[~np.isfinite(raw)] == 0).all()
        for i, name in enumerate(FEATURE_NAMES):
            rtol, atol = _tolerance(name, 40 // p)
            np.testing.assert_allclose(got[:, i], want[:, i], rtol=max(rtol, 1e-5), atol=max(atol, 1e-5),
                                       err_msg=f"{name} p={p}")


def test_msd_functions_match_jax():
    """``mean_square_displacement(s)``, the four D estimators and
    ``d_from_msd_tau1`` equal the JAX functions at rtol 1e-5 (atol 1e-6)."""
    trajs = _brownian(5, 16, 20)
    j, t = jnp.asarray(trajs), torch.from_numpy(trajs)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)  # noqa: E731
    jm, tm = jmsd.mean_square_displacements(j), tmsd.mean_square_displacements(t)
    close(tm.numpy(), jm)
    close(tmsd.mean_square_displacement(t[3]).numpy(), jmsd.mean_square_displacement(j[3]))
    tr = np.arange(1, 21, dtype=np.float32)
    for name in ("estimate_d_from_msds", "estimate_d_from_msds_weighted", "estimate_d_from_msds_polyfit"):
        close(getattr(tmsd, name)(tm, torch.from_numpy(tr)).numpy(), getattr(jmsd, name)(jm, jnp.asarray(tr)))
    close(tmsd.estimate_d_from_msd(tm[2], torch.from_numpy(tr)).numpy(), jmsd.estimate_d_from_msd(jm[2], tr))
    close(tmsd.d_from_msd_tau1(t).numpy(), jmsd.d_from_msd_tau1(j))


def test_generate_cycle_data_with_features():
    """``with_features=True`` adds the 25 features of each sequence's
    frame-averaged trajectory, in the order of the videos, on the same
    draws (videos and labels equal the two-value call's)."""
    cfg = TrainConfig(sequences_per_d=16, n_frames=6)
    videos, labels = tloop.generate_cycle_data(torch.Generator().manual_seed(1), cfg, BASELINE_OPTICS)
    v2, l2, feats = tloop.generate_cycle_data(torch.Generator().manual_seed(1), cfg, BASELINE_OPTICS,
                                              with_features=True)
    assert torch.equal(videos, v2) and torch.equal(labels, l2)
    assert feats.shape == (64, N_FEATURES) and torch.isfinite(feats).all()
    assert (feats[:, FEATURE_NAMES.index("trajectory_length")] == 6).all()
    # the step statistics grow with the class's D (1, 3, 5, 7)
    mean_step = feats[:, FEATURE_NAMES.index("mean_step_length")].reshape(4, 16).mean(1)
    assert (mean_step.diff() > 0).all()
