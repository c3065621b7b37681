"""The rest of the port's ``sim/`` against the JAX package: fGn, fBm,
reflection, ``single_state``'s fBm, drift and box branches, the constrained
geometries and the legacy renderer.

Deterministic parts get identical inputs on both sides: the fGn from JAX's
own two normal draws (``_fgn_from_normals``), the walks from the same
displacements, the legacy frames from the same trajectory. Samplers (torch
and JAX streams differ) are compared in distribution, at sizes where the
stated tolerances are several standard errors wide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu import sim as jsim
from moleculardiffusion_mivit_tpu.config import BASELINE_OPTICS as J_OPTICS
from moleculardiffusion_mivit_tpu.sim import constrained as jcon
from moleculardiffusion_mivit_tpu.sim import trajectory as jtraj
from moleculardiffusion_mivit_tpu_torch import sim as tsim
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS as T_OPTICS
from moleculardiffusion_mivit_tpu_torch.sim import constrained as tcon
from moleculardiffusion_mivit_tpu_torch.sim import trajectory as ttraj


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _msd_exponent(trajs, lags=(1, 2, 4, 8, 16, 32)):
    lags = np.asarray(lags)
    msd = [((trajs[:, lag:] - trajs[:, :-lag]) ** 2).sum(-1).mean() for lag in lags]
    return np.polyfit(np.log(lags), np.log(msd), 1)[0]


# --- fGn and fBm


@pytest.mark.parametrize("hurst", [0.25, 0.5, 0.85, 0.0, 1.0])
def test_fgn_from_jax_normals_matches_jax(hurst):
    """Given JAX's two normal draws (``kr, ki = split(key)``), the port's
    circulant embedding gives JAX's series to 1e-5 of the series' sd (two
    f32 FFTs). H = 0 and H = 1 are the α = 0 and α = 2 clip edges: a zero
    series (γ ≡ 0) and a fully correlated one (one non-zero eigenvalue)."""
    n, batch = 64, 8
    key = jax.random.key(7)
    want = np.asarray(jtraj.fractional_gaussian_noise(key, hurst, n, batch))
    kr, ki = jax.random.split(key)
    zr = jax.random.normal(kr, (batch, 2 * n), jnp.float32)
    zi = jax.random.normal(ki, (batch, 2 * n), jnp.float32)
    got = ttraj._fgn_from_normals(torch.full((batch,), hurst), _t(zr), _t(zi)).numpy()
    assert got.shape == (batch, n) and got.dtype == np.float32
    if hurst == 0.0:
        np.testing.assert_array_equal(got, 0.0)
        np.testing.assert_array_equal(want, 0.0)
        return
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.std())
    if hurst == 1.0:  # every step of a series equal
        np.testing.assert_allclose(got, got[:, :1].repeat(n, 1), atol=1e-5 * want.std())


@pytest.mark.parametrize("hurst", [0.3, 0.75])
def test_fgn_sampler_in_distribution(hurst):
    """Unit variance and the lag-1 autocorrelation 2^(2H−1) − 1 on both
    sides, from each side's own stream; a per-series Hurst vector too."""
    n, batch = 256, 64
    want_rho = 2 ** (2 * hurst - 1) - 1
    for x in (np.asarray(jtraj.fractional_gaussian_noise(jax.random.key(3), hurst, n, batch)),
              ttraj.fractional_gaussian_noise(_gen(3), hurst, n, batch).numpy()):
        assert x.shape == (batch, n)
        np.testing.assert_allclose(x.var(), 1.0, atol=0.08)
        rho = (x[:, 1:] * x[:, :-1]).mean() / x.var()
        np.testing.assert_allclose(rho, want_rho, atol=0.04)
    h = torch.tensor([0.3, 0.75]).repeat(32)
    x = ttraj.fractional_gaussian_noise(_gen(4), h, n, 64).numpy()
    rho = [(x[i::2, 1:] * x[i::2, :-1]).mean() / x[i::2].var() for i in (0, 1)]
    np.testing.assert_allclose(rho, [2 ** (2 * v - 1) - 1 for v in (0.3, 0.75)], atol=0.05)


def test_fbm_trajectories_step_scale_and_exponent_as_jax():
    """Per-axis step variance 2·D·dt and the MSD exponent α, both sides."""
    n, t, alpha, d = 128, 256, 0.6, 1.5
    for trajs in (np.asarray(jtraj.fbm_trajectories(jax.random.key(6), n, t, alpha, d, dt=2.0)),
                  ttraj.fbm_trajectories(_gen(6), n, t, alpha, d, dt=2.0).numpy()):
        assert trajs.shape == (n, t, 2)
        np.testing.assert_allclose(np.diff(trajs, axis=1).var(), 2 * d * 2.0, rtol=0.08)
        assert abs(_msd_exponent(trajs) - alpha) < 0.08


def test_reflect_into_box_equals_jax_exactly():
    """The triangle-wave fold, negative positions included, bitwise equal
    to JAX's (``torch.remainder`` takes the divisor's sign, as ``jnp.mod``)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 20, 4000), [-7.5, -5.0, -2.5, -1e-3, 0.0, 2.5, 5.0, 7.5, 1e4]]).astype(
        np.float32)
    for L in (2.5, 3.0, 0.7):
        want = np.asarray(jtraj.reflect_into_box(jnp.asarray(x), L))
        got = ttraj.reflect_into_box(_t(x), L).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0.0 and got.max() <= L
    # fmod would have folded -1e-3 to L - 1e-3 only by chance: the divisor's sign matters
    assert float(ttraj.reflect_into_box(torch.tensor([-1e-3]), 2.5)) == pytest.approx(1e-3, abs=1e-6)


# --- single_state's branches, in distribution


def test_single_state_alpha_labels_and_clipping_as_jax():
    """α ~ N(mean, sd) truncated at 0 and clipped to [0, 2]: the label's α
    column is the drawn α, constant along the trajectory, with JAX's mean,
    sd and share clipped at 2."""
    n, t = 2000, 8
    for a in ((0.5, 0.2), (1.8, 0.5)):
        _, jl = jtraj.single_state(jax.random.key(1), n, t, Ds=1.0, alphas=a)
        _, tl = ttraj.single_state(_gen(1), n, t, Ds=1.0, alphas=a)
        ja, ta = np.asarray(jl[:, 0, 0]), tl[:, 0, 0].numpy()
        assert ta.min() >= 0.0 and ta.max() <= 2.0
        assert (tl[..., 0] == tl[:, :1, 0]).all() and (tl[..., 2] == 0).all()
        np.testing.assert_allclose(ta.mean(), ja.mean(), atol=0.03)
        np.testing.assert_allclose(ta.std(), ja.std(), atol=0.03)
        np.testing.assert_allclose((ta == 2.0).mean(), (ja == 2.0).mean(), atol=0.04)
    _, tl = ttraj.single_state(_gen(1), 4, t, Ds=1.0, alphas=0.7)
    assert (tl[..., 0] == np.float32(0.7)).all()


@pytest.mark.parametrize("alpha", [0.5, 1.5])
def test_single_state_msd_exponent_as_jax(alpha):
    n, t = 128, 256
    jt, _ = jtraj.single_state(jax.random.key(2), n, t, Ds=(1.0, 0.0), alphas=alpha)
    tt, _ = ttraj.single_state(_gen(2), n, t, Ds=(1.0, 0.0), alphas=alpha)
    for trajs in (np.asarray(jt), tt.numpy()):
        assert abs(_msd_exponent(trajs) - alpha) < 0.1
        np.testing.assert_allclose(np.diff(trajs, axis=1).var(), 2.0, rtol=0.1)


@pytest.mark.parametrize("alphas", [1.0, (1.0, 0.3)])
def test_single_state_drift_loop_closure_as_jax(alphas):
    """Drift moves step i by drift·(i+1): the mean step is the drift and the
    drift-subtracted MSD(τ=1) recovers D, on both sides; on the fBm branch
    too."""
    v = (0.5, -0.3)
    for trajs, labels in (jtraj.single_state(jax.random.key(10), 200, 300, Ds=(2.0, 0.0), alphas=alphas, drift=v),
                          ttraj.single_state(_gen(10), 200, 300, Ds=(2.0, 0.0), alphas=alphas, drift=v)):
        trajs = np.asarray(trajs)
        disp = np.diff(trajs, axis=1)
        mean = disp.mean(axis=(0, 1))
        np.testing.assert_allclose(mean, v, atol=0.05)
        assert abs(((disp - mean) ** 2).sum(-1).mean() / 4.0 - 2.0) < 0.15
        np.testing.assert_allclose(np.asarray(labels)[:, :, 1], 2.0)


@pytest.mark.parametrize("alphas", [1.0, 0.6])
def test_single_state_box_as_jax(alphas):
    """L > 0: positions inside [0, L]², the late positions ~uniform (per-axis
    variance L²/12) on both sides; D labels unchanged."""
    L = 3.0
    for trajs, labels in (jtraj.single_state(jax.random.key(3), 256, 400, Ds=(1.0, 0.0), alphas=alphas, L=L),
                          ttraj.single_state(_gen(3), 256, 400, Ds=(1.0, 0.0), alphas=alphas, L=L)):
        trajs = np.asarray(trajs)
        assert trajs.min() >= 0.0 and trajs.max() <= L
        np.testing.assert_allclose(trajs[:, 200:].var(), L**2 / 12.0, rtol=0.12)
        np.testing.assert_allclose(np.asarray(labels)[:, :, 1], 1.0)


def test_pure_brownian_stream_is_unchanged():
    """The pure-Brownian branch draws D, then the steps, and nothing else:
    the same generator state reproduces it by hand."""
    trajs, labels = ttraj.single_state(_gen(5), 6, 20, Ds=(2.0, 0.5))
    g = _gen(5)
    ds = ttraj._truncated_normal_at_zero(g, 2.0, 0.5, (6,))
    steps = torch.randn((6, 20, 2), generator=g) * torch.sqrt(2.0 * ds)[:, None, None]
    assert torch.equal(trajs, torch.cumsum(steps, dim=1)) and torch.equal(labels[:, 0, 1], ds)
    assert (labels[..., 0] == 1).all()


# --- constrained geometries


def _geos():
    j = jcon.PiecewiseLinearGeometry([(0, 0), (3, 0), (3, 3), (6, 3)])
    t = tcon.PiecewiseLinearGeometry([(0, 0), (3, 0), (3, 3), (6, 3)])
    return j, t


def test_geometry_lookups_equal_jax():
    """Vertices, lengths, bounding box, position at distance (clamped at
    both ends), edge at length and edge at position, as JAX's."""
    j, t = _geos()
    np.testing.assert_array_equal(t.cum_lengths, j.cum_lengths)
    assert t.total_length == j.total_length == pytest.approx(9.0) and t.n_edges == j.n_edges == 3
    assert t.bounding_box == j.bounding_box
    d = np.array([-1.0, 0.0, 0.5, 3.0, 3.0001, 4.5, 6.0, 7.25, 9.0, 99.0], np.float32)
    np.testing.assert_array_equal(t.position_at_distance(_t(d)).numpy(), np.asarray(j.position_at_distance(d)))
    np.testing.assert_array_equal(t.position_at_distance(2.5).numpy(), np.asarray(j.position_at_distance(2.5)))
    for dist in (-0.1, 0.0, 2.0, 3.0, 8.9, 9.0, 9.1):
        (je, jr), (te, tr) = j.get_edge_at_length(dist), t.get_edge_at_length(dist)
        assert (je is None) == (te is None) and jr == tr
        if je is not None:
            np.testing.assert_array_equal(te.start_point, je.start_point)
    for pos in ((1.5, 0.0), (3.0, 0.0), (3.0, 1.0), (5.0, 3.0), (1.0, 1.0)):
        je, te = j.get_edge_at_position(pos), t.get_edge_at_position(pos)
        assert (je is None) == (te is None)
        if je is not None:
            np.testing.assert_array_equal(te.end_point, je.end_point)


def test_edges_and_from_edges_as_jax():
    e, je = tcon.Edge((0, 0), (3, 4)), jcon.Edge((0, 0), (3, 4))
    assert e.length == je.length == pytest.approx(5.0) and e.angle == je.angle
    np.testing.assert_array_equal(e.get_position_at_distance(2.5), je.get_position_at_distance(2.5))
    np.testing.assert_array_equal(e.get_position_at_distance(99), je.get_position_at_distance(99))
    assert e.distance_to_end((0, 0)) == je.distance_to_end((0, 0)) and repr(e) == repr(je)
    with pytest.raises(ValueError, match="zero-length"):
        tcon.Edge((1, 1), (1, 1))
    edges = [((0.0, 0.0), (80.0, 10.0)), ((80.0, 10.0), (130.0, 60.0)), ((130.0, 60.0), (210.0, 70.0))]
    g, jg = tcon.PiecewiseLinearGeometry.from_edges(edges), jcon.PiecewiseLinearGeometry.from_edges(edges)
    np.testing.assert_array_equal(g.vertices, jg.vertices)
    with pytest.raises(ValueError, match="chain breaks"):
        tcon.PiecewiseLinearGeometry.from_edges([((0, 0), (1, 0)), ((2, 0), (3, 0))])
    with pytest.raises(ValueError, match="at least one edge"):
        tcon.PiecewiseLinearGeometry.from_edges([])
    with pytest.raises(ValueError, match="2 \\(x, y\\)"):
        tcon.PiecewiseLinearGeometry([(0, 0)])


def test_map_displacements_equals_jax_given_the_same_displacements():
    """The clamped arclength walk and the lerp, exact to f32 (the same f32
    operations in the same order), batched and for one trajectory; the
    clamps at both ends are hit."""
    j, t = _geos()
    disp = np.random.default_rng(1).normal(0, 2.0, (5, 60)).astype(np.float32)
    disp[0, :5] = [20, -50, 3, 30, -1]
    for start in (0.0, 4.5, 50.0):
        want = np.asarray(j.map_displacements(jnp.asarray(disp), start))
        got = t.map_displacements(_t(disp), start).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.finfo(np.float32).eps * 9.0)
    one = t.map_displacements(_t(disp[1]))
    np.testing.assert_allclose(one.numpy(), np.asarray(j.map_displacements(jnp.asarray(disp[1]))), atol=4e-6)
    assert one.shape == (60, 2)


def test_simulate_equals_jax_given_jax_displacements_and_stays_on_the_path():
    """``simulate`` is ``disp_fbm`` then the walk: JAX's displacements
    through the port's walk give JAX's positions; the port's own draw stays
    on the path, with step variance 2·D (clamps aside)."""
    j, t = _geos()
    key = jax.random.key(0)
    want = np.asarray(j.simulate(key, 16, 200, D=0.5))
    disp = np.asarray(jcon.disp_fbm(key, 1.0, 0.5, 200, 1.0, 16))
    np.testing.assert_allclose(t.map_displacements(_t(disp)).numpy(), want, atol=1e-5)
    trajs = t.simulate(_gen(0), 16, 200, D=0.5).numpy()
    assert trajs.shape == (16, 200, 2)
    on_h1 = (np.abs(trajs[..., 1]) < 1e-4) & (trajs[..., 0] <= 3 + 1e-4)
    on_v = np.abs(trajs[..., 0] - 3) < 1e-4
    on_h2 = (np.abs(trajs[..., 1] - 3) < 1e-4) & (trajs[..., 0] >= 3 - 1e-4)
    assert np.all(on_h1 | on_v | on_h2)


def test_disp_fbm_scaling_as_jax():
    for d in (np.asarray(jcon.disp_fbm(jax.random.key(1), alpha=1.0, D=2.0, T=1024, batch=16)),
              tcon.disp_fbm(_gen(1), alpha=1.0, D=2.0, T=1024, batch=16).numpy()):
        assert d.shape == (16, 1024) and abs(d.var() - 4.0) / 4.0 < 0.1


@pytest.mark.parametrize("angle", [0.0, np.pi / 2, 0.3])
def test_reflected_walk_equals_jax_given_the_same_displacements(angle):
    """``reflected_rectangle_trajectories`` given JAX's two displacement
    draws (``kx, ky = split(key)``): the per-step reflection, rotation and
    shift give JAX's positions to a few f32 ulps of the box's scale."""
    key = jax.random.key(2)
    n, steps, center, size = 8, 300, (5.0, -2.0), (2.0, 1.0)
    want = np.asarray(jcon.reflected_rectangle_trajectories(key, n, steps, center, size, angle=angle, D=1.0))
    kx, ky = jax.random.split(key)
    dxy = np.stack([np.asarray(jcon.disp_fbm(k, 1.0, 1.0, steps, 1.0, n)) for k in (kx, ky)], axis=-1)
    got = tcon.reflected_walk(_t(dxy), center, size, angle).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reflected_rectangle_confinement_and_rotation():
    trajs = tcon.reflected_rectangle_trajectories(_gen(2), 8, 500, rect_center=(5.0, -2.0), rect_size=(2.0, 1.0),
                                                  D=1.0).numpy()
    assert trajs.shape == (8, 500, 2)
    assert trajs[..., 0].min() >= 4.0 - 1e-4 and trajs[..., 0].max() <= 6.0 + 1e-4
    assert trajs[..., 1].min() >= -2.5 - 1e-4 and trajs[..., 1].max() <= -1.5 + 1e-4
    assert np.ptp(trajs[..., 0]) > 1.5
    rot = tcon.reflected_rectangle_trajectories(_gen(3), 4, 300, (0.0, 0.0), (4.0, 1.0), angle=np.pi / 2).numpy()
    assert np.ptp(rot[..., 1]) > np.ptp(rot[..., 0]) and rot[..., 0].max() <= 0.5 + 1e-4


def test_geometry_draw_plots_every_edge():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, t = _geos()
    ax = t.draw(show_vertices=True)
    assert len(ax.lines) == t.n_edges and len(ax.collections) == 1
    plt.close("all")


# --- the legacy renderer and the one-call helper


def test_generate_images_legacy_matches_jax():
    """``frame_hr`` and ``frame_lr`` at 1e-5 relative given the same
    trajectory; the noisy frame's background ``clip(bg + N(0, σ²), 0, bg +
    3σ)`` in distribution."""
    rng = np.random.default_rng(3)
    traj = np.cumsum(rng.normal(0, 0.8, (20 * 5 + 7, 2)), axis=0).astype(np.float32)
    args = (20, 9, 5, 5, 200.0, 100.0, 50.0, 10.0, 4.0)
    jhr, jlr, jnoisy = (np.asarray(a) for a in jsim.render.generate_images_legacy(jax.random.key(0), traj, *args))
    thr, tlr, tnoisy = (a.numpy() for a in tsim.generate_images_legacy(_gen(0), _t(traj), *args))
    assert thr.shape == jhr.shape == (20, 45, 45) and tlr.shape == tnoisy.shape == (20, 9, 9)
    np.testing.assert_allclose(thr, jhr, rtol=0, atol=1e-5 * jhr.max())
    np.testing.assert_allclose(tlr, jlr, rtol=0, atol=1e-5 * jlr.max())
    jb, tb = (jnoisy - jlr).ravel(), (tnoisy - tlr).ravel()
    for b in (jb, tb):
        assert b.min() >= -1e-3 and b.max() <= 10.0 + 12.0 + 1e-3
    np.testing.assert_allclose(tb.mean(), jb.mean(), atol=0.6)
    np.testing.assert_allclose(tb.std(), jb.std(), atol=0.5)


def test_generate_traj_and_videos_brownian_as_jax():
    """Shapes, the D labels of ``single_state`` and the video statistics in
    distribution against JAX's helper."""
    jv, jd = jsim.generate_traj_and_videos_brownian(jax.random.key(0), (3.0, 1.0), 64, 6, 10, J_OPTICS)
    tv, td = tsim.generate_traj_and_videos_brownian(_gen(0), (3.0, 1.0), 64, 6, 10, T_OPTICS)
    assert tv.shape == jv.shape == (64, 6, 9, 9) and td.shape == jd.shape == (64,)
    assert td.min() >= 0 and abs(float(td.mean()) - float(np.asarray(jd).mean())) < 0.4
    jv, tv = np.asarray(jv), tv.numpy()
    np.testing.assert_allclose(tv.mean(), jv.mean(), rtol=0.03)
    np.testing.assert_allclose(tv[..., 4, 4].mean(), jv[..., 4, 4].mean(), rtol=0.05)


def test_sim_exports_jax_list_but_the_render_backend_switch():
    jax_names = {n for n in dir(jsim) if not n.startswith("_") and callable(getattr(jsim, n))}
    torch_names = {n for n in dir(tsim) if not n.startswith("_")}
    assert jax_names - torch_names == {"set_render_backend"}
