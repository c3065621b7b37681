"""The port's real-data pipeline against the JAX package's, on the CPU:
the wide-field renderer, TIFF IO, detection, linking, tracking, patches, the
batched Levenberg-Marquardt Gaussian fit, refinement, the tracks table and
the per-track D estimate. The same inputs go to both sides: three movies
rendered by JAX's ``render_widefield`` from numpy trajectories, synthetic
patches with known parameters, and numpy draws. The JAX side is called as
``tests/test_realdata.py`` calls it."""

import csv
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from moleculardiffusion_mivit_tpu import realdata as jrd
from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.config import OpticsConfig as JOptics
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.ops.curve_fit import fit_gaussian_2d as j_fit
from moleculardiffusion_mivit_tpu.ops.curve_fit import levenberg_marquardt as j_lm
from moleculardiffusion_mivit_tpu.realdata.stats import compute_displacement as j_compute_displacement
from moleculardiffusion_mivit_tpu.sim import render_widefield as j_render_widefield
from moleculardiffusion_mivit_tpu_torch import realdata as trd
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig as TModelConfig
from moleculardiffusion_mivit_tpu_torch.config import OpticsConfig as TOptics
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer as TGeneral
from moleculardiffusion_mivit_tpu_torch.ops.curve_fit import fit_gaussian_2d as t_fit
from moleculardiffusion_mivit_tpu_torch.ops.curve_fit import gaussian_2d_problem
from moleculardiffusion_mivit_tpu_torch.ops.curve_fit import levenberg_marquardt as t_lm
from moleculardiffusion_mivit_tpu_torch.realdata.stats import compute_displacement as t_compute_displacement
from moleculardiffusion_mivit_tpu_torch.realdata.stats import track_columns
from moleculardiffusion_mivit_tpu_torch.sim.render import render_frames_core, render_widefield, widefield_subpositions
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax

FIELD, PATCH = 63, 9
OPTICS = dict(particle_intensity=(4000.0, 200.0), psf_division_factor=1.3, output_size=PATCH,
              background_intensity=(1000.0, 100.0), poisson_noise=100.0, trajectory_unit=-1)
TRACKING = dict(min_distance=5, max_linking_distance=8.0, min_track_length=5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op threads cost more than they give, and
    several test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trajectories(n_particles, n_frames, p, d_px, seed):
    """Particles on a coarse grid of the 63-px field (or uniform starts
    beyond four), Brownian sub-steps of variance 2·d/p."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.linspace(14, 49, 2), np.linspace(14, 49, 2)), -1).reshape(-1, 2)
    starts = grid[:n_particles] if n_particles <= 4 else rng.uniform(14, FIELD - 14, size=(n_particles, 2))
    steps = rng.normal(0, np.sqrt(2 * d_px / p), size=(n_particles, n_frames * p, 2))
    steps[:, 0] = 0
    return (starts[:, None, :] + np.cumsum(steps, axis=1)).astype(np.float32)


# (particles, frames, sub-positions a frame, D in px²/frame, seed): the
# JAX test's still movie, one of its seeds, and the demo's blurred movie
MOVIES = {"still4": (4, 14, 1, 0.25, 0), "still4_seed7": (4, 16, 1, 0.25, 7), "blur6": (6, 16, 10, 0.3, 0)}


@pytest.fixture(scope="module")
def movies():
    out = {}
    for name, (k, f, p, d, seed) in MOVIES.items():
        trajs = _trajectories(k, f, p, d, seed)
        out[name] = np.asarray(j_render_widefield(jax.random.key(seed), jnp.asarray(trajs), p, FIELD,
                                                  JOptics(**OPTICS)))
    return out


@pytest.fixture(scope="module")
def tracked(movies):
    """JAX's tracks, patches and refinement of each movie."""
    out = {}
    for name, movie in movies.items():
        tracks, detections, dog = jrd.track_particles(movie, **TRACKING)
        patches = jrd.extract_particle_patches(movie, tracks, PATCH)
        out[name] = dict(tracks=tracks, detections=detections, dog=dog, patches=patches,
                         refined=jrd.refine_localizations(tracks, patches, PATCH))
    return out


# --- render_widefield ---


@pytest.mark.parametrize("k,p", [(6, 10), (10, 10), (4, 1)])  # P = 60, 100 (sim-to-real's movie), 4
def test_render_widefield_noise_free_frames_match_jax(k, p):
    """Given the sub-positions of the same trajectories and the intensities
    JAX draws, the port's noise-free frames equal JAX's ``render_widefield``
    (background and shot noise off) at 1e-5 of the largest pixel: the
    layout (absolute pixels, no y-inversion, particle-major sub-positions)
    and the renderer agree."""
    trajs = _trajectories(k, 5, p, 0.3, seed=k + p)
    key = jax.random.key(k)
    quiet = dict(OPTICS, background_intensity=(0.0, 0.0), poisson_noise=-1)
    want = np.asarray(j_render_widefield(key, jnp.asarray(trajs), p, FIELD, JOptics(**quiet)))
    mean, std = OPTICS["particle_intensity"]
    drawn = mean / p + (std / p) * jax.random.normal(jax.random.split(key, 3)[0], (5, k * p), jnp.float32)
    x_hr, y_hr = widefield_subpositions(torch.from_numpy(trajs), p, FIELD, 5)
    assert x_hr.shape == (5, k * p)
    got = render_frames_core(x_hr, y_hr, torch.from_numpy(np.array(drawn)), TOptics(**OPTICS).gaussian_sigma_hr,
                             FIELD, 5).numpy()
    assert got.shape == want.shape == (5, FIELD, FIELD)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_render_widefield_batch_axis_renders_each_movie():
    """``(N, K, T, 2)`` renders N independent movies: without noise, each
    equals the movie rendered alone."""
    trajs = torch.from_numpy(np.stack([_trajectories(3, 4, 10, 0.3, seed=s) for s in (1, 2)]))
    optics = TOptics(**dict(OPTICS, particle_intensity=(4000.0, 0.0), background_intensity=(0.0, 0.0),
                            poisson_noise=-1))
    both = render_widefield(torch.Generator().manual_seed(0), trajs, 10, FIELD, optics)
    assert both.shape == (2, 4, FIELD, FIELD)
    for i in range(2):
        alone = render_widefield(torch.Generator().manual_seed(0), trajs[i], 10, FIELD, optics)
        np.testing.assert_allclose(both[i].numpy(), alone.numpy(), rtol=1e-6, atol=1e-3)
    with pytest.raises(ValueError, match="divisible"):
        render_widefield(torch.Generator(), trajs[:, :, :35], 10, FIELD, optics)


def test_render_widefield_noise_matches_jax_in_distribution():
    """With the particles' intensity at 0 a frame is the clipped background
    times ``Pois(k)/k``: the pixels' mean and variance of the port and of
    JAX agree within 5 standard errors, and the background's clip holds."""
    trajs = _trajectories(2, 60, 1, 0.3, seed=3)
    optics = dict(OPTICS, particle_intensity=(0.0, 0.0))
    want = np.asarray(j_render_widefield(jax.random.key(3), jnp.asarray(trajs), 1, FIELD, JOptics(**optics)))
    got = render_widefield(torch.Generator().manual_seed(3), torch.from_numpy(trajs), 1, FIELD,
                           TOptics(**optics)).numpy()
    a, b = got.astype(np.float64).ravel(), want.astype(np.float64).ravel()
    z_mean = (a.mean() - b.mean()) / np.sqrt(a.var() / a.size + b.var() / b.size)
    var_se = lambda v: ((v - v.mean()) ** 2).var() / v.size  # noqa: E731
    z_var = (a.var() - b.var()) / np.sqrt(var_se(a) + var_se(b))
    assert abs(z_mean) <= 5 and abs(z_var) <= 5, (z_mean, z_var)
    assert a.min() >= 0.0 and abs(a.mean() - 1000.0) < 5.0


# --- TIFF ---


def test_tiff_reads_what_the_jax_package_writes(tmp_path):
    stack = (np.random.default_rng(0).normal(size=(5, 63, 47)) * 1e3).astype(np.float32)
    jrd.write_tiff_stack(str(tmp_path / "j.tif"), stack)
    got = trd.read_tiff_stack(str(tmp_path / "j.tif"))
    assert got.dtype == np.float32 and np.array_equal(got, stack)


def test_tiff_jax_reads_what_the_port_writes(tmp_path):
    stack = (np.random.default_rng(1).normal(size=(4, 31, 63)) * 1e3).astype(np.float32)
    trd.write_tiff_stack(str(tmp_path / "t.tif"), stack)
    assert np.array_equal(jrd.read_tiff_stack(str(tmp_path / "t.tif")), stack)
    assert np.array_equal(trd.read_tiff_stack(str(tmp_path / "t.tif")), stack)


@pytest.mark.parametrize("dtype,rows", [(np.uint16, None), (np.uint8, None), (np.uint16, 7), (np.float32, 9)])
def test_tiff_reads_pil_stacks_exactly(tmp_path, dtype, rows):
    """Unsigned 16- and 8-bit pages that PIL wrote read back exactly, also
    when PIL cuts a page into several strips."""
    rng = np.random.default_rng(2)
    stack = (rng.integers(0, np.iinfo(dtype).max, size=(3, 40, 30)) if dtype != np.float32
             else rng.normal(size=(3, 40, 30))).astype(dtype)
    pages = [Image.fromarray(f) for f in stack]
    kw = {} if rows is None else {"tiffinfo": {278: rows}}  # RowsPerStrip
    pages[0].save(tmp_path / "p.tif", save_all=True, append_images=pages[1:], **kw)
    if rows is not None:
        with Image.open(tmp_path / "p.tif") as img:
            assert len(img.tag_v2[273]) > 1  # several strips a page
    got = trd.read_tiff_stack(str(tmp_path / "p.tif"))
    assert got.dtype == np.float32 and np.array_equal(got, stack.astype(np.float32))


def test_tiff_refuses_what_it_does_not_read(tmp_path):
    Image.fromarray(np.zeros((8, 8), np.uint16)).save(tmp_path / "lzw.tif", compression="tiff_lzw")
    with pytest.raises(ValueError, match="compress"):
        trd.read_tiff_stack(str(tmp_path / "lzw.tif"))
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "rgb.tif")
    with pytest.raises(ValueError, match="sample"):
        trd.read_tiff_stack(str(tmp_path / "rgb.tif"))
    (tmp_path / "not.tif").write_bytes(b"MM\x00*" + bytes(8))
    with pytest.raises(ValueError, match="little-endian"):
        trd.read_tiff_stack(str(tmp_path / "not.tif"))
    trd.write_tiff_stack(str(tmp_path / "loop.tif"), np.zeros((1, 4, 4), np.float32))
    data = bytearray((tmp_path / "loop.tif").read_bytes())
    data[-4:] = data[4:8]  # the last page points back at the first
    (tmp_path / "loop.tif").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="chain"):
        trd.read_tiff_stack(str(tmp_path / "loop.tif"))


# --- detection, linking, tracking, patches ---


@pytest.mark.parametrize("name", sorted(MOVIES))
def test_detection_matches_jax(movies, tracked, name):
    """The DoG at 1e-6 of its largest value, and the peak coordinates of
    every frame identical, for the stack and for one frame."""
    movie = movies[name]
    coords, dog = trd.detect_particles_stack(movie, min_distance=5, device="cpu")
    j_coords, j_dog = jrd.detect_particles_stack(movie, min_distance=5)
    assert np.abs(dog - j_dog).max() <= 1e-6 * np.abs(j_dog).max()
    assert len(coords) == len(j_coords) == len(movie)
    for c, jc in zip(coords, j_coords):
        assert c.dtype == jc.dtype and np.array_equal(c, jc)
    c0, dog0 = trd.detect_particles(movie[0], min_distance=5, device="cpu")
    assert np.array_equal(c0, jrd.detect_particles(movie[0], min_distance=5)[0]) and dog0.shape == (FIELD, FIELD)


def test_link_particles_matches_jax():
    rng = np.random.default_rng(4)
    cases = [(rng.uniform(0, 63, (n0, 2)), rng.uniform(0, 63, (n1, 2)), cut)
             for n0, n1, cut in ((5, 5, 15.0), (7, 4, 8.0), (3, 9, 20.0), (6, 6, 3.0))]
    cases += [(np.zeros((0, 2)), rng.uniform(0, 63, (3, 2)), 15.0), (rng.uniform(0, 63, (2, 2)), np.zeros((0, 2)), 5.0),
              (np.array([[10.0, 10.0], [30.0, 30.0], [50.0, 10.0]]), np.array([[131.0, 131.0], [111.0, 109.0]]), 5.0)]
    for c0, c1, cut in cases:
        assert trd.link_particles(c0, c1, cut) == jrd.link_particles(c0, c1, cut)


@pytest.mark.parametrize("name", sorted(MOVIES))
def test_tracking_matches_jax(movies, tracked, name):
    tracks, detections, dog = trd.track_particles(movies[name], device="cpu", **TRACKING)
    assert tracks == tracked[name]["tracks"] and len(tracks) >= 3
    assert detections == tracked[name]["detections"]
    assert set(trd.track_particles.seconds) == {"detect", "link"}


@pytest.mark.parametrize("name", sorted(MOVIES))
def test_patches_match_jax(movies, tracked, name):
    """Bitwise, at the tracks' positions and at positions on and past the
    borders (zero padding)."""
    tracks = dict(tracked[name]["tracks"])
    tracks[99] = [(0, 0.0, 0.0), (1, 62.4, 3.6), (2, 61.5, 62.5)]
    got = trd.extract_particle_patches(movies[name], tracks, PATCH)
    want = jrd.extract_particle_patches(movies[name], tracks, PATCH)
    assert got.keys() == want.keys()
    for t in want:
        assert got[t].dtype == np.float32 and np.array_equal(got[t], want[t])
    with pytest.raises(ValueError, match="odd"):
        trd.extract_particle_patches(movies[name], tracks, 8)


# --- the Levenberg-Marquardt fit and the refinement ---


def _fit_both(patches):
    j_params, j_cost = jax.jit(jax.vmap(j_fit))(jnp.asarray(patches))
    t_params, t_cost = t_fit(torch.from_numpy(patches))
    return np.asarray(j_params), np.asarray(j_cost), t_params.numpy(), t_cost.numpy()


def _accepted(params):
    """The fits ``refine_localizations`` keeps (finite, centre near the
    patch, sane width)."""
    _, x0, y0, sigma, _ = params.T
    return (np.isfinite(params).all(1) & (np.abs(x0 - 4) < 13) & (np.abs(y0 - 4) < 13) & (np.abs(sigma) <= 90))


def _assert_fits_agree(j_params, j_cost, t_params, t_cost):
    """x0, y0 within 1e-3 px; A, σ, offset within 1e-3 relative; the
    final cost within 1e-4 relative."""
    np.testing.assert_allclose(t_params[:, 1:3], j_params[:, 1:3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_params[:, [0, 3, 4]], j_params[:, [0, 3, 4]], rtol=1e-3)
    np.testing.assert_allclose(t_cost, j_cost, rtol=1e-4)


def test_fit_gaussian_2d_matches_jax_on_the_movies_patches(tracked):
    patches = np.concatenate([p for t in tracked.values() for p in t["patches"].values()])
    j_params, j_cost, t_params, t_cost = _fit_both(patches)
    assert len(patches) > 150 and _accepted(j_params).all() and _accepted(t_params).all()
    _assert_fits_agree(j_params, j_cost, t_params, t_cost)


def test_fit_gaussian_2d_matches_jax_on_synthetic_patches():
    """Patches of known parameters with noise. Where JAX's fit diverges
    (a narrow spot near a corner can send the LM path from the centre start
    far outside the patch: a fit ``refine_localizations`` rejects), the
    port's diverges too; the parameters are compared where JAX's fit is
    kept, and there they also recover the truth."""
    rng = np.random.default_rng(5)
    n = 120
    truth = np.stack([rng.uniform(500, 3000, n), rng.uniform(2.5, 5.5, n), rng.uniform(2.5, 5.5, n),
                      rng.uniform(0.8, 2.0, n), rng.uniform(800, 1200, n)], 1)
    yy, xx = np.mgrid[0:PATCH, 0:PATCH]
    amp, x0, y0, sg, off = (v[:, None, None] for v in truth.T)
    patches = off + amp * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * sg**2))
    patches = (patches + rng.normal(0, 30, patches.shape)).astype(np.float32)
    j_params, j_cost, t_params, t_cost = _fit_both(patches)
    keep = _accepted(j_params)
    assert np.array_equal(keep, _accepted(t_params)) and keep.sum() >= 0.95 * n
    _assert_fits_agree(j_params[keep], j_cost[keep], t_params[keep], t_cost[keep])
    assert np.abs(t_params[keep, 1:3] - truth[keep, 1:3]).max() < 0.2


def test_fit_gaussian_2d_on_a_flat_patch():
    """A flat patch: both fits drive A to 0 and the offset to the level with
    the centre kept and a cost of 0. σ is then free (the model does not
    depend on it at A = 0) and is not compared: JAX's own fit ends at
    σ ≈ 0.94 under ``vmap`` and ≈ 1.06 alone."""
    flat = np.full((1, PATCH, PATCH), 5.0, np.float32)
    j_params, j_cost, t_params, t_cost = _fit_both(flat)
    for params in (j_params, t_params):
        assert abs(params[0, 0]) <= 1e-3 * 5.0
    np.testing.assert_allclose(t_params[:, 1:3], j_params[:, 1:3], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t_params[:, 4], j_params[:, 4], rtol=1e-3)
    np.testing.assert_allclose(t_cost, j_cost, rtol=1e-4, atol=1e-9)


def test_gaussian_jacobian_matches_jacfwd():
    """The analytic Jacobian equals ``jax.jacfwd`` of JAX's residual (a copy
    of the one inside its ``fit_gaussian_2d``) at f32 grade."""
    rng = np.random.default_rng(6)
    patches = rng.uniform(900, 3000, size=(7, PATCH, PATCH)).astype(np.float32)
    params = np.stack([rng.uniform(500, 3000, 7), rng.uniform(2, 6, 7), rng.uniform(2, 6, 7),
                       rng.uniform(0.7, 2.5, 7), rng.uniform(800, 1200, 7)], 1).astype(np.float32)
    residual, jacobian, p0, lower, upper = gaussian_2d_problem(torch.from_numpy(patches))
    ys, xs = jnp.mgrid[0:PATCH, 0:PATCH]
    xs, ys = xs.astype(jnp.float32).ravel(), ys.astype(jnp.float32).ravel()

    def j_residual(p, target):
        amp, x0, y0, sigma, offset = p
        return offset + amp * jnp.exp(-(((xs - x0) ** 2 + (ys - y0) ** 2) / (2.0 * sigma**2))) - target

    want_j = np.asarray(jax.vmap(jax.jacfwd(j_residual))(jnp.asarray(params), jnp.asarray(patches.reshape(7, -1))))
    want_r = np.asarray(jax.vmap(j_residual)(jnp.asarray(params), jnp.asarray(patches.reshape(7, -1))))
    got_j = jacobian(torch.from_numpy(params)).numpy()
    assert got_j.shape == want_j.shape == (7, PATCH * PATCH, 5)
    for c in range(5):
        np.testing.assert_allclose(got_j[..., c], want_j[..., c], rtol=1e-5, atol=1e-5 * np.abs(want_j[..., c]).max())
    np.testing.assert_allclose(residual(torch.from_numpy(params)).numpy(), want_r, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(p0.numpy()[:, [0, 4]], np.stack([patches.max((1, 2)), patches.min((1, 2))], 1))
    assert lower.numpy()[3] == np.float32(1e-3) and np.isinf(upper.numpy()).all()


def test_levenberg_marquardt_matches_jax_with_bounds():
    """The solver on its own: a batch of exponential decays ``a·exp(-b·t) +
    c`` with ``b`` bounded to [0.05, 0.5] (some truths outside the box),
    each problem from its own start, against JAX's solver under ``vmap``,
    50 steps each. Where JAX's 50 steps have converged (its cost equals its
    cost after 300 within 1e-5 relative) the port lands on the same point.
    A problem whose optimum lies on a bound is still walking along it after
    50 steps (the projected step is slow there), at a rounding-dependent
    place on its path in both: there the port's iterate stays in the box
    and its cost is no lower than JAX's after 300 steps."""
    rng = np.random.default_rng(7)
    t = np.linspace(0, 10, 30).astype(np.float32)
    truth = np.stack([rng.uniform(1, 5, 16), rng.uniform(0.02, 0.8, 16), rng.uniform(-1, 1, 16)], 1)
    y = (truth[:, :1] * np.exp(-truth[:, 1:2] * t) + truth[:, 2:] + rng.normal(0, 0.02, (16, 30))).astype(np.float32)
    p0 = np.stack([np.full(16, 2.0), rng.uniform(0.1, 0.3, 16), np.zeros(16)], 1).astype(np.float32)
    lower, upper = np.array([-np.inf, 0.05, -np.inf], np.float32), np.array([np.inf, 0.5, np.inf], np.float32)

    def j_solve(iters):
        def one(yy, start):
            return j_lm(lambda p: p[0] * jnp.exp(-p[1] * t) + p[2] - yy, start, jnp.asarray(lower),
                        jnp.asarray(upper), num_iters=iters)
        return (np.asarray(v) for v in jax.vmap(one)(jnp.asarray(y), jnp.asarray(p0)))

    (j_p, j_c), (_, j_c300) = j_solve(50), j_solve(300)
    tt, ty = torch.from_numpy(t), torch.from_numpy(y)

    def residual(p):
        return p[:, :1] * torch.exp(-p[:, 1:2] * tt) + p[:, 2:] - ty

    def jacobian(p):
        e = torch.exp(-p[:, 1:2] * tt)
        return torch.stack([e, -p[:, :1] * tt * e, torch.ones_like(e)], -1)

    t_p, t_c = t_lm(residual, jacobian, torch.from_numpy(p0), torch.from_numpy(lower), torch.from_numpy(upper))
    t_p, t_c = t_p.numpy(), t_c.numpy()
    done = np.abs(j_c - j_c300) <= 1e-5 * j_c300
    assert done.sum() >= 8 and (t_p[~done, 1] == np.float32(0.5)).any()  # the others walk along a bound
    np.testing.assert_allclose(t_p[done], j_p[done], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_c[done], j_c[done], rtol=1e-4)
    assert (t_p[:, 1] >= np.float32(0.05)).all() and (t_p[:, 1] <= np.float32(0.5)).all()
    assert (t_c >= j_c300 * (1 - 1e-5)).all()


@pytest.mark.parametrize("name", sorted(MOVIES))
def test_refine_localizations_matches_jax(tracked, name):
    """The same fallback set, x/y within 1e-3 px, the PSF size within 1e-3
    relative and the max intensity equal; also with a patch that takes
    the fallback (a NaN pixel makes the fit non-finite)."""
    t = tracked[name]
    patches = {k: v.copy() for k, v in t["patches"].items()}
    patches[0][1, 4, 4] = np.nan
    want = jrd.refine_localizations(t["tracks"], patches, PATCH)
    got = trd.refine_localizations(t["tracks"], patches, PATCH, device="cpu")
    assert got.keys() == want.keys()
    fallback = {k for k, v in want.items() if v["psf_size"] == 10.0}
    assert fallback == {k for k, v in got.items() if v["psf_size"] == 10.0} and len(fallback) >= 1
    for k, w in want.items():
        assert abs(got[k]["x_refined"] - w["x_refined"]) <= 1e-3 and abs(got[k]["y_refined"] - w["y_refined"]) <= 1e-3
        assert abs(got[k]["psf_size"] - w["psf_size"]) <= 1e-3 * w["psf_size"]
        assert got[k]["max_intensity"] == w["max_intensity"] or np.isnan(w["max_intensity"])


# --- the tracks table and the pipeline ---


# the table's columns that come from the Gaussian fit, and their tolerance
# (absolute px or relative): the two f32 fits end where their f32 costs stop
# falling, which leaves σ up to ~5e-5 relative apart
FIT_COLUMNS = {"x_refined": (1e-3, 0), "y_refined": (1e-3, 0), "displacement": (2e-3, 0),
               "mean_displacement": (2e-3, 0), "psf_size": (0, 1e-3), "mean_psf_size": (0, 1e-3)}


def _assert_table_matches(got, want):
    """Index, columns and dtypes equal; every column that does not come from
    the fit at 1e-5 relative, the fit's columns at the fit's tolerance."""
    pd = pytest.importorskip("pandas")
    pd.testing.assert_index_equal(got.index, want.index)
    assert list(got.columns) == list(want.columns) and (got.dtypes == want.dtypes).all()
    for c in want.columns:
        atol, rtol = FIT_COLUMNS.get(c, (0, 1e-5))
        np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(), rtol=rtol, atol=atol, err_msg=c)


@pytest.mark.parametrize("name", sorted(MOVIES))
def test_tracks_dataframe_matches_jax(tracked, name):
    """The port's DataFrame against JAX's (``_assert_table_matches``); its
    numpy columns, from JAX's refinement, equal JAX's DataFrame at 1e-5;
    and ``compute_displacement`` on one frame equals JAX's."""
    pd = pytest.importorskip("pandas")
    t = tracked[name]
    want = jrd.tracks_to_dataframe(t["tracks"], t["patches"], PATCH)
    _assert_table_matches(trd.tracks_to_dataframe(t["tracks"], t["patches"], PATCH, device="cpu"), want)
    cols = track_columns(t["tracks"], t["refined"])
    assert list(cols)[2:] == list(want.columns)
    np.testing.assert_array_equal(cols["track_id"], want.index.get_level_values(0))
    np.testing.assert_array_equal(cols["frame"], want.index.get_level_values(1))
    for c in want.columns:
        np.testing.assert_allclose(cols[c], want[c].to_numpy(), rtol=1e-5, err_msg=c)
    base = want[["x_refined", "y_refined", "psf_size", "max_intensity"]].sample(frac=1.0, random_state=0)
    pd.testing.assert_frame_equal(t_compute_displacement(base), j_compute_displacement(base))


def test_analyze_microscopy_sequence_writes_what_jax_writes(movies, tmp_path):
    """The pickle holds the same tracks; the CSV parses to the same values
    (the port writes it with the ``csv`` module, JAX with pandas)."""
    movie = movies["blur6"]
    j_out = jrd.analyze_microscopy_sequence(movie, output_prefix=str(tmp_path / "j"), **TRACKING)
    t_out = trd.analyze_microscopy_sequence(movie, output_prefix=str(tmp_path / "t"), device="cpu", **TRACKING)
    assert t_out[0] == j_out[0] and t_out[1] == j_out[1]
    with open(tmp_path / "t_tracks.pkl", "rb") as f, open(tmp_path / "j_tracks.pkl", "rb") as g:
        assert pickle.load(f) == pickle.load(g)

    def rows(path):
        with open(path, newline="") as f:
            return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]

    assert rows(tmp_path / "t_detections.csv") == rows(tmp_path / "j_detections.csv") != []


def test_estimate_d_for_tracks_matches_jax_with_converted_weights(movies, tracked):
    """The demo's patch model (deep-ResNet embedding, learned positional
    embedding, full width), flax's initial weights carried across by
    ``torch_state_from_flax``: d_model at 1e-5
    relative, d_msd at 1e-6 relative, tracks grouped by length on both
    sides."""
    t, movie = tracked["blur6"], movies["blur6"]
    cfg = dict(use_pos_encoding=True, patch_size=PATCH)  # the demo's model, full width
    jmodel, tmodel = JGeneral(JModelConfig(**cfg), embedding="deep_resnet"), TGeneral(TModelConfig(**cfg),
                                                                                       embedding="deep_resnet")
    params, bstats = jax.jit(lambda k, x: j_init(jmodel, k, x))(jax.random.key(0), jnp.zeros((1, 16, PATCH, PATCH)))
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, bstats)))
    tmodel.eval()

    @jax.jit
    def j_predict(videos):
        with jax.default_matmul_precision("highest"):
            return jmodel.apply({"params": params, "batch_stats": bstats}, videos, train=False)

    def t_predict(videos):
        with torch.no_grad():
            return tmodel(videos)

    kw = dict(patch_size=PATCH, background_mean=1000.0, background_sigma=100.0, theoretical_max=5000.0,
              msd_calibration=0.375, refined_positions=t["refined"])
    want = jrd.estimate_d_for_tracks(t["tracks"], movie, j_predict, **kw)
    got = trd.estimate_d_for_tracks(t["tracks"], movie, t_predict, device="cpu", **kw)
    assert got.keys() == want.keys() and len({v["n_frames"] for v in want.values()}) >= 2
    for k, w in want.items():
        assert got[k]["n_frames"] == w["n_frames"]
        np.testing.assert_allclose(got[k]["d_model"], w["d_model"], rtol=1e-5)
        np.testing.assert_allclose(got[k]["d_msd"], w["d_msd"], rtol=1e-6)
    no_refine = {k: v for k, v in kw.items() if k != "refined_positions"}
    j_int = jrd.estimate_d_for_tracks(t["tracks"], movie, j_predict, min_frames=10, **no_refine)
    t_int = trd.estimate_d_for_tracks(t["tracks"], movie, t_predict, min_frames=10, device="cpu", **no_refine)
    assert t_int.keys() == j_int.keys()
    for k, w in j_int.items():
        np.testing.assert_allclose(t_int[k]["d_msd"], w["d_msd"], rtol=1e-6)


def test_full_pipeline_dataframe_matches_jax(movies):
    movie = movies["still4"]
    j_tracks, j_patches, j_df = jrd.pipeline.full_pipeline_dataframe(movie, **TRACKING)
    t_tracks, t_patches, t_df = trd.pipeline.full_pipeline_dataframe(movie, device="cpu", **TRACKING)
    assert t_tracks == j_tracks and all(np.array_equal(t_patches[k], j_patches[k]) for k in j_patches)
    _assert_table_matches(t_df, j_df)


def test_pipeline_entry_points_need_a_card_or_the_cpu(movies):
    """Without ``device`` the pipeline runs on the card: on a machine with
    no card it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trd.detect_particles_stack(movies["still4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trd.refine_localizations({0: [(0, 30.0, 30.0)]}, {0: np.zeros((1, PATCH, PATCH), np.float32)}, PATCH)
