"""The port's denoising experiment against the JAX package on the CPU: the
separable Gaussian filters, the FFT convolution, the TV gradient, RL-TV
deconvolution and its snapshots, the four-variant renderer, the seven-variant
stack, the experiment's arms and slices, and the experiment through its entry
points at tiny sizes (2 sequences per D class of 6 frames, one-layer
transformers at embed 8, a 3-particle validation suite). Inputs are made from
a seed with numpy, or rendered by the port at the experiment's optics from
seeded generators; tolerances are stated per test.

RL-TV is ill-conditioned in f32 where an estimate is flat: the TV step
divides a difference by ``sqrt(dx² + dy² + 1e-8)``, so next to a plateau
(the estimate clipped at 1 in a spot's centre) it can amplify a rounding
difference of the FFT convolution by up to ``tv_weight / sqrt(1e-8) = 100``
a step: a few ulps of 1 become up to 5e-5. One step of the port from JAX's
own estimate agrees with JAX's step to that bound (measured ≤ 4.6e-6). Over
6 and 11 steps the amplification compounds at a few pixels, and the port
drifts from JAX as far as JAX drifts from itself when its input moves by one
ulp (over four classes of 1,920 frames: 0.05-0.12 % of the pixels beyond
1e-4 and a largest gap of 0.017-0.023 port against JAX; 0.03-0.10 % and
0.007-0.031 JAX against JAX one ulp up or down); the rest agree at 1e-4."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.denoise import rl_tv as jrl
from moleculardiffusion_mivit_tpu.experiments import REGISTRY as JREGISTRY
from moleculardiffusion_mivit_tpu.experiments import denoising as jden
from moleculardiffusion_mivit_tpu.ops import filters as jfilters
from moleculardiffusion_mivit_tpu.sim import normalize_images as j_normalize_images
from moleculardiffusion_mivit_tpu.sim.render import _poisson as j_poisson
from moleculardiffusion_mivit_tpu.sim.render import render_frames_core as j_render_frames_core
from moleculardiffusion_mivit_tpu.sim.render import (
    trajectories_to_video_multiple_settings as j_multiple_settings,
)
from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.denoise import rl_tv as trl
from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, denoising, get_experiment
from moleculardiffusion_mivit_tpu_torch.ops import filters as tfilters
from moleculardiffusion_mivit_tpu_torch.sim import render as trender
from moleculardiffusion_mivit_tpu_torch.sim import single_state
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in

OPTICS = denoising.DENOISING_OPTICS
PSF = trl.create_gaussian_psf(sigma=1.0)
NAMES = [f"{k}_{s}" for k in ("trans", "resnet") for s in denoising.SETTINGS]
TINY_MODEL = ModelConfig(use_pos_encoding=False, embed_dim=8, num_heads=2, hidden_dim=16, num_layers=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op threads cost more than they give, and
    several test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rendered():
    """64 sequences of 300 steps at D = 5 (the port's simulator, seed 0),
    the four variants at the denoising optics (render stream seed 1), and
    the seven-variant stack of the same stream."""
    trajs, _ = single_state(torch.Generator().manual_seed(0), 64, 300, Ds=(5.0, 1.0))
    trajs = trajs / 100.0
    variants = trender.trajectories_to_video_multiple_settings(torch.Generator().manual_seed(1), trajs, 10, True,
                                                               OPTICS)
    stack = trl.trajs_to_vid_norm_rl(torch.Generator().manual_seed(1), trajs, 10, True, OPTICS)
    return trajs, variants, stack


@pytest.fixture
def small_denoising(monkeypatch):
    """Validation of 3 particles per D (D = 1 and 5) and tiny transformers
    (embed 8, 2 heads, FFN 16, one layer; the positional embedding kept)."""
    def load(length, device):
        return tval.generate_frozen_validation(d_values=(1, 5), n_particles=3, t_steps=10 * length,
                                               in_order_particles=1, device=device)

    monkeypatch.setattr(denoising, "load_validation_trajectories", load)
    monkeypatch.setattr(denoising, "ModelConfig", lambda **kw: TINY_MODEL.replace(**kw))


def _build(**kw):
    return denoising.build(sequences_per_d=2, val_length=6, val_d_values=(1.0, 5.0), device="cpu", **kw)


@pytest.mark.parametrize("s", [9, 13])
@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.0])
def test_gaussian_filter_and_dog_match_jax(sigma, s):
    """``gaussian_filter_2d`` (two leading batch axes) and
    ``difference_of_gaussians`` equal JAX's at 1e-6 × max|input| (measured
    ≤ 3.1e-7 and 4.3e-7), on 9×9 and 13×13 frames of a background-like
    level; the taps are JAX's exactly."""
    x = (1420.0 + 290.0 * np.random.default_rng(int(10 * sigma) + s).normal(size=(3, 4, s, s))).astype(np.float32)
    tol = 1e-6 * np.abs(x).max()
    np.testing.assert_array_equal(tfilters.gaussian_kernel_1d(sigma), jfilters.gaussian_kernel_1d(sigma))
    got = tfilters.gaussian_filter_2d(torch.from_numpy(x), sigma).numpy()
    want = np.asarray(jfilters.gaussian_filter_2d(jnp.asarray(x), sigma))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    got = tfilters.difference_of_gaussians(torch.from_numpy(x), sigma, 2 * sigma).numpy()
    want = np.asarray(jfilters.difference_of_gaussians(jnp.asarray(x), sigma, 2 * sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_psf_fft_convolution_and_tv_gradient_match_jax():
    """``create_gaussian_psf`` equals JAX's exactly (odd and even sizes);
    ``fft_convolve_same`` equals JAX's at 1e-6 × max|result| for 3×3,
    5×5 and 9×9 kernels, batched over a leading axis; ``tv_gradient``
    equals JAX's exactly (the same scatter order)."""
    rng = np.random.default_rng(0)
    for size, sigma in ((9, 1.0), (9, 1.3), (8, 1.0), (5, 2.0)):
        np.testing.assert_array_equal(trl.create_gaussian_psf(size, sigma), jrl.create_gaussian_psf(size, sigma))
    x = rng.uniform(0.0, 1.0, size=(4, 9, 9)).astype(np.float32)
    for ksize in (3, 5, 9):
        k = rng.normal(size=(ksize, ksize)).astype(np.float32)
        got = trl.fft_convolve_same(torch.from_numpy(x), torch.from_numpy(k)).numpy()
        want = np.stack([np.asarray(jrl.fft_convolve_same(jnp.asarray(f), jnp.asarray(k))) for f in x])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    x[0, 2:5, 2:5] = 1.0  # a plateau, where the TV step divides by sqrt(1e-8)
    got = trl.tv_gradient(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(jrl.tv_gradient(jnp.asarray(f))) for f in x])
    np.testing.assert_array_equal(got, want)


def test_rl_tv_step_matches_jax_from_the_same_estimate(rendered):
    """Each of the 11 RL-TV steps of ``(2, 5, 10)``'s snapshots, started by
    both sides from JAX's estimate before it, gives JAX's step at 5e-5
    absolute, the TV step's amplification of a few ulps (measured ≤
    4.6e-6): the port computes the reference's step, on the normalised
    Poisson variant of 1,920 rendered frames."""
    image = torch.clamp(rendered[2][:, 2], min=1e-6)
    jpsf = jnp.asarray(PSF)
    jstep = jax.jit(jax.vmap(jax.vmap(lambda e, i: jrl._rl_tv_step(e, i, jpsf, jpsf[::-1, ::-1], 0.01))))
    psf = torch.from_numpy(PSF)
    estimate = np.full(image.shape, 0.5, np.float32)
    for step in range(11):
        want = np.asarray(jstep(jnp.asarray(estimate), jnp.asarray(image.numpy())))
        got = trl._rl_tv_step(torch.from_numpy(estimate.copy()), image, psf, psf.flip(-2, -1), 0.01).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5, err_msg=f"step {step}")
        estimate = want


def test_rl_tv_snapshots_and_the_seven_variant_stack_match_jax(rendered):
    """The seven-variant stack ``(64, 7, 30, 9, 9)``: its first four
    variants equal JAX's ``normalize_images`` of the port's own four
    variants exactly; its RL-TV snapshots equal JAX's
    ``apply_rl_tv_iter_list_batch`` of the same normalised Poisson variant
    after 3, 6 and 11 steps (0-based indices 2, 5, 10) at 1e-4 on at least
    99.5 % of the pixels (measured: all, 99.988 % and 99.929 %; the rest
    is the amplification of the module's docstring, largest 0.0174). Every
    RL-TV value lies in [0, 1]; each snapshot is bitwise the port's
    ``richardson_lucy_tv`` of 3, 6 and 11 steps."""
    _, variants, stack = rendered
    assert stack.shape == (64, 7, 30, 9, 9)
    four = np.stack([v.numpy() for v in variants], axis=1)
    norm = np.asarray(j_normalize_images(jnp.asarray(four), 1420.0, 290.0, 3980.0 + 1420.0)[0])
    np.testing.assert_array_equal(stack[:, :4].numpy(), norm)
    want = np.asarray(jrl.apply_rl_tv_iter_list_batch(jnp.asarray(norm[:, 2]), jnp.asarray(PSF), (2, 5, 10)))
    got = stack[:, 4:].numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    for j in range(3):
        assert (np.abs(got[:, j] - want[:, j]) > 1e-4).mean() <= 5e-3, j
    for j, steps in enumerate((3, 6, 11)):
        full = trl.richardson_lucy_tv(stack[:, 2], PSF, iterations=steps)
        assert torch.equal(stack[:, 4 + j], full), steps
    snaps = trl.richardson_lucy_tv_iter_list(stack[0, 2, 0], PSF)
    assert snaps.shape == (3, 9, 9) and torch.equal(snaps, stack[0, 4:, 0])


def test_four_variant_renderer_matches_jax(rendered):
    """``trajectories_to_video_multiple_settings``, four ``(64, 30, 9, 9)``
    variants: ``filtered`` is ``gaussian_filter_2d(poisson, 0.5)`` exactly;
    ``no_noise`` is the JAX renderer's frame of the port's per-frame
    intensity (re-drawn from stream ``fold_in(g, 0)``, split evenly over the
    10 sub-positions) at 1e-5 × max|frame|; ``gauss − no_noise`` lies in
    ``[0, bg + 3σ]``; and ``poisson``'s shot noise on the port's ``gauss``
    matches JAX's ``Pois(max(gauss, 0)·k)/k`` on the same ``gauss`` in
    distribution: the standardised residual ``(poisson − gauss) /
    sqrt(gauss/k)`` has mean and variance within 5 standard errors of
    JAX's. The whole renderer against JAX's on the same trajectories: each
    noisy variant's pixel mean within 0.2 % and standard deviation within 2 %
    (different generators)."""
    trajs, (no_noise, gauss, poisson, filtered), _ = rendered
    assert torch.equal(filtered, tfilters.gaussian_filter_2d(poisson, 0.5))
    x_hr, y_hr = trender._prepare_subpositions(trajs, 10, True, OPTICS)
    g = fold_in(torch.Generator().manual_seed(1), 0)
    part_mean, part_std = OPTICS.particle_intensity
    w = ((part_mean + part_std * torch.randn((64, 30), generator=g)) / 10)[..., None].expand(64, 30, 10)
    want = np.asarray(j_render_frames_core(*(jnp.asarray(v.numpy()) for v in (x_hr, y_hr, w)),
                                           OPTICS.gaussian_sigma_hr, 9, 5))
    np.testing.assert_allclose(no_noise.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    bg_mean, bg_std = OPTICS.background_intensity
    added = (gauss - no_noise).numpy()
    assert added.min() >= 0.0 and added.max() <= bg_mean + 3 * bg_std + 1e-3

    k = OPTICS.poisson_noise
    lam = np.maximum(gauss.numpy(), 0.0)
    j_shot = np.asarray(j_poisson(jax.random.key(2), jnp.asarray(lam * k)) / k)
    z_port = ((poisson.numpy() - lam) / np.sqrt(lam / k)).ravel()
    z_jax = ((j_shot - lam) / np.sqrt(lam / k)).ravel()
    se = np.sqrt(2.0 / z_port.size)
    assert abs(z_port.mean() - z_jax.mean()) <= 5 * se and abs(z_port.var() - z_jax.var()) <= 5 * np.sqrt(2) * se

    jv = j_multiple_settings(jax.random.key(1), jnp.asarray(trajs.numpy()), 10, True, jden.DENOISING_OPTICS)
    for got, ref in zip((gauss, poisson, filtered), jv[1:]):
        got, ref = got.numpy(), np.asarray(ref)
        assert got.shape == ref.shape == (64, 30, 9, 9)
        assert abs(got.mean() - ref.mean()) <= 2e-3 * ref.mean()
        assert abs(got.std() - ref.std()) <= 2e-2 * ref.std()


def test_denoising_build_matches_jax_arms_and_slices():
    """Optics, settings and RL iterations are the JAX package's; the arms'
    member names and order equal JAX's; ``grid_slice`` lays setting ``m``
    out as member ``m`` with the labels tiled, as JAX's; the experiment
    trains with L1 loss for 10 cycles on D = 1, 3, 5, 7 with a learned
    positional embedding; every regime of the JAX runner is registered."""
    assert dataclasses.asdict(OPTICS) == dataclasses.asdict(jden.DENOISING_OPTICS)
    assert denoising.SETTINGS == jden.SETTINGS and denoising.RL_ITERATIONS == jden.RL_ITERATIONS
    exp, jexp = denoising.build(val_d_values=(), device="cpu"), jden.build(val_d_values=())
    assert exp.model_names == jexp.model_names == NAMES and list(exp.arms) == list(jexp.arms)
    assert exp.train_cfg.loss == "l1" and exp.train_cfg.num_cycles == 10
    assert exp.train_cfg.training_ds == jexp.train_cfg.training_ds
    assert exp.arms["trans_grid"].model.config.use_pos_encoding
    assert set(REGISTRY) == set(JREGISTRY)
    rng = np.random.default_rng(3)
    videos = rng.normal(size=(4, 7, 5, 9, 9)).astype(np.float32)
    labels = rng.uniform(size=(4, 1)).astype(np.float32)
    want_v, _, want_l = jexp.arms["trans_grid"].slice_fn({"videos": jnp.asarray(videos), "labels": jnp.asarray(labels)})
    got_v, feats, got_l = denoising.grid_slice({"videos": torch.from_numpy(videos), "labels": torch.from_numpy(labels)})
    assert feats is None and got_v.shape == (7, 4, 5, 9, 9) and got_l.shape == (7, 4, 1)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_tiny_denoising_run_gives_every_member_its_history(small_denoising):
    """Two cycles on the CPU: the cycle's data ``(8, 7, 6, 9, 9)`` with
    labels D / 10 (D ~ N(1 … 7, 1) truncated at 0) and RL-TV variants in
    [0, 1]; the validation stacks
    ``(3, 7, 6, 9, 9)``; two grid arms whose members are the 14 models;
    finite per-member L1 training losses and two validation MSEs each."""
    exp = _build()
    data = exp.generate_fn(torch.Generator().manual_seed(0))
    assert data["videos"].shape == (8, 7, 6, 9, 9) and data["labels"].shape == (8, 1)
    assert torch.isfinite(data["videos"]).all() and 0.0 <= float(data["videos"][:, 4:].min())
    assert float(data["videos"][:, 4:].max()) <= 1.0
    assert 0.0 <= float(data["labels"].min()) and float(data["labels"].max()) <= 1.0
    assert exp.val_data[5.0]["videos"].shape == (3, 7, 6, 9, 9)
    assert exp.model_names == NAMES and list(exp.arms) == ["trans_grid", "resnet_grid"]
    exp.run(2)
    assert list(exp.history) == NAMES
    assert all(len(h["val_avg"]) == 2 and np.isfinite(h["val_avg"]).all() for h in exp.history.values())
    for arm in ("trans_grid", "resnet_grid"):
        assert exp.train_loss[arm][1].shape == (7,) and torch.isfinite(exp.train_loss[arm][1]).all()


def test_run_experiment_denoising(small_denoising, monkeypatch, tmp_path):
    """``run_experiment denoising --device cpu`` writes the 14 members'
    histories, the grids' final states and the events with L1 loss;
    without a card and without ``--device`` it raises, as ``build`` does;
    ``get_experiment("denoising")`` builds the experiment."""
    monkeypatch.setitem(REGISTRY, "denoising", functools.partial(denoising.build, val_length=6,
                                                                 val_d_values=(1.0, 5.0)))
    out = tmp_path / "run"
    run_experiment.main(["denoising", "--cycles", "1", "--seqs-per-d", "2", "--out", str(out), "--device", "cpu",
                         "--checkpoint-last", "0", "--in-order"])
    for name in ("metrics.jsonl", "history.json", "final/meta.json", "final/states/trans_grid.pt",
                 "final/states/resnet_grid.pt"):
        assert (out / name).is_file(), name
    history = json.loads((out / "history.json").read_text())
    assert list(history) == NAMES and all(np.isfinite(h["val_avg"][0]) for h in history.values())
    events = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert events[0]["models"] == NAMES and events[0]["loss"] == "l1"
    assert get_experiment("denoising", device="cpu").model_names == NAMES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment.main(["denoising", "--out", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        denoising.build(val_d_values=())
