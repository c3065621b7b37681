"""The port's PSF × noise experiment against the JAX package on the CPU: the
optics, the sigma per PSF setting and the noise-free PSF stack (K1's plain
version with one sigma per setting), the noise cascade in distribution, the
member order of ``grid_slice``, the 60 model names, and the experiment
through its entry points at tiny sizes (2 PSF × 2 noise settings, 2
sequences per D class of 6 frames, one-layer transformers at embed 8, a 3-particle
validation suite, the shipped in-order suite cut to one particle per D
value): one cycle, the fused cycle against per-arm cycles, a checkpoint's
round trip, and ``run_experiment psfnoise --in-order``. K1's launch
constants for a sigma per setting are checked without a card. Inputs are
made from a seed with numpy; tolerances are stated per test."""

import csv
import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu import config as jconfig
from moleculardiffusion_mivit_tpu.experiments import psfnoise as jpsf
from moleculardiffusion_mivit_tpu.sim.render import render_frames_core as j_render_frames_core
from moleculardiffusion_mivit_tpu.sim.render import trajectories_to_video_psf_noise_grid as j_grid_render
from moleculardiffusion_mivit_tpu_torch import config as tconfig
from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.config import ModelConfig
from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, psfnoise
from moleculardiffusion_mivit_tpu_torch.ops import render as trender_ops
from moleculardiffusion_mivit_tpu_torch.sim.render import psf_sigmas, render_psf_stack
from moleculardiffusion_mivit_tpu_torch.sim.render import trajectories_to_video_psf_noise_grid as t_grid_render
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment, save_experiment

ROOT = Path(__file__).resolve().parents[1]
PSF, NOISE = (2.0, 1.0), (0.0, 0.2)
NAMES = ["tr_0_0", "tr_0_1", "tr_1_0", "tr_1_1", "res_0_0", "res_0_1", "res_1_0", "res_1_1"]
TINY_MODEL = ModelConfig(use_pos_encoding=False, embed_dim=8, num_heads=2, hidden_dim=16, num_layers=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny shapes: torch's intra-op threads cost more than they give, and
    several test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_psfnoise(monkeypatch):
    """Validation of 3 particles per D (D = 1 and 5), and the shipped
    in-order suite cut to one particle per D value and to the run's
    length."""
    def load(length, device):
        return tval.generate_frozen_validation(d_values=(1, 5), n_particles=3, t_steps=10 * length,
                                               in_order_particles=1, device=device)

    imft = tval.generate_in_order_imft()[:, :1]
    monkeypatch.setattr(psfnoise, "load_validation_trajectories", load)
    monkeypatch.setattr(psfnoise, "generate_in_order_imft", lambda t_steps: imft[:, :, :t_steps])


@pytest.fixture
def tiny_transformers(monkeypatch):
    """The grid's transformers at embed 8, 2 heads, FFN 16, one layer."""
    monkeypatch.setattr(psfnoise, "ModelConfig", lambda **kw: TINY_MODEL.replace(**kw))


def _build(**kw):
    return psfnoise.build(sequences_per_d=2, psf_settings=PSF, noise_settings=NOISE, val_length=6,
                          val_d_values=(1.0, 5.0), device="cpu", **kw)


def _trajectories(n, t, seed, scale=100.0):
    """``(N, T, 2)`` Brownian walks in trajectory units / ``scale``."""
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(scale=0.3, size=(n, t, 2)), axis=1) / scale).astype(np.float32)


def test_psfnoise_optics_and_sigmas_are_the_jax_packages():
    """``PSFNOISE_OPTICS`` is a copy of the JAX package's, field by field;
    the sigma per PSF setting is the JAX renderer's ``base / setting`` in
    f32."""
    assert dataclasses.asdict(tconfig.PSFNOISE_OPTICS) == dataclasses.asdict(jconfig.PSFNOISE_OPTICS)
    base = jconfig.PSFNOISE_OPTICS.replace(psf_division_factor=1.0).gaussian_sigma_hr
    want = np.asarray(jnp.asarray([base / ps for ps in psfnoise.PSF_SETTINGS], jnp.float32))
    np.testing.assert_array_equal(np.float32(psf_sigmas(tconfig.PSFNOISE_OPTICS, psfnoise.PSF_SETTINGS)), want)
    assert psfnoise.PSF_SETTINGS == jpsf.PSF_SETTINGS and psfnoise.NOISE_SETTINGS == jpsf.NOISE_SETTINGS


def test_noise_free_psf_stack_matches_jax():
    """Given the same sub-positions and intensities, the port's noise-free
    stack of the five PSF settings ``(5, N, F, S, S)`` (K1's plain version
    with a sigma per setting) equals the JAX package's render with the
    sigmas broadcast over a leading axis, at 1e-5 relative to the largest
    pixel."""
    rng = np.random.default_rng(0)
    x, y = ((3.0 * rng.normal(size=(4, 6, 10))).astype(np.float32) for _ in range(2))
    w = (500.0 * (1.0 + 0.1 * rng.normal(size=(4, 6, 10)))).astype(np.float32)
    sigmas = psf_sigmas(tconfig.PSFNOISE_OPTICS, psfnoise.PSF_SETTINGS)
    got = render_psf_stack(*(torch.from_numpy(v) for v in (x, y, w)), sigmas, 9, 5).numpy()
    want = np.asarray(j_render_frames_core(jnp.asarray(x)[None], jnp.asarray(y)[None], jnp.asarray(w)[None],
                                           jnp.asarray(sigmas, jnp.float32)[:, None, None, None], 9, 5))
    assert got.shape == want.shape == (5, 4, 6, 9, 9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_noise_cascade_matches_jax_in_distribution():
    """The whole grid renderer on the same 300-step trajectories as the JAX
    package's (``tests/test_render.py``'s grid test, at 16 trajectories):
    shape ``(N, 2, 2, 30, 9, 9)``; the wide PSF spreads more light 2 px off
    centre than the sharp one; every pixel a multiple of 1/k (shot noise
    ``Pois(·k)/k``, k = 100); the noisy arm sits one background above arm 0
    (the reference's cascade adds the background to the noised arm 0); and
    per (PSF, noise) cell the mean of the pixels is within 0.1 % of JAX's
    and their standard deviation within 1 % (the two sides draw from
    different generators)."""
    trajs = _trajectories(16, 300, seed=1, scale=1e4)
    got = t_grid_render(torch.Generator().manual_seed(0), torch.from_numpy(trajs), 10, True,
                        tconfig.PSFNOISE_OPTICS, PSF, (0.0, 0.1)).numpy()
    want = np.asarray(j_grid_render(jax.random.key(0), jnp.asarray(trajs), 10, True, jconfig.PSFNOISE_OPTICS,
                                    PSF, (0.0, 0.1)))
    assert got.shape == want.shape == (16, 2, 2, 30, 9, 9)
    prof = got.mean(axis=(0, 3))
    sharp, wide = prof[0, 0] - prof[0, 0].min(), prof[1, 0] - prof[1, 0].min()
    assert wide[4, 6] / wide[4, 4] > sharp[4, 6] / sharp[4, 4]
    np.testing.assert_allclose(got * 100.0, np.round(got * 100.0), atol=2e-2)
    assert got[:, :, 1].mean() > got[:, :, 0].mean() + 4000.0
    for i in range(2):
        for j in range(2):
            g, w = got[:, i, j], want[:, i, j]
            assert abs(g.mean() - w.mean()) <= 1e-3 * w.mean(), (i, j)
            assert abs(g.std() - w.std()) <= 1e-2 * w.std(), (i, j)


def test_k1_launch_constants_for_a_sigma_per_setting_need_no_card():
    """The wrapper's constants for a tuple of sigmas: one f32 factor
    ``-log2(e)/(2σ²)`` per setting, cached by the tuple; the shape checks
    and the refusals (more settings than the kernel's table, settings that
    do not divide the frames, a sigma tensor with axes) raise before any
    launch; on CPU tensors a tuple renders each run with its own sigma."""
    sigmas = psf_sigmas(tconfig.PSFNOISE_OPTICS, psfnoise.PSF_SETTINGS)
    frames, factors, step = trender_ops._launch_constants(sigmas, 10, 9, 5)
    assert frames == 3 and step == 1.0 and len(factors) == 5
    np.testing.assert_allclose(factors, [-np.log2(np.e) / (2 * s * s) for s in sigmas], rtol=1e-6)
    assert factors == tuple(trender_ops._launch_constants(s, 10, 9, 5)[1] for s in sigmas)
    with pytest.raises(ValueError, match="PSF settings outside"):
        trender_ops._kernel_sigma((5.0,) * 9, 18)
    with pytest.raises(ValueError, match="do not divide"):
        trender_ops._kernel_sigma((5.0, 4.0, 3.0), 10)
    with pytest.raises(ValueError, match="scalar sigma"):
        trender_ops._kernel_sigma(torch.full((2,), 5.0), 10)
    assert trender_ops._kernel_sigma((5.0, 4.0), 10) == (5.0, 4.0) and trender_ops._kernel_sigma(5, 10) == 5.0
    rng = np.random.default_rng(2)
    x, y = (torch.from_numpy((3.0 * rng.normal(size=(6, 10))).astype(np.float32)) for _ in range(2))
    w = torch.full((6, 10), 400.0)
    got = trender_ops.render_frames(x, y, w, (4.0, 2.0), 9, 5)
    for i, sig in enumerate((4.0, 2.0)):
        torch.testing.assert_close(got[3 * i:3 * i + 3],
                                   trender_ops.render_frames_reference(x[3 * i:3 * i + 3], y[3 * i:3 * i + 3],
                                                                       w[3 * i:3 * i + 3], sig, 9, 5))


def test_grid_slice_member_order_and_names_match_jax():
    """``grid_slice`` lays cell (PSF i, noise j) out as member ``i ·
    n_noise + j`` with the shared labels tiled, as the JAX package's; the
    arms' member names are JAX's; at the published settings they are the
    60 of the JAX record ``results/psfnoise_reconciled``."""
    jexp = jpsf.build(psf_settings=(2.0, 1.5, 1.0), noise_settings=(0.0, 0.1), val_d_values=())
    rng = np.random.default_rng(3)
    videos = rng.normal(size=(4, 3, 2, 5, 9, 9)).astype(np.float32)
    labels = rng.uniform(size=(4, 1)).astype(np.float32)
    want_v, _, want_l = jexp.arms["tr_grid"].slice_fn({"videos": jnp.asarray(videos), "labels": jnp.asarray(labels)})
    got_v, feats, got_l = psfnoise.grid_slice({"videos": torch.from_numpy(videos), "labels": torch.from_numpy(labels)})
    assert feats is None and got_v.shape == (6, 4, 5, 9, 9) and got_l.shape == (6, 4, 1)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    exp = psfnoise.build(val_d_values=(), device="cpu")
    with open(ROOT / "results" / "psfnoise_reconciled" / "psfnoise_errors.csv") as fh:
        record = [row["model"] for row in csv.DictReader(fh)]
    assert exp.model_names == record and len(record) == 60
    assert exp.arms["tr_grid"].names == jpsf.build(val_d_values=()).arms["tr_grid"].names


def test_tiny_psfnoise_cycle_gives_every_member_its_history(small_psfnoise, tiny_transformers):
    """One cycle on the CPU: the cycle's data ``(11, 2, 2, 6, 9, 9)`` (the
    10.2 tail at half count) with labels D / 10; two grid arms whose member
    names are the models'; finite per-member training losses, validation
    MSEs and in-order error tables, one per member; the validation videos
    stacked as the training data."""
    exp = _build(with_in_order=True)
    data = exp.generate_fn(torch.Generator().manual_seed(0))
    assert data["videos"].shape == (11, 2, 2, 6, 9, 9) and data["labels"].shape == (11, 1)
    assert torch.isfinite(data["videos"]).all() and (data["labels"] >= 0).all()
    assert exp.val_data[5.0]["videos"].shape == (3, 2, 2, 6, 9, 9)
    assert exp.model_names == NAMES and list(exp.arms) == ["tr_grid", "res_grid"]
    exp.run(1)
    assert list(exp.history) == NAMES
    assert all(np.isfinite(h["val_avg"][0]) and len(h["val_5"]) == 1 for h in exp.history.values())
    for arm in ("tr_grid", "res_grid"):
        assert exp.train_loss[arm][0].shape == (4,) and torch.isfinite(exp.train_loss[arm][0]).all()
    tables = exp.in_order_error_tables(n_renders=2)
    assert list(tables) == NAMES
    assert all(np.isfinite(t["mse"]) and len(t["mse_renders"]) == 2 for t in tables.values())
    preds = exp.in_order_predictions()
    assert all(p.shape == (100, 1) for p in preds.values())
    assert not np.allclose(preds["tr_0_0"], preds["tr_1_1"])


def test_psfnoise_fused_cycle_equals_per_arm_cycles_and_resumes(small_psfnoise, tiny_transformers, tmp_path):
    """Two cycles through the fused cycle (the capture engine's eager path
    on the CPU) equal each grid's own eager epochs in every member's
    history, losses and parameters at 1e-6 relative; a checkpoint after the
    first cycle restores a grid (its stacked parameters, BN statistics and
    AdamW state) that continues to the same second cycle."""
    fused, per_arm = _build(), _build()
    per_arm.fused_cycles = False
    fused.run(2)
    per_arm.run(2)
    for name in NAMES:
        np.testing.assert_allclose(fused.history[name]["val_avg"], per_arm.history[name]["val_avg"], rtol=1e-6)
    for arm in ("tr_grid", "res_grid"):
        np.testing.assert_allclose(torch.stack(fused.train_loss[arm]).numpy(),
                                   torch.stack(per_arm.train_loss[arm]).numpy(), rtol=1e-6)
        got, want = fused.states[arm].model.state_dict(), per_arm.states[arm].model.state_dict()
        for key in got:
            torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6, msg=f"{arm} {key}")

    first = _build()
    first.run(1)
    save_experiment(first, str(tmp_path / "ckpt"))
    resumed = _build()
    restore_experiment(resumed, str(tmp_path / "ckpt"))
    resumed.run(1, start_cycle=1)
    for name in NAMES:
        np.testing.assert_allclose(resumed.history[name]["val_avg"], fused.history[name]["val_avg"], rtol=1e-6)


def test_run_experiment_psfnoise_in_order(small_psfnoise, tiny_transformers, monkeypatch, tmp_path):
    """``run_experiment psfnoise --in-order`` on the CPU writes the members'
    histories, the grids' final states and ``psfnoise_errors.csv`` with one
    row per member in the JAX record's order, finite scores."""
    build = functools.partial(psfnoise.build, psf_settings=PSF, noise_settings=NOISE, val_length=6,
                              val_d_values=(1.0, 5.0))
    monkeypatch.setitem(REGISTRY, "psfnoise", build)
    out = tmp_path / "run"
    run_experiment.main(["psfnoise", "--cycles", "1", "--seqs-per-d", "2", "--out", str(out), "--device", "cpu",
                         "--checkpoint-last", "0", "--in-order"])
    for name in ("metrics.jsonl", "history.json", "final/meta.json", "final/states/tr_grid.pt",
                 "final/states/res_grid.pt", "in_order_predictions.npz"):
        assert (out / name).is_file(), name
    assert list(json.loads((out / "history.json").read_text())) == NAMES
    with open(out / "psfnoise_errors.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [r["model"] for r in rows] == NAMES and all(np.isfinite(float(r["mse"])) for r in rows)
    events = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert events[0]["models"] == NAMES
