"""The port's framerate experiment against the JAX package on the CPU: the
render core at 13×13 for every exposure's sub-position count, the exposure
stack (flux scaling, per-rate normalisation, padding, shape; its noise in
distribution), the deep-ResNet transformer and ``MultiImageResNet`` on 13×13
frames against flax, and the experiment through its entry points at tiny
sizes (T = 60 steps, ``rates=(5, 10)``: 12 and 6 frames; 2 sequences per D
class; a 3-particle validation suite): the slices, the fused cycle against
per-arm cycles, the continuous-D generation at full size, ``run_experiment
framerate`` and the in-order rescore's CSV. Inputs are made from a seed with
numpy; tolerances are stated per test."""

import functools
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import FRAMERATE_OPTICS as J_OPTICS
from moleculardiffusion_mivit_tpu.config import ModelConfig as JModelConfig
from moleculardiffusion_mivit_tpu.experiments import framerate as jfr
from moleculardiffusion_mivit_tpu.models import GeneralTransformer as JGeneral
from moleculardiffusion_mivit_tpu.models import MultiImageResNet as JResNet
from moleculardiffusion_mivit_tpu.models import init_model as j_init
from moleculardiffusion_mivit_tpu.models import param_count as j_count
from moleculardiffusion_mivit_tpu.sim.render import _render_frames_xla
from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.config import FRAMERATE_OPTICS, ModelConfig
from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, framerate
from moleculardiffusion_mivit_tpu_torch.models import GeneralTransformer, MultiImageResNet
from moleculardiffusion_mivit_tpu_torch.models import param_count as t_count
from moleculardiffusion_mivit_tpu_torch.sim.render import render_frames_core
from moleculardiffusion_mivit_tpu_torch.utils.convert import torch_state_from_flax
from tests.test_torch_train import _step_matches_jax

ROOT = Path(__file__).resolve().parents[1]
RATES = (5, 10)
ARMS = ["tr_0", "res_0", "tr_1", "res_1"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny shapes: torch's intra-op threads cost more than they give, and
    several test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_framerate(monkeypatch):
    """Validation of 3 particles per D, and the shipped in-order suite cut to
    one particle per D value and to 60 steps."""
    def load(length, device):
        return tval.generate_frozen_validation(d_values=(1, 5), n_particles=3, t_steps=10 * length,
                                               in_order_particles=1, device=device)

    imft = tval.generate_in_order_imft()[:, :1, :60]
    monkeypatch.setattr(framerate, "load_validation_trajectories", load)
    monkeypatch.setattr(framerate, "generate_in_order_imft", lambda: imft)


def _trajectories(n, t, seed):
    """``(N, T, 2)`` Brownian walks in trajectory units / ``traj_div_factor``."""
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.normal(scale=0.3, size=(n, t, 2)), axis=1) / 100.0).astype(np.float32)


# ---------------------------------------------------------------- the render

@pytest.mark.parametrize("p", framerate.RATES)
def test_render_core_at_13x13_matches_jax(p):
    """Given the same sub-positions and intensities, K1's plain version on
    13×13 frames (u = 5, S·u = 65) with P = 5 … 50 sub-positions a frame
    equals the JAX package's XLA render at 1e-5 relative to the largest
    pixel."""
    rng = np.random.default_rng(p)
    x, y = ((3.0 * rng.normal(size=(12, p))).astype(np.float32) for _ in range(2))
    w = (4580.0 / p * (1.0 + 0.1 * rng.normal(size=(12, p)))).astype(np.float32)
    sigma = FRAMERATE_OPTICS.gaussian_sigma_hr
    got = render_frames_core(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w), sigma, 13, 5).numpy()
    want = np.asarray(_render_frames_xla(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), sigma, 13, 5))
    assert got.shape == (12, 13, 13)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_noise_free_stack_matches_jax():
    """With the background's spread and the Poisson noise off and the spot
    intensity's spread at 2e-4 photons (relative 4e-8), the stack is
    deterministic: on the same 300-step trajectories the port's equals the
    JAX package's at 1e-5 relative to the largest pixel, with the same
    shape ``(N, 6, 60, 13, 13)``, flux ∝ rate, normalisation against each
    rate's own ``bg_mean + flux``, and zeros past ``T // rate`` frames."""
    kw = dict(particle_intensity=(4580.0, 2e-4), background_intensity=(1420.0, 0.0), poisson_noise=-1)
    trajs = _trajectories(3, 300, seed=0)
    got = framerate.render_framerate_stack(torch.Generator().manual_seed(0), torch.from_numpy(trajs),
                                           FRAMERATE_OPTICS.replace(**kw)).numpy()
    want = np.asarray(jfr.render_framerate_stack(jax.random.key(0), jnp.asarray(trajs), J_OPTICS.replace(**kw)))
    assert got.shape == want.shape == (3, 6, 60, 13, 13)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    for i, rate in enumerate(framerate.RATES):
        n_frames = 300 // rate
        assert not got[:, i, n_frames:].any() and got[:, i, :n_frames].any(axis=(-2, -1)).all(), rate
    with pytest.raises(ValueError, match="not divisible"):
        framerate.render_framerate_stack(torch.Generator(), torch.zeros(1, 70, 2), FRAMERATE_OPTICS)


def test_stack_noise_and_normalisation_match_jax_in_distribution(monkeypatch):
    """With the real optics (spot intensity spread, clipped background,
    Poisson noise) over 16 trajectories of 300 steps (96 to 960 frames a
    rate): the normalisation constants handed to ``normalize_images`` are
    JAX's, ``(bg_mean, bg_sigma, bg_mean + part_mean · rate / 10)``, rate by
    rate; and per rate, the mean of the normalised pixels is within 0.002
    of JAX's and their standard deviation within 1.5 % (the two sides draw
    from different generators; the same trajectories, so the spots sit
    alike; seen: at most 3e-4 and 0.6 %)."""
    calls = {"port": [], "jax": []}

    def recorder(side, fn):
        def wrapped(images, *consts):
            calls[side].append(tuple(float(c) for c in consts))
            return fn(images, *consts)
        return wrapped

    monkeypatch.setattr(framerate, "normalize_images", recorder("port", framerate.normalize_images))
    monkeypatch.setattr(jfr, "normalize_images", recorder("jax", jfr.normalize_images))
    trajs = _trajectories(16, 300, seed=1)
    got = framerate.render_framerate_stack(torch.Generator().manual_seed(1), torch.from_numpy(trajs),
                                           FRAMERATE_OPTICS).numpy()
    want = np.asarray(jfr.render_framerate_stack(jax.random.key(1), jnp.asarray(trajs), J_OPTICS))
    bg, sd = FRAMERATE_OPTICS.background_intensity
    assert calls["port"] == calls["jax"] == [(bg, sd, bg + 4580.0 * r / 10) for r in framerate.RATES]
    for i, rate in enumerate(framerate.RATES):
        a, b = got[:, i, : 300 // rate], want[:, i, : 300 // rate]
        assert abs(a.mean() - b.mean()) < 0.002, (rate, a.mean(), b.mean())
        assert abs(a.std() / b.std() - 1.0) < 0.015, (rate, a.std(), b.std())


# ---------------------------------------------------------------- the models on 13×13 frames

def _pair(kind, x):
    if kind == "tr":
        cfg = dict(patch_size=13, use_pos_encoding=False)
        jm, tm = JGeneral(JModelConfig(**cfg), embedding="deep_resnet"), \
            GeneralTransformer(ModelConfig(**cfg), embedding="deep_resnet")
    else:
        jm, tm = JResNet(), MultiImageResNet()
    params, bstats = j_init(jm, jax.random.key(2), jnp.asarray(x))
    state = torch_state_from_flax(_np(params), _np(bstats))
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    return jm, tm, params, bstats


@pytest.mark.parametrize("frames", [6, 12])
@pytest.mark.parametrize("kind", ["tr", "res"])
def test_arms_on_13x13_frames_match_flax(kind, frames):
    """The experiment's two arm kinds at full width on 13×13 frames, on
    flax's weights through ``torch_state_from_flax`` (2 sequences of 6 and
    12 frames: the 50 ms rate's slice at T = 60, and the shortest at T =
    300): train- and eval-mode outputs at rtol/atol 1e-5, the BatchNorm
    running statistics after the train-mode forward equal to flax's at rtol
    1e-5 / atol 1e-6, equal parameter counts."""
    rng = np.random.default_rng(frames)
    x = (0.3 * rng.normal(size=(2, frames, 13, 13)) + 0.1).astype(np.float32)
    jm, tm, params, bstats = _pair(kind, x)
    with jax.default_matmul_precision("highest"):
        jtrain, mut = jm.apply({"params": params, "batch_stats": bstats}, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        jeval = jm.apply({"params": params, "batch_stats": mut["batch_stats"]}, jnp.asarray(x), train=False)
    ttrain = tm.train()(torch.from_numpy(x))
    with torch.no_grad():
        teval = tm.eval()(torch.from_numpy(x))
    assert ttrain.shape == jtrain.shape == (2, 1)
    np.testing.assert_allclose(ttrain.detach().numpy(), np.asarray(jtrain), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), rtol=1e-5, atol=1e-5)
    got = tm.state_dict()
    for key, want in torch_state_from_flax({}, _np(mut["batch_stats"])).items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=key)
    assert t_count(tm) == j_count(params)


def test_one_train_step_on_13x13_frames_matches_jax():
    """One AdamW step of the deep-ResNet transformer at full width on 6
    frames of 13×13 from flax's weights leaves parameters, moments and
    BatchNorm statistics at the JAX update's, at the tolerances of
    ``test_torch_train.test_one_train_step_matches_jax`` (1e-5)."""
    cfg = dict(patch_size=13, use_pos_encoding=False)
    _step_matches_jax(JGeneral(JModelConfig(**cfg), embedding="deep_resnet"),
                      GeneralTransformer(ModelConfig(**cfg), embedding="deep_resnet"), "mse", frame_size=13)


# ---------------------------------------------------------------- the experiment

def _build(**kw):
    exp = framerate.build(rates=RATES, sequences_per_d=2, val_length=6, val_d_values=(1.0, 5.0), device="cpu",
                          **kw)
    exp.train_cfg = exp.train_cfg.replace(initial_batch_size=2, adaptive_batch_size=1)  # batch 2, then 4
    return exp


def test_slices_pick_each_rates_frames_and_no_arm_stacks(small_framerate):
    """The arms in the JAX package's order; the cycle's data holds 2 + 2 +
    2 + 2 + 2 + 1 = 11 sequences (the 10.2 tail at half count) of ``(2, 12,
    13, 13)`` and labels D / 10; arm ``*_i`` reads exactly the first ``T //
    rate_i`` frames of slice ``i`` (a view), every arm has its own slice
    function, and the six identical transformers form no activation stack
    (they read different slices); validation at D = 1 and 5 is stacked the
    same way."""
    exp = _build()
    assert list(exp.arms) == ARMS
    assert [d for d, _ in exp.train_cfg.training_ds] == [1, 3, 5, 7, 9, 10.2]
    data = exp.generate_fn(torch.Generator().manual_seed(0))
    assert data["videos"].shape == (11, 2, 12, 13, 13) and data["labels"].shape == (11, 1)
    assert (data["labels"] >= 0).all() and torch.isfinite(data["videos"]).all()
    assert len({id(a.slice_fn) for a in exp.arms.values()}) == len(ARMS)
    for name, arm in exp.arms.items():
        i = int(name[-1])
        videos, feats, labels = arm.slice_fn(data)
        assert feats is None and labels is data["labels"]
        assert videos.shape == (11, 60 // RATES[i], 13, 13)
        assert torch.equal(videos, data["videos"][:, i, : 60 // RATES[i]])
        assert videos.data_ptr() == data["videos"][:, i].data_ptr()
    assert (data["videos"][:, 1, 6:] == 0).all()
    exp.build()
    assert exp._stack_groups == []
    assert exp.val_data[5.0]["videos"].shape == (3, 2, 12, 13, 13)


def test_framerate_fused_cycle_equals_per_arm_cycles(small_framerate):
    """Two cycles through the fused cycle equal each arm's eager epoch in
    history, losses and parameters at 1e-6 relative (the non-contiguous
    slices go into the engine's buffers as they are)."""
    fused, per_arm = _build(), _build()
    per_arm.fused_cycles = False
    fused.run(2)
    per_arm.run(2)
    assert list(fused.history) == ARMS
    for name in ARMS:
        np.testing.assert_allclose(fused.history[name]["val_avg"], per_arm.history[name]["val_avg"], rtol=1e-6)
        np.testing.assert_allclose([float(v) for v in fused.train_loss[name]],
                                   [float(v) for v in per_arm.train_loss[name]], rtol=1e-6)
        assert len(fused.history[name]["val_5"]) == 2 and all(np.isfinite(fused.history[name]["val_avg"]))
        got, want = fused.states[name].model.state_dict(), per_arm.states[name].model.state_dict()
        for key in got:
            torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")


def test_continuous_d_generation_at_full_size(small_framerate):
    """``continuous_d=(lo, hi)`` draws a D per sequence at the discrete
    schedule's budget, 5.5 × 64 = 352 sequences, labels in ``[lo, hi] / 10``
    spread over the range, videos ``(352, 6, 60, 13, 13)`` (one cycle's data;
    nothing is trained)."""
    exp = framerate.build(continuous_d=(0.5, 9.5), device="cpu", val_d_values=())
    data = exp.generate_fn(torch.Generator().manual_seed(0))
    assert data["videos"].shape == (352, 6, 60, 13, 13) and data["labels"].shape == (352, 1)
    assert float(data["labels"].min()) >= 0.05 and float(data["labels"].max()) <= 0.95
    assert float(data["labels"].std()) > 0.2  # spread over the range, not one class
    assert torch.isfinite(data["videos"]).all()


def test_run_experiment_framerate_and_in_order_rescore(small_framerate, monkeypatch, tmp_path):
    """``run_experiment framerate`` on the CPU writes the arms' histories,
    the final states and metrics.jsonl with the JAX runner's events (less
    ``figures``, ``resumed`` and ``error_tables``: ``--in-order`` does not
    apply to framerate, in JAX neither); the rescore of its checkpoint
    (``python -m ...experiments.framerate --ckpt <out>/final``) writes the
    JAX example's CSV next to it: its header, one row per arm in its order
    with the exposure and the published MSE, and finite scores."""
    build = functools.partial(framerate.build, rates=RATES, val_length=6, val_d_values=(1.0, 5.0))
    monkeypatch.setitem(REGISTRY, "framerate", build)
    out = tmp_path / "run"
    exp = run_experiment.main(["framerate", "--cycles", "1", "--seqs-per-d", "2", "--out", str(out),
                               "--device", "cpu", "--checkpoint-last", "0", "--in-order"])
    assert exp.in_order_data is None and not (out / "framerate_errors.csv").exists()
    for name in ("metrics.jsonl", "history.json", "final/meta.json", "final/states/tr_1.pt"):
        assert (out / name).is_file(), name
    history = json.loads((out / "history.json").read_text())
    assert list(history) == ARMS and all(np.isfinite(h["val_avg"][0]) for h in history.values())
    events = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert events[0]["models"] == ARMS
    assert events[0]["training_ds"] == [[1, 1], [3, 1], [5, 1], [7, 1], [9, 1], [10.2, 1]]
    jax_runner = (ROOT / "moleculardiffusion_mivit_tpu" / "run_experiment.py").read_text()
    jax_events = set(re.findall(r'logger\.log\(\s*"(\w+)"', jax_runner)) | {"cycle"}
    assert {e["event"] for e in events} == jax_events - {"figures", "resumed", "error_tables"}

    monkeypatch.setattr(framerate, "build", build)
    monkeypatch.setattr(framerate, "RATES", RATES)
    rows = framerate.main(["--ckpt", str(out / "final"), "--device", "cpu", "--chunk", "40"])
    lines = (out / framerate.RESCORE_CSV).read_text().splitlines()
    example = (ROOT / "examples" / "framerate_inorder_rescore.py").read_text()
    assert lines[0] == "model,exposure_ms,mse,std,mse_d_le_7,published_mse" and lines[0] in example
    assert [r.split(",")[0] for r in lines[1:]] == ARMS
    for line, (name, exposure, published) in zip(lines[1:], [("tr_0", 50, 1.24), ("res_0", 50, 1.32),
                                                           ("tr_1", 100, 0.76), ("res_1", 100, 0.82)]):
        cells = line.split(",")
        assert int(cells[1]) == exposure and float(cells[5]) == published
        assert all(np.isfinite(float(c)) for c in cells[2:5])
        assert float(cells[2]) == pytest.approx(rows[name]["mse"], rel=1e-5)
