"""The port's baseline and images-features experiments through their own
entry points on the CPU, at tiny sizes (4 or 6 frames, 2 to 8 sequences per
D class, a 3-particle validation suite): ``Experiment`` with fused cycles
equals per-arm cycles; a checkpoint round trip resumes to the history of an
uninterrupted run; and ``run_experiment`` writes the files and the events
of the JAX package's runner. On the card the fused cycle runs as captured
CUDA graphs (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import functools
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, baseline, get_experiment, images_features, psfnoise
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment, save_experiment

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These CPU runs are of tiny shapes, where torch's intra-op threads cost
    more than they give (the two fused-cycle files took 109 s with the
    default pool and 24 s with one thread), and several test workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_validation(monkeypatch):
    """Validation of 3 particles per D and one per in-order D value."""
    def load(length, device):
        return tval.generate_frozen_validation(
            d_values=(1, 3, 5, 7), n_particles=3, t_steps=10 * length, in_order_particles=1, device=device
        )

    monkeypatch.setattr(baseline, "load_validation_trajectories", load)


def _experiment(**kw):
    exp = baseline.build(val_length=4, sequences_per_d=2, device="cpu", **kw)
    # batch 2 in cycle 0, 4 in cycle 1: two batch sizes
    exp.train_cfg = exp.train_cfg.replace(initial_batch_size=2, adaptive_batch_size=1)
    return exp


def _params(exp):
    return {name: {k: v.clone() for k, v in st.model.state_dict().items()} for name, st in exp.states.items()}


@pytest.mark.parametrize("merge_scans", [False, True])
def test_fused_cycles_equal_per_arm_cycles(small_validation, merge_scans):
    """The seven arms trained through the fused cycle (activation pairs
    stacked below ``STACK_BELOW_BATCH``, or all arms in one merged unit)
    give the history, training losses and parameters of each arm's own
    eager epoch, at 1e-6."""
    fused, per_arm = _experiment(), _experiment()
    fused.merge_scans = merge_scans
    per_arm.fused_cycles = False
    fused.run(2)
    per_arm.run(2)
    assert len(fused._stack_groups) == 3 and list(fused.history) == list(fused.arms)
    for name in fused.arms:
        np.testing.assert_allclose(fused.history[name]["val_avg"], per_arm.history[name]["val_avg"], rtol=1e-6)
        np.testing.assert_allclose([float(v) for v in fused.train_loss[name]],
                                   [float(v) for v in per_arm.train_loss[name]], rtol=1e-6)
        assert len(fused.history[name]["val_1"]) == 2
    a, b = _params(fused), _params(per_arm)
    for name in a:
        for key in a[name]:
            torch.testing.assert_close(a[name][key], b[name][key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")


def test_checkpoint_round_trip_resumes_to_the_same_history(small_validation, tmp_path):
    """Two cycles straight equal one cycle, ``save_experiment``, a fresh
    experiment restored with ``restore_experiment``, and the second cycle
    from ``start_cycle=1``: the same history and parameters (parameters, BN
    statistics and AdamW state all come back)."""
    straight = _experiment(try_leaky_relu=False)
    straight.run(2)
    first = _experiment(try_leaky_relu=False)
    first.run(1)
    save_experiment(first, str(tmp_path / "ckpt"))
    assert json.loads((tmp_path / "ckpt" / "meta.json").read_text())["model_names"] == first.model_names
    resumed = _experiment(try_leaky_relu=False)
    restore_experiment(resumed, str(tmp_path / "ckpt"))
    assert resumed.history == first.history
    resumed.run(1, start_cycle=1)
    assert resumed.history == straight.history
    a, b = _params(resumed), _params(straight)
    for name in a:
        for key in a[name]:
            assert torch.equal(a[name][key], b[name][key]), f"{name} {key}"


def _events(path):
    return [json.loads(line)["event"] for line in path.read_text().splitlines()]


def test_run_experiment_writes_the_files_and_events_of_the_jax_runner(small_validation, monkeypatch, tmp_path):
    """``run_experiment.main([... "--device", "cpu"])`` writes metrics.jsonl,
    history.json, final/ (states, history, meta), the error-table CSV and
    the in-order predictions; a second call with ``--resume`` and
    ``--plots`` continues and renders the figures JAX's ``render_all`` makes
    from the same directory, under the same names. Its events are those the
    JAX package's ``run_experiment.py`` logs."""
    monkeypatch.setitem(REGISTRY, "baseline", functools.partial(baseline.build, val_length=4, try_leaky_relu=False))
    out = tmp_path / "run"
    run_experiment.main(["baseline", "--cycles", "1", "--seqs-per-d", "2", "--out", str(out), "--device", "cpu"])
    for name in ("metrics.jsonl", "history.json", "baseline_errors.csv", "in_order_predictions.npz",
                 "final/history.json", "final/meta.json", "final/states/resnet.pt", "baseline_cycle0/meta.json"):
        assert (out / name).is_file(), name
    history = json.loads((out / "history.json").read_text())
    assert set(history) == {"linear_2layer_s", "cnn_2layer_s", "deepcnn_2layer_s", "resnet"}
    assert all(len(h["val_avg"]) == 1 and np.isfinite(h["val_avg"][0]) for h in history.values())
    preds = np.load(out / "in_order_predictions.npz")
    assert preds["resnet"].shape == (70, 1) and preds["d_values"].shape == (70,)
    assert (out / "baseline_errors.csv").read_text().splitlines()[0] == "model,mse,std"

    run_experiment.main(["baseline", "--cycles", "2", "--seqs-per-d", "2", "--out", str(out), "--device", "cpu",
                         "--resume", str(out / "final"), "--plots"])
    history = json.loads((out / "history.json").read_text())
    assert all(len(h["val_avg"]) == 2 for h in history.values())
    events = _events(out / "metrics.jsonl")
    jax_runner = (ROOT / "moleculardiffusion_mivit_tpu" / "run_experiment.py").read_text()
    jax_events = set(re.findall(r'logger\.log\(\s*"(\w+)"', jax_runner)) | {"cycle"}
    assert set(events) == jax_events
    from moleculardiffusion_mivit_tpu.evaluation.plots import render_all as jax_render_all

    figures = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])["paths"]
    want = jax_render_all(str(out), str(tmp_path / "jax_figures"))
    assert sorted(os.path.basename(p) for p in figures) == sorted(os.path.basename(p) for p in want.values())
    assert all(os.path.getsize(p) > 0 for p in figures)
    assert events.count("resumed") == 1 and events.count("cycle") == 2


def test_entry_points_raise_without_a_card_and_name_what_is_not_ported(monkeypatch, tmp_path):
    """With no card, the runner given no ``--device``, ``baseline.build``,
    ``images_features.build`` and ``psfnoise.build`` (the experiment of
    ``GridArm``s) raise rather than run on the CPU; ``use_mesh`` raises
    without an initialised process group rather than train unsharded (the
    unported regime: ``test_unported_regimes_raise``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment.main(["baseline", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment.main(["images_features", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baseline.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        images_features.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        psfnoise.build(val_d_values=())
    exp = baseline.Experiment("x", None, None, {}, None, {}, device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        exp.use_mesh(None)


def test_sequence_mode_and_continuous_curriculum_generate_mixed_data(small_validation):
    """Sequence mode labels every frame and swaps tails across classes
    (``mix_trajectory_tails``); the continuous curriculum draws D per
    sequence and swaps tails by pairs (``mix_tails_uniform``): finite
    videos of the cycle's shape, labels that change along a swapped
    sequence."""
    for kw in (dict(sequences=True), dict(sequences=True, continuous_d=(0.5, 7.5)), dict(continuous_d=(0.5, 7.5))):
        exp = baseline.build(val_length=12, sequences_per_d=4, try_leaky_relu=False, device="cpu", **kw)
        data = exp.generate_fn(torch.Generator().manual_seed(0))
        assert data["videos"].shape == (16, 12, 9, 9) and torch.isfinite(data["videos"]).all()
        labels = data["labels"]
        if kw.get("sequences"):
            assert labels.shape == (16, 12)
            assert (labels[:, 0] != labels[:, -1]).sum() >= 2  # a swapped tail carries the partner's D
        else:
            assert labels.shape == (16, 1)
            assert 0.05 <= float(labels.min()) and float(labels.max()) <= 0.75


@pytest.mark.parametrize("name", ["denoising"])
def test_unported_regimes_raise(name):
    """No regime is left unported: the last one, denoising, is listed and
    builds its experiment instead of raising ``NotImplementedError``
    (``tests/test_torch_denoising.py`` holds it against JAX)."""
    assert name in REGISTRY
    assert get_experiment(name, val_d_values=(), device="cpu").name == name


@pytest.fixture
def small_imft(monkeypatch):
    """Images-features validation of 3 particles per D (D = 1 and 5), and the
    shipped in-order suite cut to one particle per D value and to the run's
    length."""
    def load(length, device):
        return tval.generate_frozen_validation(
            d_values=(1, 5), n_particles=3, t_steps=10 * length, in_order_particles=1, device=device
        )

    imft = tval.generate_in_order_imft()[:, :1]
    monkeypatch.setattr(images_features, "load_validation_trajectories", load)
    monkeypatch.setattr(images_features, "generate_in_order_imft", lambda t_steps: imft[:, :, :t_steps])


IMFT_ARMS = ["im_tr", "im_ft_early_tr", "im_ft_late_tr", "im_resnet", "im_ft_resnet", "ft_mlp",
             "MSD_Perfect", "MSD_Frame", "MSD_Localized"]


def test_images_features_fused_cycles_equal_per_arm_cycles(small_imft):
    """The images-features experiment at 8 sequences per D class (5
    classes), 6 frames, validation at D = 1 and 5: its nine arms in the
    JAX package's order, each cycle's data with 25 features per sequence;
    two cycles (batch 4, then 8) through the fused cycle equal each arm's
    eager epoch in history, losses and parameters at 1e-6; the MSD arms
    score every cycle, without training, the same."""
    def make():
        exp = images_features.build(sequences_per_d=8, val_length=6, val_d_values=(1.0, 5.0), device="cpu")
        exp.train_cfg = exp.train_cfg.replace(initial_batch_size=4, adaptive_batch_size=1)
        return exp

    fused, per_arm = make(), make()
    per_arm.fused_cycles = False
    assert list(fused.arms) == IMFT_ARMS
    data = fused.generate_fn(torch.Generator().manual_seed(0))
    assert data["videos"].shape == (40, 6, 9, 9) and data["features"].shape == (40, 25)
    assert data["trajs_raw"].shape == (40, 60, 2) and data["trajs_avg_err"].shape == (40, 6, 2)
    assert torch.isfinite(data["features"]).all() and data["labels"].shape == (40, 1)
    fused.run(2)
    per_arm.run(2)
    assert fused._stack_groups == []  # no activation pairs here, and fusion models never stack
    assert list(fused.history) == IMFT_ARMS and set(fused.train_loss) == set(IMFT_ARMS[:6])
    for name in IMFT_ARMS:
        np.testing.assert_allclose(fused.history[name]["val_avg"], per_arm.history[name]["val_avg"], rtol=1e-6)
        assert len(fused.history[name]["val_1"]) == 2 and all(np.isfinite(fused.history[name]["val_avg"]))
    for name in IMFT_ARMS[:6]:
        np.testing.assert_allclose([float(v) for v in fused.train_loss[name]],
                                   [float(v) for v in per_arm.train_loss[name]], rtol=1e-6)
    for name in IMFT_ARMS[6:]:
        assert fused.history[name]["val_avg"][0] == fused.history[name]["val_avg"][1]
    a, b = _params(fused), _params(per_arm)
    for name in a:
        for key in a[name]:
            torch.testing.assert_close(a[name][key], b[name][key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")
    preds = fused.predict("MSD_Frame", fused.val_data[1.0])
    assert preds.shape == (3,)
    tables = images_features.tta_error_tables(fused, fused.val_data[5.0], np.array([5.0]))
    assert set(tables) == {"im_tr_rot", "im_res_rot", "im_ft_res_rot", "im_ft_tr_rot"}
    assert all(np.isfinite(t["mse"]) for t in tables.values())


@pytest.mark.parametrize("suite,n_d", [("imft", 100), ("committed", 70)])
def test_run_experiment_images_features_in_order(small_imft, monkeypatch, tmp_path, suite, n_d):
    """``run_experiment images_features --in-order-suite {imft,committed}``
    (which implies ``--in-order``) on the CPU writes the nine arms'
    histories, and their in-order predictions on the 100-value D =
    0.1..10.0 sweep or the 70-value committed one, and the error-table CSV;
    ``--in-order-suite`` on an experiment without the option is an error."""
    monkeypatch.setitem(REGISTRY, "images_features",
                        functools.partial(images_features.build, val_length=6, val_d_values=(1.0, 5.0)))
    out = tmp_path / "run"
    run_experiment.main(["images_features", "--cycles", "1", "--seqs-per-d", "2", "--out", str(out),
                         "--device", "cpu", "--checkpoint-last", "0", "--in-order-suite", suite])
    history = json.loads((out / "history.json").read_text())
    assert list(history) == IMFT_ARMS
    assert all(len(h["val_avg"]) == 1 and np.isfinite(h["val_avg"][0]) for h in history.values())
    preds = np.load(out / "in_order_predictions.npz")
    assert preds["d_values"].shape == (n_d,) and float(preds["d_values"][-1]) == (10.0 if n_d == 100 else 7.0)
    for name in IMFT_ARMS:
        assert preds[name].shape == (n_d, 1) and np.isfinite(preds[name]).all(), name
    rows = (out / "images_features_errors.csv").read_text().splitlines()
    assert rows[0] == "model,mse,std" and len(rows) == 1 + len(IMFT_ARMS)
    with pytest.raises(SystemExit):
        run_experiment.main(["baseline", "--device", "cpu", "--out", str(tmp_path / "b"), "--in-order-suite", "imft"])
