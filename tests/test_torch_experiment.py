"""The port's baseline experiment through its own entry points on the CPU,
at tiny sizes (4 frames, 2 sequences per D class, a 3-particle validation
suite): ``Experiment`` with fused cycles equals per-arm cycles; a checkpoint
round trip resumes to the history of an uninterrupted run; and
``run_experiment`` writes the files and the events of the JAX package's
runner. On the card the fused cycle runs as captured CUDA graphs
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import functools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, GridArm, baseline, get_experiment
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
    the in-order predictions; a second call with ``--resume`` continues.
    Its events are those the JAX package's ``run_experiment.py`` logs, less
    ``figures`` (``--plots``, not ported)."""
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
                         "--resume", str(out / "final")])
    history = json.loads((out / "history.json").read_text())
    assert all(len(h["val_avg"]) == 2 for h in history.values())
    events = _events(out / "metrics.jsonl")
    jax_runner = (ROOT / "moleculardiffusion_mivit_tpu" / "run_experiment.py").read_text()
    jax_events = set(re.findall(r'logger\.log\(\s*"(\w+)"', jax_runner)) | {"cycle"}
    assert set(events) == jax_events - {"figures"}
    assert events.count("resumed") == 1 and events.count("cycle") == 2


def test_entry_points_raise_without_a_card_and_name_what_is_not_ported(monkeypatch, tmp_path):
    """With no card, the runner given no ``--device`` and
    ``baseline.build`` raise rather than run on the CPU; the unported
    regimes and parts raise ``NotImplementedError`` naming their ROADMAP
    item."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment.main(["baseline", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baseline.build()
    for name in ("psfnoise", "framerate", "embeddings", "images_features", "denoising", "modular"):
        with pytest.raises(NotImplementedError, match="item 12"):
            get_experiment(name)
    with pytest.raises(NotImplementedError, match="item 11"):
        GridArm()
    exp = baseline.Experiment("x", None, None, {}, None, {}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
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
