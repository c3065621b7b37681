"""The port's modular experiment through its own entry points on the CPU, at
tiny sizes (6 frames, 2 to 4 sequences per D class, a 3-particle validation
suite at D = 1 and 5): the fused cycle equals per-arm cycles with and
without ``with_hybrid``; the training classes follow the in-order suite;
and ``run_experiment modular --with-hybrid --in-order`` writes the files and
the events of the JAX package's runner. On the card the fused cycle runs as
captured CUDA graphs (``chip_smoke.py`` phase modular)."""

import functools
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.experiments import REGISTRY, modular

ROOT = Path(__file__).resolve().parents[1]
MODULAR_ARMS = ["mod_images", "mod_features", "mod_both_add", "mod_both_concat", "mod_both_concat_feat"]
HYBRID_ARMS = MODULAR_ARMS + ["glob_early_tr", "hybrid_concat", "hybrid_add"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny shapes: torch's intra-op threads cost more than they give, and
    several test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_modular(monkeypatch):
    """Validation of 3 particles per D, and the shipped in-order suite cut to
    one particle per D value and to the run's length."""
    def load(length, device):
        return tval.generate_frozen_validation(
            d_values=(1, 5), n_particles=3, t_steps=10 * length, in_order_particles=1, device=device
        )

    imft = tval.generate_in_order_imft()[:, :1]
    monkeypatch.setattr(modular, "load_validation_trajectories", load)
    monkeypatch.setattr(modular, "generate_in_order_imft", lambda t_steps: imft[:, :, :t_steps])


def _build(**kw):
    exp = modular.build(sequences_per_d=4, val_length=6, val_d_values=(1.0, 5.0), device="cpu", **kw)
    exp.train_cfg = exp.train_cfg.replace(initial_batch_size=2, adaptive_batch_size=1)  # batch 2, then 4
    return exp


@pytest.mark.parametrize("with_hybrid", [False, True])
def test_modular_fused_cycles_equal_per_arm_cycles(small_modular, with_hybrid):
    """The modular experiment's arms in the JAX package's order, the cycle's
    data (videos, per-frame tokens ``(N, 6, 6)``; with ``with_hybrid`` the
    25 global features and the packed ``(N, 6·6 + 25)`` tensor, which are
    not computed without it); two cycles through the fused cycle equal each
    arm's eager epoch in history, losses and parameters at 1e-6. No arm
    stacks, and ``mod_features`` has no image embedding to train."""
    fused, per_arm = _build(with_hybrid=with_hybrid), _build(with_hybrid=with_hybrid)
    per_arm.fused_cycles = False
    arms = HYBRID_ARMS if with_hybrid else MODULAR_ARMS
    assert list(fused.arms) == arms
    data = fused.generate_fn(torch.Generator().manual_seed(0))
    assert data["videos"].shape == (16, 6, 9, 9) and data["pf_features"].shape == (16, 6, 6)
    assert data["labels"].shape == (16, 1) and torch.isfinite(data["pf_features"]).all()
    if with_hybrid:
        assert data["g_features"].shape == (16, 25) and data["hybrid_features"].shape == (16, 61)
        torch.testing.assert_close(data["hybrid_features"][:, :36], data["pf_features"].reshape(16, 36),
                                   rtol=0, atol=0)
    else:
        assert "g_features" not in data and "hybrid_features" not in data
    assert not hasattr(fused.arms["mod_features"].model, "image_embedding")
    assert fused.arms["mod_both_concat_feat"].model.image_embedding.fc.out_features == 58
    fused.run(2)
    per_arm.run(2)
    assert fused._stack_groups == []
    assert list(fused.history) == arms and set(fused.train_loss) == set(arms)
    for name in arms:
        np.testing.assert_allclose(fused.history[name]["val_avg"], per_arm.history[name]["val_avg"], rtol=1e-6)
        np.testing.assert_allclose([float(v) for v in fused.train_loss[name]],
                                   [float(v) for v in per_arm.train_loss[name]], rtol=1e-6)
        assert len(fused.history[name]["val_1"]) == 2 and all(np.isfinite(fused.history[name]["val_avg"]))
        got, want = fused.states[name].model.state_dict(), per_arm.states[name].model.state_dict()
        for key in got:
            torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-6, msg=f"{name} {key}")


def test_training_classes_follow_the_in_order_suite(small_modular, monkeypatch):
    """Without the in-order sweep the experiment trains on D = 1, 3, 5, 7;
    scoring the ``imft`` suite adds D = 9 (its sweep reaches 10.0), the
    ``committed`` one does not. Without a card ``build`` raises unless given
    ``device="cpu"``."""
    assert [d for d, _ in _build().train_cfg.training_ds] == [1, 3, 5, 7]
    imft = _build(with_in_order=True)
    assert [d for d, _ in imft.train_cfg.training_ds] == [1, 3, 5, 7, 9]
    assert len(imft.in_order_data["d_values"]) == 100 and imft.in_order_data["pf_features"].shape == (100, 6, 6)
    committed = _build(with_in_order=True, in_order_suite="committed")
    assert [d for d, _ in committed.train_cfg.training_ds] == [1, 3, 5, 7]
    assert len(committed.in_order_data["d_values"]) == 70
    assert [d for d, _ in _build(in_order_suite="committed").train_cfg.training_ds] == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="in_order_suite"):
        _build(with_in_order=True, in_order_suite="other")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        modular.build()


def test_run_experiment_modular_with_hybrid_in_order(small_modular, monkeypatch, tmp_path):
    """``run_experiment modular --with-hybrid --in-order`` on the CPU writes
    the eight arms' histories, their in-order predictions on the 100-value
    D = 0.1..10.0 sweep, the error-table CSV, the final states and
    metrics.jsonl with the JAX runner's events (less ``figures``, not
    ported, and ``resumed``); ``--with-hybrid`` on an experiment without the
    option is an error, as in the JAX runner."""
    monkeypatch.setitem(REGISTRY, "modular", functools.partial(modular.build, val_length=6, val_d_values=(1.0, 5.0)))
    out = tmp_path / "run"
    run_experiment.main(["modular", "--with-hybrid", "--in-order", "--cycles", "1", "--seqs-per-d", "2",
                         "--out", str(out), "--device", "cpu", "--checkpoint-last", "0"])
    for name in ("metrics.jsonl", "history.json", "modular_errors.csv", "in_order_predictions.npz",
                 "final/history.json", "final/meta.json", "final/states/hybrid_add.pt"):
        assert (out / name).is_file(), name
    history = json.loads((out / "history.json").read_text())
    assert list(history) == HYBRID_ARMS
    assert all(len(h["val_avg"]) == 1 and np.isfinite(h["val_avg"][0]) for h in history.values())
    preds = np.load(out / "in_order_predictions.npz")
    assert preds["d_values"].shape == (100,) and float(preds["d_values"][-1]) == 10.0
    for name in HYBRID_ARMS:
        assert preds[name].shape == (100, 1) and np.isfinite(preds[name]).all(), name
    rows = (out / "modular_errors.csv").read_text().splitlines()
    assert rows[0] == "model,mse,std" and [r.split(",")[0] for r in rows[1:]] == HYBRID_ARMS
    events = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    start = events[0]
    assert start["event"] == "start" and start["models"] == HYBRID_ARMS
    assert start["training_ds"] == [[1, 1], [3, 1], [5, 1], [7, 1], [9, 1]]
    jax_runner = (ROOT / "moleculardiffusion_mivit_tpu" / "run_experiment.py").read_text()
    jax_events = set(re.findall(r'logger\.log\(\s*"(\w+)"', jax_runner)) | {"cycle"}
    assert {e["event"] for e in events} == jax_events - {"figures", "resumed"}
    with pytest.raises(SystemExit):
        run_experiment.main(["baseline", "--device", "cpu", "--out", str(tmp_path / "b"), "--with-hybrid"])
