"""The ensemble and continuous-D entry points (``experiments/ensemble.py``,
``experiments/continuous_d.py``) against the JAX package and
``examples/ensemble_training.py`` on the CPU, at tiny size: the cycle data
given JAX's draws and in distribution, the discrete curriculum's labels,
``member_preds`` against the example's evaluation on one grid, the report's
tables against numpy and JAX's ``error_table``, both entry points end to
end, and ``ensemble_outcome.py``'s rules on synthetic numbers and on the
committed card runs. The early-fusion grid step with features is a case of
``tests/test_torch_grid.py::test_grid_train_step_matches_jax``."""

import copy
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.config import OpticsConfig as JOptics
from moleculardiffusion_mivit_tpu.config import TrainConfig as JTrainConfig
from moleculardiffusion_mivit_tpu.evaluation import error_table as j_error_table
from moleculardiffusion_mivit_tpu.experiments.base import rotate_videos as j_rotate
from moleculardiffusion_mivit_tpu.experiments.images_features import make_dataset as j_make_dataset
from moleculardiffusion_mivit_tpu.sim.trajectory import brownian_motion as j_brownian
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, ModelConfig, TrainConfig
from moleculardiffusion_mivit_tpu_torch.experiments import continuous_d, ensemble
from moleculardiffusion_mivit_tpu_torch.features.features import FEATURE_NAMES, PARITY_TOLERANCE
from moleculardiffusion_mivit_tpu_torch.sim import brownian_motion, single_state
from moleculardiffusion_mivit_tpu_torch.utils.rng import seeded_generator
from tests.test_torch_grid import SMALL, M, _data, _features, _jax_grid, _models, _torch_grid

ROOT = Path(__file__).resolve().parents[1]
OPTICS_FIELDS = ("particle_intensity", "na", "wavelength", "psf_division_factor", "resolution", "output_size",
                 "upsampling_factor", "background_intensity", "poisson_noise", "trajectory_unit")
EXAMPLE_TABLE_KEYS = {"member_mse_mean", "member_mse_min", "member_mse_max", "ensemble_mse", "ensemble_std",
                      "ensemble_mae", "per_d_mse", "d_values"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def outcome():
    return _load(ROOT / "ensemble_outcome.py", "ensemble_outcome")


def _quiet(optics):
    """Every noise term off but a particle intensity spread of 1e-3 (the
    renderer draws no particle below 1e-4)."""
    return optics.replace(particle_intensity=(optics.particle_intensity[0], 1e-3),
                          background_intensity=(optics.background_intensity[0], 0.0), poisson_noise=-1)


def _stub_dataset(generator, trajs, train_cfg, optics):
    """``make_dataset`` without the render and the features: the draws'
    tests need neither."""
    n = trajs.shape[0]
    return {"videos": torch.zeros(n, 1), "features": torch.zeros(n, 1)}


def test_continuous_data_matches_jax_given_its_draws(monkeypatch):
    """Two members of the continuous curriculum handed the example's own
    draws (``generate_one`` per member key: D ~ U(0.1, 10.5), its Brownian
    trajectories with dt = 10, ``make_dataset``), with quiet optics: the D
    each member hands the simulator and the labels (D / 10) at 1e-6, the
    member-major videos at 1e-5 of their largest value and the 25 features
    at ``PARITY_TOLERANCE``, against JAX's."""
    lo, hi, n = 0.1, 10.5, 3
    optics = _quiet(BASELINE_OPTICS)
    joptics = JOptics(**{k: getattr(optics, k) for k in OPTICS_FIELDS})
    cfg = ensemble.train_config()
    jcfg = JTrainConfig(seed=0, adaptive_batch_size=20, initial_batch_size=1)
    p, f = cfg.n_pos_per_frame, cfg.n_frames
    draws, want = [], []
    for key in jax.random.split(jax.random.key(5), 2):
        kd, kt, kdata = jax.random.split(key, 3)
        d = jax.random.uniform(kd, (n,), minval=lo, maxval=hi)
        trajs = j_brownian(kt, n, f, p, d, float(p))
        draws.append((np.asarray(d, np.float64), np.array(trajs)))
        want.append(j_make_dataset(kdata, trajs / jcfg.traj_div_factor, jcfg, joptics))
    units = [torch.from_numpy((d - lo) / (hi - lo)).float() for d, _ in draws]
    walks = [torch.from_numpy(t) for _, t in draws]
    real_rand, seen_d = torch.rand, []
    monkeypatch.setattr(torch, "rand", lambda *a, **k: units.pop(0) if a == (n,) else real_rand(*a, **k))

    def brownian(g, count, frames, pos, d, dt):
        assert (count, frames, pos, dt) == (n, f, p, float(p))
        seen_d.append(d.clone())
        return walks.pop(0)

    monkeypatch.setattr(ensemble, "brownian_motion", brownian)
    got = ensemble.generate(torch.Generator(), cfg, optics, 2, n, "continuous", (lo, hi))
    assert got["videos"].shape == (2, n, f, 9, 9) and got["features"].shape == (2, n, 25)
    for m, ((d, _), w) in enumerate(zip(draws, want)):
        np.testing.assert_allclose(seen_d[m].numpy(), d, rtol=1e-6)
        np.testing.assert_allclose(got["labels"][m, :, 0].numpy(), d / cfg.d_max_normalization, rtol=1e-6)
        jv = np.asarray(w["videos"])
        np.testing.assert_allclose(got["videos"][m].numpy(), jv, rtol=0, atol=1e-5 * np.abs(jv).max())
        jf = np.asarray(w["features"])
        for c, name in enumerate(FEATURE_NAMES):
            rtol, atol = PARITY_TOLERANCE[name]
            np.testing.assert_allclose(got["features"][m, :, c].numpy(), jf[:, c], rtol=rtol, atol=atol,
                                       err_msg=name)


def test_continuous_draws_hold_in_distribution(monkeypatch):
    """The port's own draws, two members × 2,000 sequences: D uniform on
    [0.1, 10.5) (every draw inside, the mean and the share below the
    midpoint within 3 standard errors), a sub-step displacement variance of
    2D in each coordinate (the pooled ratio within 3 standard errors of 1),
    the members' streams distinct and the cycle reproducible."""
    lo, hi, n = 0.1, 10.5, 2000
    cfg = ensemble.train_config()
    walks = []

    def brownian(*a, **k):
        walks.append(brownian_motion(*a, **k))
        return walks[-1]

    monkeypatch.setattr(ensemble, "brownian_motion", brownian)
    monkeypatch.setattr(ensemble, "make_dataset", _stub_dataset)
    g = seeded_generator("cpu", 3)
    got = ensemble.generate(g, cfg, BASELINE_OPTICS, 2, n, "continuous", (lo, hi))
    d = got["labels"][..., 0].double() * cfg.d_max_normalization
    assert d.shape == (2, n)
    assert float(d.min()) >= lo and float(d.max()) < hi
    flat = d.flatten().numpy()
    se = (hi - lo) / np.sqrt(12 * flat.size)
    assert abs(flat.mean() - (lo + hi) / 2) <= 3 * se
    assert abs((flat < (lo + hi) / 2).mean() - 0.5) <= 3 * 0.5 / np.sqrt(flat.size)
    steps = torch.cat([w.diff(dim=1) for w in walks]).double()  # (2n, T - 1, 2)
    ratio = (steps ** 2 / (2 * d.flatten()[:, None, None])).numpy()
    assert abs(ratio.mean() - 1) <= 3 * np.sqrt(2 / ratio.size)
    assert not torch.equal(got["labels"][0], got["labels"][1])
    again = ensemble.generate(g, cfg, BASELINE_OPTICS, 2, n, "continuous", (lo, hi))
    assert torch.equal(again["labels"], got["labels"])


def test_discrete_curriculum_labels_are_single_states(monkeypatch):
    """The discrete curriculum (``--classes 1,3``, 4 sequences a member):
    each member's labels are ``single_state``'s D over 10, class by class
    (``labs[:, :1, 1] / d_max``, as the example takes them), each class
    drawn at (c, 1.0); ``--n`` not divisible by the classes raises."""
    calls = []

    def spy(g, count, steps, Ds):
        out = single_state(g, count, steps, Ds=Ds)
        calls.append((Ds, out[1]))
        return out

    monkeypatch.setattr(ensemble, "single_state", spy)
    monkeypatch.setattr(ensemble, "make_dataset", _stub_dataset)
    cfg = ensemble.train_config()
    got = ensemble.generate(seeded_generator("cpu", 4), cfg, BASELINE_OPTICS, 2, 4, "discrete", classes=(1.0, 3.0))
    assert [ds for ds, _ in calls] == [(1.0, 1.0), (3.0, 1.0)] * 2
    want = torch.cat([lab[:, :1, 1] for _, lab in calls]).reshape(2, 4, 1) / cfg.d_max_normalization
    assert torch.equal(got["labels"], want)
    with pytest.raises(ValueError, match="divide"):
        ensemble.generate(seeded_generator("cpu", 4), cfg, BASELINE_OPTICS, 2, 5, "discrete", classes=(1.0, 3.0))


@pytest.fixture(scope="module")
def trained_grid():
    """A JAX early-fusion grid of ``M`` members moved by one step (so its BN
    statistics are not the initial ones), and the port's ensemble
    ``Experiment`` holding the same weights."""
    jmodel, _ = _models("early")
    videos, labels = _data(6)
    feats = _features(6)
    impls, jgrid = _jax_grid(jmodel, JTrainConfig(), videos, feats)
    with jax.default_matmul_precision("highest"):
        jgrid, _ = jax.jit(impls.train_step)(
            jgrid, jnp.asarray(videos), jnp.asarray(labels), jnp.asarray(feats), jnp.asarray(np.array([[0, 1]] * M)),
            jax.random.split(jax.random.key(1), M), jnp.float32(1e-3))
    exp = ensemble.build(0, M, 4, model_cfg=ModelConfig(**SMALL), device="cpu")
    exp.build()
    exp.states["ensemble"] = _torch_grid(exp.arms["ensemble"].model, jgrid, TrainConfig())
    return impls, jgrid, exp


def _jax_member_preds(impls, grid, videos, feats, tta, chunk):
    """The example's ``member_preds`` (``ensemble_training.py:182-206``)."""
    eval_j = jax.jit(impls.evaluate)
    outs = []
    for i in range(0, videos.shape[0], chunk):
        v, ft = videos[i:i + chunk], feats[i:i + chunk]
        ftm = jnp.broadcast_to(ft, (M,) + ft.shape)
        rots = range(4) if tta else (0,)
        pred = jnp.mean(jnp.stack([eval_j(grid, jnp.broadcast_to(j_rotate(v, k), (M,) + v.shape), ftm)
                                   for k in rots]), axis=0)
        outs.append(np.asarray(pred[..., 0]))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_member_preds_match_the_examples_evaluation(trained_grid, tta):
    """Every member's eval-mode predictions on 5 sequences with their
    features broadcast over the members, whole and in chunks of 2, without
    and with the 0/90/180/270° rotation TTA: the port's ``member_preds``
    equals the example's on the same grid and inputs at 1e-4 relative plus
    1e-5, and the grid is left in training mode."""
    impls, jgrid, exp = trained_grid
    rng = np.random.default_rng(8)
    videos = (0.3 * rng.normal(size=(5, 4, 9, 9)) + 0.1).astype(np.float32)
    feats = rng.normal(size=(5, 25)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = _jax_member_preds(impls, jgrid, jnp.asarray(videos), jnp.asarray(feats), tta, 100)
    assert want.shape == (M, 5)
    for chunk in (100, 2):
        got = ensemble.member_preds(exp, torch.from_numpy(videos), torch.from_numpy(feats), tta, chunk)
        assert got.shape == (M, 5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"chunk {chunk}")
    assert exp.states["ensemble"].model.training


def test_suite_tables_equal_numpy_and_jax_error_table():
    """One suite's table from ``(M, N)`` predictions: each member's MSE, the
    ensemble mean's MSE, sd/4 and MAE, and the per-D MSE against a numpy
    computation (1e-12) and against JAX's ``error_table`` on the same
    numbers (1e-6 relative: JAX sums in f32); ``per_d_mse`` rounded to 1e-5
    as the example rounds it, and unrounded in the full report."""
    rng = np.random.default_rng(9)
    d_values = np.array([0.5, 2.0, 7.5])
    preds = d_values.repeat(4)[None] + rng.normal(size=(3, 12))
    table, full = ensemble.suite_tables(preds, d_values)
    grids = preds.reshape(3, 3, 4)
    mses = ((grids - d_values[None, :, None]) ** 2).mean(axis=(1, 2))
    err = grids.mean(axis=0) - d_values[:, None]
    per_d = (err ** 2).mean(axis=1)
    np.testing.assert_allclose(full["member_mse"], mses, rtol=1e-12)
    np.testing.assert_allclose([table["member_mse_mean"], table["member_mse_min"], table["member_mse_max"]],
                               [mses.mean(), mses.min(), mses.max()], rtol=1e-12)
    np.testing.assert_allclose([table["ensemble_mse"], table["ensemble_std"], table["ensemble_mae"]],
                               [(err ** 2).mean(), err.std() / 4, np.abs(err).mean()], rtol=1e-12)
    np.testing.assert_allclose(full["per_d_mse"], per_d, rtol=1e-12)
    assert table["per_d_mse"] == [round(float(x), 5) for x in per_d]
    assert table["d_values"] == d_values.tolist() and set(table) == EXAMPLE_TABLE_KEYS
    jt = j_error_table(jnp.asarray(grids.mean(axis=0), jnp.float32), jnp.asarray(d_values, jnp.float32))
    for key in ("mse", "std", "mae"):
        assert table[f"ensemble_{key}"] == pytest.approx(float(jt[key]), rel=1e-6)


def test_entry_points_run_on_the_cpu(tmp_path, monkeypatch, capsys):
    """Both entry points end to end on the CPU with a one-layer model at
    embed 16 and the suites cut to every 10th D value × 1 sequence: the
    ensemble (2 members, 2 cycles of 4 sequences each) writes the example's
    keys and four tables, their member statistics equal to the full
    report's unrounded member MSEs, finite losses a member a cycle, and no
    kernel launch off the card; ``continuous_d`` (1 cycle) prints the
    example's line and writes ``committed`` and ``imft``."""
    monkeypatch.setattr(ensemble, "MODEL_CONFIG", ModelConfig(**SMALL))
    monkeypatch.setattr(ensemble, "EVAL_D_EVERY", 10)
    monkeypatch.setattr(ensemble, "EVAL_PARTICLES", 1)
    out = tmp_path / "ensemble"
    ran = ensemble.main(["--members", "2", "--cycles", "2", "--n", "4", "--device", "cpu", "--out", str(out)])
    written = json.loads((out / "ensemble_report.json").read_text())
    full = json.loads((out / "ensemble_full_report.json").read_text())
    assert written == ran["report"] == full["report"]
    assert {"members", "cycles", "n_per_member", "curriculum", "classes", "d_range", "train_seconds"} <= set(written)
    for tag in ("imft", "imft_tta", "committed", "committed_tta"):
        t = written[tag]
        assert set(t) == EXAMPLE_TABLE_KEYS and len(t["per_d_mse"]) == (10 if tag.startswith("imft") else 7)
        mses = full["suites"][tag]["member_mse"]
        assert len(mses) == 2 and t["member_mse_mean"] == pytest.approx(np.mean(mses), rel=1e-12)
        assert t["ensemble_mse"] <= t["member_mse_mean"]
    losses = np.asarray(full["train_loss"])
    assert losses.shape == (2, 2) and np.isfinite(losses).all()
    assert written["launches"] == {"train": {"k1": 0, "k2": 0, "k3": 0}, "eval": {"k1": 0, "k2": 0, "k3": 0}}
    assert written["card"] == "cpu" and written["members"] == 2

    out = tmp_path / "continuous_d"
    ran = continuous_d.main(["--cycles", "1", "--n", "4", "--device", "cpu", "--out", str(out)])
    written = json.loads((out / "continuous_d_report.json").read_text())
    assert written == ran["report"] and written["d_range"] == [0.1, 8.0]
    assert "in-order MiViT (continuous-D curriculum): mse=" in capsys.readouterr().out
    for suite, n_d in (("committed", 7), ("imft", 10)):
        assert np.isfinite([written[suite][k] for k in ("mse", "std", "mae")]).all()
        assert len(written[suite]["per_d_mse"]) == n_d
    assert len(ran["train_loss"]) == 1 and ran["experiment"].arms.keys() == {"mivit"}


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    """Without ``--device`` both entry points ask for the card, and raise
    on a machine without one before training anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (ensemble, continuous_d):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--cycles", "1", "--out", str(tmp_path / mod.__name__)])


def _synthetic(shift=0.0):
    """Reports of 4 seeds near the records, as ``judge`` takes them."""
    rng = np.random.default_rng(12)
    ensemble_runs, members, continuous = [], [], []
    for s in range(4):
        mse = 0.505 + 0.004 * rng.normal(size=8)
        table = {"member_mse_mean": float(mse.mean()), "ensemble_mse": float(mse.mean() - 0.012 + shift)}
        ensemble_runs.append({"seed": s, "train_seconds": 80.0, "card": "card",
                              **{t: dict(table) for t in ("imft", "imft_tta", "committed", "committed_tta")}})
        members.append(mse.tolist())
        continuous.append({"seed": s, "train_seconds": 30.0, "card": "card",
                           "imft": {"mse": 0.92 + 0.01 * rng.normal()}, "committed": {"mse": 0.31}})
    return ensemble_runs, members, continuous


def test_outcome_rules_hold_and_miss_on_synthetic_numbers(outcome):
    """E1-E3 and C1 on synthetic seeds near the records hold; each seed's
    ``ensemble_mse`` moved up by 0.05 misses E2 (and E3, the ensemble then
    above its members); the continuous runs moved by 0.1 miss C1 alone."""
    record = json.loads((outcome.RECORD / outcome.ENSEMBLE_FILE).read_text())
    record_d8 = json.loads((outcome.RECORD_D8 / outcome.ENSEMBLE_FILE).read_text())
    runs, members, continuous = _synthetic()
    verdict = outcome.judge(runs, members, continuous, record, record_d8)
    assert verdict["ok"] and len(verdict["held"]) == 5
    assert verdict["rules"]["E1"]["jax"]["sd"] == pytest.approx((0.5134063474172499 - 0.4964538352544886) / 2.847)
    moved, members, continuous = _synthetic(0.05)
    verdict = outcome.judge(moved, members, continuous, record, record_d8)
    assert not verdict["held"]["E2_imft_ensemble_mse"] and not verdict["ok"]
    for c in continuous:
        c["imft"]["mse"] += 0.1
    verdict = outcome.judge(runs, members, continuous, record, record_d8)
    assert [k for k, v in verdict["held"].items() if not v] == ["C1_continuous_d_imft_mse"]


def test_ensemble_studies_on_the_card_judged_by_the_rule(outcome):
    """The committed verdict reads as the rules say: the port's four card
    seeds of each protocol (``results/torch_ensemble_seed0-3``,
    ``results/torch_continuous_d_seed0-3``, run on an H100) against JAX's
    ``ensemble_150`` and ``ensemble_d8``, judged again here, give the
    committed ``results/ensemble_outcome/verdict.json``; a copy with every
    seed's ``imft`` ``ensemble_mse`` moved by 0.05 fails it."""
    ensemble_runs, members, continuous, record, record_d8 = outcome.load()
    assert [r["seed"] for r in ensemble_runs] == [r["seed"] for r in continuous] == [0, 1, 2, 3]
    assert all((r["members"], r["cycles"], r["n_per_member"], r["curriculum"], r["d_range"])
               == (8, 150, 256, "continuous", [0.1, 10.5]) for r in ensemble_runs)
    assert all((r["cycles"], r["n"], r["d_range"]) == (150, 256, [0.1, 8.0]) for r in continuous)
    assert all(len(m) == 8 for m in members)
    assert all(r["card"].startswith("NVIDIA H100") for r in ensemble_runs + continuous)
    verdict = outcome.judge(ensemble_runs, members, continuous, record, record_d8)
    assert json.loads(json.dumps(verdict)) == json.loads((outcome.OUT / "verdict.json").read_text())
    moved = copy.deepcopy(ensemble_runs)
    for r in moved:
        r["imft"]["ensemble_mse"] += 0.05
    assert not outcome.judge(moved, members, continuous, record, record_d8)["ok"]
