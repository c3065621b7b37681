"""The rescoring studies and the CPU-sized examples of the port
(``experiments/tta_rescore.py``, ``seed_ensemble.py``, ``render_noise.py``,
``evaluation/msd_protocol.py``, ``poster_gallery.py``,
``sim/simulator_validation.py``) against the JAX package and its examples on
the CPU, at tiny size (6 frames, untrained full-width models).

Two JAX ``images_features`` experiments' states (two inits) are saved with
JAX's ``save_experiment`` and carried into two port checkpoints by
``utils.convert.load_flax_states``; then the JAX examples' own ``main``
(``examples/tta_rescore.py``, ``seed_ensemble_rescore.py``,
``render_noise_study.py``) and the port's entry points run over them, both
sides handed the same tiny experiment and the same injected in-order and
render data, and every report field is held to 1e-4. The JAX side's
experiment is built once: the examples' own ``exp.build()`` (an init that
the restore overwrites) is a no-op on it, so its evaluation compiles once.

The committed JAX records the outcome reads are made here:

    python -c "from tests.test_torch_rescore import write_jax_records; write_jax_records()"

(from the root of a checkout, JAX on the CPU, ~30 s): JAX's rows of the MSD
reconciliation on the shipped arrays (``results/torch_msd_protocol/
jax_rows.json``) and the simulator-validation example's checks
(``results/simulator_validation/jax_report.json``, checked against the
example's own printout)."""

import contextlib
import copy
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu_torch import evaluation as tval
from moleculardiffusion_mivit_tpu_torch.config import BASELINE_OPTICS, TrainConfig
from moleculardiffusion_mivit_tpu_torch.evaluation import msd_protocol, poster_gallery
from moleculardiffusion_mivit_tpu_torch.experiments import images_features, render_noise, seed_ensemble, tta_rescore
from moleculardiffusion_mivit_tpu_torch.sim import simulator_validation
from moleculardiffusion_mivit_tpu_torch.sim.render import (
    normalize_images,
    trajectories_to_video,
    trajectories_to_video_multiple_settings,
    trajectories_to_videos,
)
from moleculardiffusion_mivit_tpu_torch.utils import restore_experiment, save_experiment
from moleculardiffusion_mivit_tpu_torch.utils.convert import load_flax_states
from moleculardiffusion_mivit_tpu_torch.utils.rng import fold_in, seeded_generator

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 6
LEARNED = ("im_tr", "im_ft_early_tr", "im_ft_late_tr", "im_resnet", "im_ft_resnet", "ft_mlp")
D_SMALL = np.array([1.0, 3.0, 5.0, 7.0])  # the tiny in-order suite: 4 D values × 2 sequences
RENDERS = 2
JAX_MSD_ROWS = ROOT / "results" / "torch_msd_protocol" / "jax_rows.json"
JAX_SIMVAL = ROOT / "results" / "simulator_validation" / "jax_report.json"
BUILD = images_features.build  # the factory, before a test patches the entry points' view of it


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _inputs(n, seed):
    """Seeded stand-ins for a rendered suite: videos in [0, 1) and features
    ~ N(0, 1), float32."""
    rng = np.random.default_rng(seed)
    return (rng.random((n, FRAMES, 9, 9), dtype=np.float32),
            rng.standard_normal((n, 25), dtype=np.float32))


def _data(videos, feats, d_values, as_torch):
    if as_torch:
        return {"videos": torch.from_numpy(videos), "features": torch.from_numpy(feats), "labels": None,
                "d_values": d_values}
    return {"videos": jnp.asarray(videos), "features": jnp.asarray(feats), "labels": None, "d_values": d_values}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """One built tiny JAX experiment, two JAX checkpoints (two inits) and the
    two port checkpoints carried from them; the injected suite and renders."""
    from moleculardiffusion_mivit_tpu.experiments import images_features as jif
    from moleculardiffusion_mivit_tpu.utils import save_experiment as j_save

    root = tmp_path_factory.mktemp("rescore")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jif, "load_validation_trajectories", lambda length: {})
        jexp = jif.build(sequences_per_d=2, val_length=FRAMES, val_d_values=())
    videos, feats = _inputs(2, 0)
    example = {"videos": jnp.asarray(videos), "features": jnp.asarray(feats), "labels": jnp.ones((2, 1))}
    jexp.generate_fn = lambda key: example
    runs = {"jax": [], "port": []}
    for m in range(2):
        jexp.build(jax.random.key(100 + m))
        jdir, pdir = root / f"jax{m}", root / f"port{m}"
        j_save(jexp, str(jdir / "final"))
        pexp = _port_tiny()
        pexp.build()
        load_flax_states(pexp, {arm: {"params": _np_tree(st.params), "batch_stats": _np_tree(st.batch_stats)}
                                for arm, st in jexp.states.items()})
        save_experiment(pexp, str(pdir / "final"))
        runs["jax"].append(str(jdir))
        runs["port"].append(str(pdir))
    jexp.build = lambda *a, **k: None  # the examples' own build: an init their restore overwrites
    suite = _inputs(len(D_SMALL) * 2, 1)
    renders = [_inputs(100, 10 + r) for r in range(RENDERS)]  # 100 D values × 1 sequence
    return {"jexp": jexp, "runs": runs, "suite": suite, "renders": renders, "root": root}


def _port_tiny(seed=0, with_in_order=False, suite=None, **_):
    """The port's images-features experiment at 6 frames on the CPU, without
    validation sets; with ``suite`` its in-order data."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(images_features, "load_validation_trajectories", lambda length, device: {})
        exp = BUILD(seed=seed, sequences_per_d=2, val_length=FRAMES, val_d_values=(), device="cpu")
    if suite is not None:
        exp.in_order_data = _data(*suite, D_SMALL, True)
    return exp


@pytest.fixture
def patched(sides, monkeypatch):
    """Both sides' experiment factories return the tiny experiments with the
    injected suite; JAX's render-noise ``make_dataset`` and the port's
    ``make_renders`` return the injected renders."""
    import moleculardiffusion_mivit_tpu.evaluation as jeval
    import moleculardiffusion_mivit_tpu.experiments as jexps
    import moleculardiffusion_mivit_tpu.experiments.images_features as jif

    jexp = sides["jexp"]
    jexp.in_order_data = _data(*sides["suite"], D_SMALL, False)
    monkeypatch.setattr(jexps, "get_experiment", lambda name, **kw: jexp)
    monkeypatch.setattr(images_features, "build", lambda **kw: _port_tiny(suite=sides["suite"], **kw))
    imft = tval.generate_in_order_imft()[:, :1]
    monkeypatch.setattr(jeval, "generate_in_order_imft", lambda t_steps: imft[:, :, :t_steps])
    keys = [jax.random.key_data(jax.random.fold_in(jax.random.key(0), 2**21 + r)) for r in range(RENDERS)]

    def j_make_dataset(key, trajs, cfg, optics):
        r = next(i for i, k in enumerate(keys) if np.array_equal(jax.random.key_data(key), k))
        return _data(*sides["renders"][r], None, False)

    monkeypatch.setattr(jif, "make_dataset", j_make_dataset)
    monkeypatch.setattr(render_noise, "make_renders",
                        lambda exp, n: [_data(*sides["renders"][r], None, True) for r in range(n)])
    return sides


def _close(a, b, path=""):
    """Every number of two reports within 1e-4 (their 4-digit rounding may
    differ by one unit)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, (int, float)):
        assert abs(a - b) <= 1e-4 + 1e-9, f"{path}: {a} vs {b}"
    else:
        assert a == b, path


# ---------------------------------------------------------------- conversion

def test_load_flax_states_carries_every_arm(sides):
    """``load_flax_states`` puts JAX's trained weights of all six learned
    arms into the port's experiment: each arm's evaluation on the injected
    suite equals JAX's ``evaluate`` at 1e-5 (relative to the predictions'
    scale); trees for another set of arms raise and load nothing."""
    jexp = sides["jexp"]
    pexp = _port_tiny(suite=sides["suite"])
    pexp.build()
    trees = {arm: {"params": _np_tree(st.params), "batch_stats": _np_tree(st.batch_stats)}
             for arm, st in jexp.states.items()}
    assert set(trees) == set(LEARNED)
    load_flax_states(pexp, trees)
    jdata = _data(*sides["suite"], D_SMALL, False)
    for arm in LEARNED:
        entry = jexp.arms[arm]
        _, evaluate = jexp._fns[arm]
        v, f, _ = entry.slice_fn(jdata)
        want = np.asarray(evaluate(jexp.states[arm], v, f) if entry.with_features else evaluate(jexp.states[arm], v))
        got = images_features.arm_predictions(pexp, pexp.in_order_data, arm, False).numpy()
        np.testing.assert_allclose(got, want[..., 0], rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=arm)
    before = {k: v.clone() for k, v in pexp.states["im_tr"].model.state_dict().items()}
    with pytest.raises(ValueError, match="learned arms"):
        load_flax_states(pexp, {k: v for k, v in trees.items() if k != "ft_mlp"})
    assert all(torch.equal(before[k], v) for k, v in pexp.states["im_tr"].model.state_dict().items())


def test_restore_refuses_a_checkpoint_of_other_arms(sides, tmp_path):
    """A checkpoint whose models differ from the experiment's raises before
    any arm is loaded (the baseline experiment's arms into images-features,
    and an images-features checkpoint with one arm's file missing)."""
    from moleculardiffusion_mivit_tpu_torch.experiments import baseline

    exp = _port_tiny()
    exp.build()
    before = {k: v.clone() for k, v in exp.states["im_tr"].model.state_dict().items()}
    other = baseline.build(val_length=FRAMES, sequences_per_d=2, val_d_values=(), device="cpu")
    other.build()
    save_experiment(other, str(tmp_path / "baseline"))
    with pytest.raises(ValueError, match="holds models"):
        restore_experiment(exp, str(tmp_path / "baseline"))
    save_experiment(exp, str(tmp_path / "cut"))
    (tmp_path / "cut" / "states" / "ft_mlp.pt").unlink()
    with pytest.raises(ValueError, match="holds models"):
        restore_experiment(exp, str(tmp_path / "cut"))
    assert all(torch.equal(before[k], v) for k, v in exp.states["im_tr"].model.state_dict().items())
    restore_experiment(exp, str(Path(sides["runs"]["port"][0]) / "final"))


# ---------------------------------------------------------------- the three studies against the examples

def test_tta_rescore_matches_the_example(patched):
    """``examples/tta_rescore.py`` and the port's ``tta_rescore`` on the same
    checkpoint and suite: the same four rows (``tta_errors.csv``) at 1e-4;
    the port's report adds the plain rows of the same render."""
    example = _load(ROOT / "examples" / "tta_rescore.py", "example_tta_rescore")
    with contextlib.redirect_stdout(io.StringIO()):
        example.main([patched["runs"]["jax"][0], "--seqs-per-d", "2"])
        report = tta_rescore.main([patched["runs"]["port"][0], "--seqs-per-d", "2", "--device", "cpu"])

    def rows(run):
        lines = (Path(run) / "tta_errors.csv").read_text().splitlines()
        return lines[0], {r.split(",")[0]: [float(x) for x in r.split(",")[1:]] for r in lines[1:]}

    (jhead, want), (phead, got) = rows(patched["runs"]["jax"][0]), rows(patched["runs"]["port"][0])
    assert jhead == phead == "model,mse,std" and list(want) == list(got) == [
        "im_tr_rot", "im_res_rot", "im_ft_res_rot", "im_ft_tr_rot"]
    _close(want, got)
    assert set(report["plain"]) == {"im_tr", "im_resnet", "im_ft_resnet", "im_ft_early_tr"}
    assert report["k1_launches"] == 0 and report["card"] == "cpu"


def test_seed_ensemble_matches_the_example(patched, tmp_path):
    """``examples/seed_ensemble_rescore.py`` and the port's ``seed_ensemble``
    over the same two checkpoints and one shared suite: every field of the
    report (each arm's member MSEs, ensemble MSE and std, plain and TTA) at
    1e-4, in the example's key order."""
    example = _load(ROOT / "examples" / "seed_ensemble_rescore.py", "example_seed_ensemble")
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        example.main([*patched["runs"]["jax"], "--seqs-per-d", "2", "--out", str(tmp_path / "jax")])
        full = seed_ensemble.main([*patched["runs"]["port"], "--seqs-per-d", "2", "--out", str(tmp_path / "port"),
                                   "--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "seed_ensemble_report.json").read_text())
    got = json.loads((tmp_path / "port" / "seed_ensemble_report.json").read_text())
    assert list(got) == list(want) and got == full["report"]
    want.pop("run_dirs"), got.pop("run_dirs")
    _close(want, got)
    assert want["ft_mlp"]["plain"] == want["ft_mlp"]["tta"]
    for arm in seed_ensemble.ARMS:
        assert full["arms"][arm]["plain"]["ensemble_mse"] <= np.mean(full["arms"][arm]["plain"]["member_mses"])


def test_render_noise_matches_the_example(patched, tmp_path):
    """``examples/render_noise_study.py`` and the port's ``render_noise``
    over the same two checkpoints and two injected renders of the 100-value
    suite: the K×R matrix, both σs, the grand mean and the ensemble rows at
    1e-4, in the example's key order."""
    example = _load(ROOT / "examples" / "render_noise_study.py", "example_render_noise")
    with contextlib.redirect_stdout(io.StringIO()):
        example.main([*patched["runs"]["jax"], "--renders", str(RENDERS), "--seqs-per-d", "2",
                      "--out", str(tmp_path / "jax")])
        full = render_noise.main([*patched["runs"]["port"], "--renders", str(RENDERS), "--seqs-per-d", "2",
                                  "--out", str(tmp_path / "port"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "render_noise_report.json").read_text())
    got = json.loads((tmp_path / "port" / "render_noise_report.json").read_text())
    assert list(got) == list(want) and got == full["report"]
    want.pop("run_dirs"), got.pop("run_dirs")
    _close(want, got)
    assert np.asarray(got["mse_matrix_seed_x_render"]).shape == (2, RENDERS)


# ---------------------------------------------------------------- the render streams

def _experiment_streams(seed, cycles=150, classes=5):
    """Initial seeds of the images-features experiment's streams for a run
    seed: each cycle's data (and its classes' children), validation at each
    D, the in-order render and the re-renders of ``in_order_error_tables``."""
    out = set()
    for c in range(cycles):
        g = seeded_generator("cpu", seed + 1, c, 0)
        out.add(g.initial_seed())
        for i in range(classes):
            for j in (0, 1):
                out.add(fold_in(g, i, j).initial_seed())
    for d in (1, 3, 5, 7, 9):
        out.add(seeded_generator("cpu", seed + 99, d).initial_seed())
    out.add(fold_in(seeded_generator("cpu", seed + 99), 777).initial_seed())
    out.update(seeded_generator("cpu", seed + 424242, r).initial_seed() for r in range(5))
    return out


def test_render_noise_streams_are_apart_and_renders_differ():
    """The render-noise generators ``(0, 2**21 + r)`` and their render and
    localisation children are none of the training, validation, in-order or
    re-render streams of seeds 0-3, nor each other; ``make_datasets``
    renders of one trajectory set equal one ``make_dataset`` each (one frame
    core call for all), share their features, and differ from each other."""
    gens = render_noise.render_generators("cpu", 5)
    mine = [g.initial_seed() for g in gens]
    mine += [fold_in(g, k).initial_seed() for g in gens for k in (0, 1)]
    assert len(set(mine)) == len(mine)
    for seed in range(4):
        assert not set(mine) & _experiment_streams(seed)

    cfg = TrainConfig(n_frames=FRAMES)
    trajs = torch.as_tensor(tval.generate_in_order_imft()[::25, :2, :60].reshape(8, 60, 2) / 100.0,
                            dtype=torch.float32)
    many = images_features.make_datasets(gens[:3], trajs, cfg, BASELINE_OPTICS)
    for g, got in zip(gens[:3], many):
        want = images_features.make_dataset(g, trajs, cfg, BASELINE_OPTICS)
        for k in ("videos", "trajs_raw", "trajs_avg", "trajs_avg_err", "features"):
            torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6, msg=k)
    assert many[0]["features"] is many[1]["features"]
    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert (many[a]["videos"] - many[b]["videos"]).abs().mean() > 1e-3
        assert not torch.equal(many[a]["trajs_avg_err"], many[b]["trajs_avg_err"])
    videos = trajectories_to_videos([fold_in(g, 0) for g in gens[:2]], trajs, 10, True, BASELINE_OPTICS)
    assert videos.shape == (2, 8, FRAMES, 9, 9)
    torch.testing.assert_close(videos[1], trajectories_to_video(fold_in(gens[1], 0), trajs, 10, True,
                                                                BASELINE_OPTICS), rtol=0, atol=0)


# ---------------------------------------------------------------- MSD reconciliation and simulator checks

def jax_msd_rows() -> dict:
    """The example's ``msd_tables`` on its five suites with its keys, as the
    port reports them (``suites``: label and rows; ``closest``)."""
    example = _load(ROOT / "examples" / "msd_protocol_reconciliation.py", "example_msd_protocol")
    from moleculardiffusion_mivit_tpu.evaluation import (
        IN_ORDER_D_VALUES,
        IN_ORDER_IMFT_D_VALUES,
        generate_in_order_imft,
        load_validation_trajectories,
    )

    committed = load_validation_trajectories()["valTrajsInOrder"]
    r300, r200 = generate_in_order_imft(t_steps=300), generate_in_order_imft(t_steps=200)
    grids = [(committed, IN_ORDER_D_VALUES), (r300[:70], IN_ORDER_IMFT_D_VALUES[:70]), (r300, IN_ORDER_IMFT_D_VALUES),
             (r200[:70], IN_ORDER_IMFT_D_VALUES[:70]), (r200, IN_ORDER_IMFT_D_VALUES)]
    key = jax.random.key(4242)
    suites, best = [], {}
    for i, ((grid, d_values), (label, _, _)) in enumerate(zip(grids, msd_protocol.suites("cpu"))):
        tables = example.msd_tables(np.asarray(grid), np.asarray(d_values), jax.random.fold_in(key, i))
        tables = {arm: {k: float(v) for k, v in t.items()} for arm, t in tables.items()}
        suites.append({"suite": label, "tables": tables})
        for arm, t in tables.items():
            delta = abs(t["mse"] - example.PUBLISHED[arm][0])
            if arm not in best or delta < best[arm]["delta"]:
                best[arm] = {"delta": delta, "suite": label, "mse": t["mse"]}
    return {"suites": suites, "closest": best}


def test_msd_rows_equal_jax_on_the_regenerated_suites():
    """The shipped 200-step suite is JAX's ``generate_in_order_imft(t_steps=
    200)`` bit for bit (and not the first 200 steps of the 300-step one),
    made by the command in the module docstring. On the four regenerated
    suites the port's ``MSD_Perfect`` and ``MSD_Frame`` rows (mse, std)
    equal the example's ``msd_tables`` at 1e-5 relative (its noise draw
    differs, so ``MSD_Localized`` matches in distribution only); the
    committed ``jax_rows.json`` is that computation; the committed 70-value
    set is each side's own draw and is not compared."""
    from moleculardiffusion_mivit_tpu.evaluation import generate_in_order_imft as j_imft

    arr = tval.generate_in_order_imft(t_steps=200)
    want = j_imft(t_steps=200)
    assert arr.shape == (100, 10, 200, 2) and arr.dtype == np.float64
    np.testing.assert_array_equal(arr, want)
    assert not np.array_equal(arr, tval.generate_in_order_imft()[:, :, :200])
    jax_rows = jax_msd_rows()
    port = [msd_protocol.msd_tables(np.asarray(g), np.asarray(d), seeded_generator("cpu", 4242, i))
            for i, (_, g, d) in enumerate(msd_protocol.suites("cpu"))]
    for got, want in zip(port[1:], jax_rows["suites"][1:]):
        for arm in ("MSD_Perfect", "MSD_Frame"):
            for stat in ("mse", "std"):
                np.testing.assert_allclose(got[arm][stat], want["tables"][arm][stat], rtol=1e-5,
                                           err_msg=f"{want['suite']} {arm} {stat}")
        np.testing.assert_allclose(got["MSD_Localized"]["mse"], want["tables"]["MSD_Localized"]["mse"], rtol=0.1)
    committed = json.loads(JAX_MSD_ROWS.read_text())
    _close(committed, json.loads(json.dumps(jax_rows)))


def jax_simulator_report() -> dict:
    """The simulator-validation example's six checks under JAX with its keys,
    in the port's report layout (with the per-particle standard errors);
    raises unless the example's own printout shows the same numbers."""
    from moleculardiffusion_mivit_tpu.config import BASELINE_OPTICS as J_OPTICS
    from moleculardiffusion_mivit_tpu.features import estimate_d_from_msds, mean_square_displacements
    from moleculardiffusion_mivit_tpu.sim import average_trajectories_frames, single_state, trajectories_to_video

    def summary(d):
        d = np.asarray(d, np.float64)
        return {"mean": float(d.mean()), "se": float(d.std(ddof=1) / np.sqrt(d.size)), "n": int(d.size)}

    key = jax.random.key(0)
    out = {}
    _, labels = single_state(key, 5, 50, Ds=(3.0, 1.0), alphas=1)
    out["labels_first_3"] = np.asarray(labels[:3, 0]).tolist()
    out["check1_label_layout"] = simulator_validation.label_layout(torch.as_tensor(np.array(labels)))
    trajs, _ = single_state(key, 500, 300, Ds=(5.0, 0.0))
    out["check2_loop_closure"] = summary(estimate_d_from_msds(mean_square_displacements(trajs),
                                                              jnp.arange(300, dtype=jnp.float32)))
    avg = average_trajectories_frames(trajs, 10)
    t30 = 10 * jnp.arange(30, dtype=jnp.float32)
    out["check3_coarse_sampling"] = summary(estimate_d_from_msds(mean_square_displacements(avg), t30))
    noisy = avg + 3.0 * jax.random.normal(jax.random.key(1), avg.shape)
    out["check4_localization_noise"] = summary(estimate_d_from_msds(mean_square_displacements(noisy), t30))
    step = jnp.zeros((1, 20, 2)).at[:, 10:, 0].set(200.0)
    o100 = J_OPTICS.replace(trajectory_unit=1.0, background_intensity=(0.0, 0.0), poisson_noise=-1.0)
    cols = [simulator_validation.peak_columns(torch.as_tensor(np.array(
        trajectories_to_video(jax.random.key(2), step, 10, False, o)))) for o in (o100, o100.replace(resolution=200e-9))]
    out["check5_pixel_shift"] = {"at_100nm": cols[0][1] - cols[0][0], "at_200nm": cols[1][1] - cols[1][0]}
    snr = []
    for bg_std in simulator_validation.BG_SIGMAS:
        optics = J_OPTICS.replace(background_intensity=(1420.0, bg_std))
        t, _ = single_state(jax.random.key(3), 32, 300, Ds=(3.0, 0.0))
        vids = np.asarray(trajectories_to_video(jax.random.key(4), t / 100, 10, True, optics))
        peak, bg = float(vids.max(axis=(2, 3)).mean()), float(np.median(vids))
        snr.append({"bg_sigma": bg_std, "peak": peak, "bg": bg, "contrast": (peak - bg) / bg_std})
    out["check6_snr"] = snr

    example = _load(ROOT / "examples" / "simulator_validation.py", "example_simulator_validation")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        example.main()
    text = printed.getvalue()
    for k in ("check2_loop_closure", "check3_coarse_sampling", "check4_localization_noise"):
        assert f"D={out[k]['mean']:.3f}" in text, (k, text)
    assert f"by {out['check5_pixel_shift']['at_100nm']} px at 100nm/px, " \
           f"{out['check5_pixel_shift']['at_200nm']} px at 200nm/px" in text
    for row in snr:
        assert f"contrast {row['contrast']:5.1f}σ" in text and f"peak {row['peak']:7.0f}" in text
    return out


def write_jax_records() -> None:
    """Write the two committed JAX records (see the module docstring)."""
    JAX_MSD_ROWS.parent.mkdir(parents=True, exist_ok=True)
    JAX_MSD_ROWS.write_text(json.dumps(jax_msd_rows(), indent=1) + "\n")
    JAX_SIMVAL.parent.mkdir(parents=True, exist_ok=True)
    JAX_SIMVAL.write_text(json.dumps(jax_simulator_report(), indent=1) + "\n")


def test_simulator_checks_one_and_five_equal_jax(tmp_path, capsys):
    """``simulator_validation.main --device cpu`` prints the example's lines
    and writes its report; checks 1 (the label layout) and 5 (the 2:1 pixel
    shift) equal JAX's exactly, as recomputed here and as committed in
    ``results/simulator_validation/jax_report.json``; checks 2-4 report a
    standard error beside each mean, and the contrast falls with the
    background σ."""
    from moleculardiffusion_mivit_tpu.config import BASELINE_OPTICS as J_OPTICS
    from moleculardiffusion_mivit_tpu.sim import single_state as j_single_state
    from moleculardiffusion_mivit_tpu.sim import trajectories_to_video as j_video

    report = simulator_validation.main(["--device", "cpu", "--out", str(tmp_path)])
    text = capsys.readouterr().out
    assert "loop closure: true D=5.0" in text and "resolution scaling: 200nm jump moves peak by 2 px" in text
    assert json.loads((tmp_path / "simulator_validation.json").read_text()) == json.loads(json.dumps(report))
    _, labels = j_single_state(jax.random.key(0), 5, 50, Ds=(3.0, 1.0), alphas=1)
    assert report["check1_label_layout"] == simulator_validation.label_layout(torch.as_tensor(np.array(labels)))
    step = jnp.zeros((1, 20, 2)).at[:, 10:, 0].set(200.0)
    o100 = J_OPTICS.replace(trajectory_unit=1.0, background_intensity=(0.0, 0.0), poisson_noise=-1.0)
    cols = [simulator_validation.peak_columns(torch.as_tensor(np.array(j_video(jax.random.key(2), step, 10, False, o))))
            for o in (o100, o100.replace(resolution=200e-9))]
    assert report["check5_pixel_shift"] == {"at_100nm": cols[0][1] - cols[0][0], "at_200nm": cols[1][1] - cols[1][0]}
    assert report["check5_pixel_shift"] == {"at_100nm": 2, "at_200nm": 1}
    committed = json.loads(JAX_SIMVAL.read_text())
    for k in ("check1_label_layout", "check5_pixel_shift"):
        assert committed[k] == report[k], k
    for k in ("check2_loop_closure", "check3_coarse_sampling", "check4_localization_noise"):
        assert report[k]["n"] == 500 and 0 < report[k]["se"] < 0.2
    contrast = [r["contrast"] for r in report["check6_snr"]]
    assert all(a > b for a, b in zip(contrast, contrast[1:]))


# ---------------------------------------------------------------- the gallery

def test_gallery_renderers_equal_jax_given_the_trajectories(monkeypatch, tmp_path):
    """Given the same trajectories and optics without noise (a particle
    intensity spread of 2e-4, no background, no shot noise), the renderers
    behind ``poster_gallery`` (the four-variant renderer's noise-free and
    background variants, ``trajectories_to_video`` and the normalisation)
    equal JAX's at 1e-5 of the frames' scale; ``gallery`` gives every D its
    trajectory, four variants and normalised frames; ``main`` without
    matplotlib raises, naming it, on the device it was given."""
    from moleculardiffusion_mivit_tpu.config import BASELINE_OPTICS as J_OPTICS
    from moleculardiffusion_mivit_tpu.sim import render as jrender

    quiet = dict(particle_intensity=(BASELINE_OPTICS.particle_intensity[0], 2e-4), background_intensity=(0.0, 0.0))
    trajs = tval.generate_in_order_imft()[::33, :1, :300].reshape(-1, 300, 2) / 100.0
    g = seeded_generator("cpu", 5)
    got = trajectories_to_video_multiple_settings(g, torch.as_tensor(trajs, dtype=torch.float32), 10, True,
                                                  BASELINE_OPTICS.replace(**quiet))
    want = jrender.trajectories_to_video_multiple_settings(jax.random.key(5), jnp.asarray(trajs, jnp.float32), 10,
                                                           True, J_OPTICS.replace(**quiet))
    for i in (0, 1):  # the shot-noise and filtered variants draw Poisson counts
        scale = float(np.abs(np.asarray(want[i])).max())
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-5 * scale, err_msg=str(i))
    vid = trajectories_to_video(g, torch.as_tensor(trajs, dtype=torch.float32), 10, True,
                                BASELINE_OPTICS.replace(**quiet, poisson_noise=-1.0))
    jvid = jrender.trajectories_to_video(jax.random.key(6), jnp.asarray(trajs, jnp.float32), 10, True,
                                         J_OPTICS.replace(**quiet, poisson_noise=-1.0))
    np.testing.assert_allclose(vid.numpy(), np.asarray(jvid), rtol=0, atol=1e-5 * float(np.abs(jvid).max()))
    args = (1420.0, 290.0, 5500.0)
    np.testing.assert_allclose(normalize_images(vid, *args)[0].numpy(),
                               np.asarray(jrender.normalize_images(jvid, *args)[0]), rtol=1e-5, atol=1e-6)

    out = poster_gallery.gallery(0, "cpu")
    assert list(out) == list(poster_gallery.D_VALUES)
    for d, parts in out.items():
        assert parts["traj"].shape == (300, 2) and parts["frames"].shape == (30, 9, 9)
        assert [v.shape for v in parts["variants"]] == [(30, 9, 9)] * 4 and np.isfinite(parts["frames"]).all()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        poster_gallery.main(["--device", "cpu", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------- entry points and the verdict

@pytest.mark.parametrize("mod,argv", [(tta_rescore, ["RUN"]), (seed_ensemble, ["RUN"]), (render_noise, ["RUN"]),
                                      (msd_protocol, []), (simulator_validation, []), (poster_gallery, [])])
def test_entry_points_need_a_card_or_the_cpu(mod, argv, tmp_path, monkeypatch):
    """Without ``--device`` every entry point asks for the card and raises
    where there is none, before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([*argv, *(["--out", str(tmp_path / "o")] if mod is not tta_rescore else [])])
    assert not (tmp_path / "o").exists()


@pytest.fixture(scope="module")
def outcome():
    return _load(ROOT / "rescore_outcome.py", "rescore_outcome")


def test_rescore_studies_on_the_card_judged_by_the_rule(outcome):
    """The committed card reports (four f32 seeds of ``run_experiment
    images_features --cycles 150 --seqs-per-d 256 --in-order`` and the
    studies over them, NVIDIA H100) judged by R1-R2, S1-S2, T1-T2, M1, V1
    and F8-M/F8-V (over the port's eight ``ft_mlp`` members) give the
    committed verdict; a copy with ``ensemble_render_mean`` moved by 0.05
    misses R1."""
    reports = outcome.load()
    verdict = outcome.judge(reports)
    committed = json.loads((ROOT / "results" / "rescore_outcome" / "verdict.json").read_text())
    assert json.loads(json.dumps(verdict)) == committed
    assert set(verdict["held"]) == {"R1_grand_mean", "R1_ensemble", "R2", "S1", "S2", "T1", "T2", "M1", "V1",
                                    "f8_M", "f8_V"}
    assert all("H100" in c for c in verdict["cards"])
    moved = copy.deepcopy(reports)
    moved["render_noise"]["ensemble_render_mean"] += 0.05
    bad = outcome.judge(moved)
    assert not bad["held"]["R1_ensemble"] and not bad["ok"]


def test_outcome_rules_hold_and_miss_on_synthetic_numbers(outcome):
    """Each spread rule on numbers built to lie just inside and just outside
    its limit, and R2's bands at their edges."""
    tight = [0.500, 0.502, 0.498, 0.500, 0.500]  # 3·sd·sqrt(1.2) < 0.02: the floor applies
    held = outcome._spread(tight, 0.50 + 0.0199, 0.02)
    assert held["held"] and held["limit"] == 0.02
    assert not outcome._spread(tight, 0.50 + 0.0201, 0.02)["held"]
    wide = outcome._spread([0.40, 0.60, 0.50, 0.50], 0.50, 0.03)
    assert abs(wide["limit"] - 3 * np.std([0.4, 0.6, 0.5, 0.5], ddof=1) * np.sqrt(1.25)) < 1e-12
    jax_rn = {"grand_mean": 0.4803, "render_sigma_of_seed_mean": 0.011, "seed_sigma_at_fixed_render": 0.0022,
              "ensemble_render_mean": 0.4768, "ensemble_render_std": 0.011}
    port = {"grand_mean": 0.4803, "render_sigma_of_seed_mean": 0.011, "seed_sigma_at_fixed_render": 0.0022,
            "ensemble_render_mean": 0.4768, "ensemble_render_std": 0.011, "per_render_seed_mean": [0.0] * 5,
            "mse_matrix_seed_x_render": [], "ensemble_mse_per_render": []}
    assert outcome.judge_render_noise(port, jax_rn)["R2"]["held"]
    for key, factor in (("render_sigma_of_seed_mean", 3.2), ("seed_sigma_at_fixed_render", 0.25)):
        off = dict(port, **{key: port[key] * factor})
        assert not outcome.judge_render_noise(off, jax_rn)["R2"]["held"], key
    assert re.match(r"regenerated, +100 D", outcome.CLOSEST_SUITE)


def test_f8_rules_hold_and_miss_on_synthetic_numbers(outcome):
    """F8-M and F8-V (``rescore_outcome.py``'s docstring) on eight port and
    four JAX members: a port spread like JAX's about a mean 0.01 higher
    holds both; the same members 0.1 higher miss F8-M alone; the port's
    members spread 5× wider about the same mean miss F8-V alone."""
    jax_m = [0.8404, 0.8385, 0.8857, 0.8261]
    base = np.array([0.83, 0.85, 0.87, 0.89, 0.84, 0.86, 0.88, 0.82])
    held = outcome.judge_f8((base + 0.01).tolist(), jax_m)
    assert held["f8_M"]["held"] and held["f8_V"]["held"]
    sd_p, sd_j = np.std(base, ddof=1), np.std(jax_m, ddof=1)
    assert held["f8_M"]["limit"] == pytest.approx(max(0.02, 3 * np.sqrt(sd_p**2 / 8 + sd_j**2 / 4)))
    assert held["f8_V"]["variance_ratio"] == pytest.approx(sd_p**2 / sd_j**2)
    from scipy.stats import f as f_dist

    assert held["f8_V"]["band"] == pytest.approx([f_dist.ppf(0.025, 7, 3), f_dist.ppf(0.975, 7, 3)], rel=1e-12)
    far = outcome.judge_f8((base + 0.1).tolist(), jax_m)
    assert not far["f8_M"]["held"] and far["f8_V"]["held"]
    wide = outcome.judge_f8((base.mean() + 5 * (base - base.mean())).tolist(), jax_m)
    assert wide["f8_M"]["held"] and not wide["f8_V"]["held"]


def test_f8_verdict_on_the_card_seeds(outcome):
    """The committed verdict's ``f8_*`` keys, read as the test above reads
    the others: the ``ft_mlp`` rows of the port's eight f32 card seeds
    (``results/torch_images_features_seed0-7``) and JAX's four, as the
    committed CSVs give them, judged by F8-M and F8-V."""
    reports = outcome.load()
    committed = json.loads((ROOT / "results" / "rescore_outcome" / "verdict.json").read_text())
    assert len(reports["f8_port"]) == 8 and len(reports["f8_jax"]) == 4
    assert committed["f8_M"]["port"] == reports["f8_port"] and committed["f8_M"]["jax"] == reports["f8_jax"]
    assert reports["f8_jax"] == [0.840386, 0.838508, 0.885699, 0.826104]
    assert reports["f8_port"][:4] == [0.853975, 0.84469, 0.9289, 0.869101]
    judged = outcome.judge_f8(reports["f8_port"], reports["f8_jax"])
    assert json.loads(json.dumps(judged)) == {k: committed[k] for k in ("f8_M", "f8_V")}
    assert {k: committed["held"][k] for k in ("f8_M", "f8_V")} == {k: judged[k]["held"] for k in judged}
    assert not committed["held"]["S1"]  # S1's miss stands; nothing is re-judged
