"""The port's change points, analysis, plots, ``--plots`` and real-data
plots against the JAX package, on the same inputs and artifacts."""

import builtins
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculardiffusion_mivit_tpu.evaluation import analysis as janalysis
from moleculardiffusion_mivit_tpu.evaluation import detect_change_points as j_detect
from moleculardiffusion_mivit_tpu.evaluation import plots as jplots
from moleculardiffusion_mivit_tpu.realdata import viz as jviz
from moleculardiffusion_mivit_tpu_torch import run_experiment
from moleculardiffusion_mivit_tpu_torch.evaluation import analysis as tanalysis
from moleculardiffusion_mivit_tpu_torch.evaluation import detect_change_points as t_detect
from moleculardiffusion_mivit_tpu_torch.evaluation import plots as tplots
from moleculardiffusion_mivit_tpu_torch.realdata import viz as tviz


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planted(seed=0, n=16, t=30):
    rng = np.random.default_rng(seed)
    preds = np.full((n, t), 1.0) + 0.2 * rng.normal(size=(n, t))
    splits = rng.integers(10, 20, size=n)
    for i, s in enumerate(splits):
        preds[i, s:] += 5.0
    return preds.astype(np.float32), splits


@pytest.mark.parametrize("case", ["planted", "constant", "noise", "margin"])
def test_detect_change_points_equals_jax(case):
    """Equal split indices and scores at 1e-5 relative, on the JAX tests'
    inputs (a planted jump, constant sequences) and on pure noise and a
    wider margin (JAX's jitted function traces ``min_margin``, so that case
    compiles its body with the margin static)."""
    rng = np.random.default_rng(1)
    margin = 3
    if case == "planted":
        preds, truth = _planted()
    elif case == "constant":
        preds = (3.0 + 0.3 * rng.normal(size=(16, 30))).astype(np.float32)
    elif case == "noise":
        preds = rng.normal(size=(40, 24)).astype(np.float32)
    else:
        preds, truth = _planted(2, 8, 40)
        margin = 8
    j_fn = jax.jit(j_detect.__wrapped__, static_argnames="min_margin")
    js, jscore = (np.asarray(v) for v in j_fn(jnp.asarray(preds), min_margin=margin))
    ts, tscore = t_detect(torch.from_numpy(preds), margin)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tscore.numpy(), jscore, rtol=1e-5)
    if case == "planted":
        assert (np.abs(ts.numpy() - truth) <= 1).mean() >= 0.9 and tscore.min() > 5.0
    if case == "constant":
        assert tscore.max() < 3.0
    if case == "margin":
        assert ts.min() >= margin and ts.max() <= 40 - margin


def _artifacts(path):
    """The JAX plot tests' artifacts, plus a changepoint report."""
    history = {"m1": {"val_avg": [3.0, 2.0, 1.0], "val_1": [1.0, 1.0, 1.0]}, "m2": {"val_avg": [4.0, 3.0, 2.0]}}
    (path / "history.json").write_text(json.dumps(history))
    (path / "demo_errors.csv").write_text(
        "model,mse,std\ntr_0_0,0.5,0.1\ntr_0_1,0.6,0.1\ntr_1_0,0.4,0.1\ntr_1_1,0.7,0.1\nres_0_0,0.9,0.2\n")
    (path / "empty_errors.csv").write_text("model,mse,std\n")
    rng = np.random.default_rng(0)
    np.savez_compressed(path / "in_order_predictions.npz", d_values=np.array([1.0, 2.0]),
                        m1=rng.uniform(0.5, 2.5, (2, 5)), m2=rng.uniform(0.5, 2.5, (2, 5)))
    (path / "inference_times.json").write_text(
        json.dumps({"tr_0_0": [1.5, 0.1], "res_0_0": [30.0, 2.0], "absent": [9.9, 0.0]}))
    arm = {"roc_auc": 0.9, "false_positive_rate": 0.05,
           "by_contrast": {f"dD={d}": {"n": 30, "detection_rate": r, "ci95": [r - 0.1, r + 0.1]}
                           for d, r in ((1, 0.2), (2, 0.5), (4, 0.9))}}
    (path / "changepoint_modular.json").write_text(json.dumps({"n_mixed": 60, "seed": 0, "mod_images": arm}))
    return history


def test_render_all_makes_jax_figures(tmp_path):
    """From the same artifacts the port's ``render_all`` makes JAX's figure
    keys under JAX's file names, each a non-empty PNG."""
    _artifacts(tmp_path)
    want = jplots.render_all(str(tmp_path), str(tmp_path / "jax"))
    got = tplots.render_all(str(tmp_path), str(tmp_path / "port"))
    assert set(got) == set(want) == {"history", "demo_bars", "heatmap_tr", "heatmap_res", "pred_vs_d", "violins",
                                     "accuracy_vs_cost", "changepoint_detection"}
    for name, path in got.items():
        assert os.path.basename(path) == os.path.basename(want[name])
        assert os.path.dirname(path) == str(tmp_path / "port") and os.path.getsize(path) > 0
    assert os.path.isdir(tplots.render_all(str(tmp_path))["history"].rsplit(os.sep, 1)[0])  # default <dir>/figures


def test_plot_refusals_and_msd_plot_as_jax(tmp_path):
    with pytest.raises(ValueError):
        tplots.plot_accuracy_vs_cost({"a": (1.0, 0.1)}, {"b": {"mse": 0.5}}, str(tmp_path / "x.png"))
    with pytest.raises(ValueError):
        tplots.plot_changepoint_detection({"cycles": 1}, str(tmp_path / "x.png"))
    with pytest.raises(ValueError):
        tplots.plot_error_bars({}, str(tmp_path / "x.png"))
    trajs = np.cumsum(np.random.default_rng(1).normal(0, 1.0, (20, 50, 2)), axis=1)
    assert os.path.getsize(tplots.plot_msd_vs_lag(trajs, str(tmp_path / "msd.png"), max_lag=10)) > 0
    np.testing.assert_array_equal(tplots._smooth([1.0, 5.0, 2.0, 8.0, 3.0, 4.0], 3),
                                  jplots._smooth([1.0, 5.0, 2.0, 8.0, 3.0, 4.0], 3))
    _artifacts(tmp_path)
    csv = str(tmp_path / "demo_errors.csv")
    assert tplots._load_error_csv(csv) == jplots._load_error_csv(csv)


def test_plots_main_lists_the_figures(tmp_path, capsys):
    _artifacts(tmp_path)
    tplots.main([str(tmp_path), "--out-dir", str(tmp_path / "f")])
    assert "history: " in capsys.readouterr().out
    empty = tmp_path / "empty"
    empty.mkdir()
    tplots.main([str(empty)])
    assert "no plottable artifacts" in capsys.readouterr().out


def test_analysis_tables_and_poster_comparison_as_jax(tmp_path, monkeypatch):
    """``load_history``, ``final_val_table``, ``best_val_table`` as JAX's;
    without a poster directory both sides give ``None`` / ``{}``; given one,
    the parse and the comparison equal JAX's."""
    history = _artifacts(tmp_path)
    history["m3"] = {"val_avg": []}
    (tmp_path / "history.json").write_text(json.dumps(history))
    h = tanalysis.load_history(str(tmp_path))
    assert h == janalysis.load_history(str(tmp_path))
    assert tanalysis.final_val_table(h) == janalysis.final_val_table(h) == {"m1": 1.0, "m2": 2.0}
    assert tanalysis.best_val_table(h) == janalysis.best_val_table(h)
    monkeypatch.setattr(janalysis, "REFERENCE_POSTER_DIR", str(tmp_path / "absent"))
    assert tanalysis.load_reference_poster_csv() is None and janalysis.load_reference_poster_csv() is None
    assert tanalysis.compare_with_poster({"im_tr": {"mse": 1.0}}) == {}
    poster = tmp_path / "poster"
    poster.mkdir()
    (poster / "poster-model_errors-final.csv").write_text(
        "model,mse,std\nMSD,1.28,0.2\nViT,0.6,0.1\nMiViT,0.47,0.1\nbad,x,y\n,1,2\nCNN,0.0,0.1\n")
    monkeypatch.setattr(janalysis, "REFERENCE_POSTER_DIR", str(poster))
    ours = {"im_tr": {"mse": 0.55}, "im_ft_early_tr": {"mse": 0.5}, "MSD_Frame": {"mse": 1.3}, "im_resnet": {"mse": 1}}
    assert tanalysis.load_reference_poster_csv(poster_dir=str(poster)) == janalysis.load_reference_poster_csv()
    assert tanalysis.compare_with_poster(ours, poster_dir=str(poster)) == janalysis.compare_with_poster(ours)
    assert tanalysis.POSTER_NAME_MAP == janalysis.POSTER_NAME_MAP


def _no_matplotlib(monkeypatch):
    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kwargs)

    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", fake)


def test_plots_flag_raises_at_parsing_without_matplotlib(monkeypatch, tmp_path):
    """``--plots`` on a machine where matplotlib does not import raises when
    the arguments are parsed: nothing is built and no output directory is
    made (the card machine has no matplotlib)."""
    _no_matplotlib(monkeypatch)
    out = tmp_path / "run"
    with pytest.raises(RuntimeError, match="matplotlib"):
        run_experiment.main(["baseline", "--plots", "--device", "cpu", "--out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="matplotlib"):
        tplots.plot_history({"m": {"val_avg": [1.0]}}, str(tmp_path / "h.png"))


def test_realdata_viz_makes_jax_figures(tmp_path):
    """Each real-data plot of the port draws what JAX's draws on the same
    inputs: the axes, their titles, lines and patches; the GIF export."""
    import matplotlib.pyplot as plt
    import pandas as pd

    rng = np.random.default_rng(0)
    traj = np.cumsum(rng.normal(size=(30, 2)), axis=0)
    video = rng.uniform(size=(4, 16, 16)).astype(np.float32)
    tracks = {0: [(0, 3.0, 4.0), (1, 3.5, 4.5), (2, 4.0, 5.0)], 3: [(1, 10.0, 9.0), (2, 10.5, 9.5)]}
    df_a = pd.DataFrame({"a": rng.normal(size=20), "b": rng.normal(size=20), "c": rng.normal(size=20)})
    df_b = df_a * 2.0

    def summary(fig):
        return [(ax.get_title(), len(ax.lines), len(ax.patches), len(ax.images), len(ax.texts)) for ax in fig.axes]

    cases = [
        ("plot_particle_trajectory", (traj,), {}),
        ("visualize_dog_detection", (video[0], video[1], [(3, 4), (8, 9)]), {}),
        ("visualize_tracks", (video, tracks), {}),
        ("plot_comparison_with_std", (df_a, df_b, ["a", "b"]), {}),
        ("plot_feature_correlation", (df_a,), {}),
    ]
    for name, args, kw in cases:
        want, got = getattr(jviz, name)(*args, **kw), getattr(tviz, name)(*args, **kw)
        assert summary(got) == summary(want), name
        for a, b in zip(got.axes, want.axes):
            for la, lb in zip(a.lines, b.lines):
                np.testing.assert_array_equal(la.get_xydata(), lb.get_xydata())
    fig, anim = tviz.play_video(video, tracks=tracks, save_path=str(tmp_path / "v.gif"))
    assert os.path.getsize(tmp_path / "v.gif") > 0 and len(fig.axes[0].lines) == len(tracks)
    assert tviz.show_plt(fig) is fig
    plt.close("all")
