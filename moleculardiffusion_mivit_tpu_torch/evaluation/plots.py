"""Figures of a run's artifacts.

Port of ``moleculardiffusion_mivit_tpu/evaluation/plots.py``. The reference's analysis layer is notebook figures: PSF×noise MSE heatmaps
(Experiments/PSFNoise/train_resultsPSFNoise.ipynb cell 12-13), validation
loss-vs-cycle curves (train_resultsImagesFeatures.ipynb cell 0), model-error
bar charts with std bars (cell 9, ``plot_error_std``), prediction-vs-D
curves (cell 8), error violin/distribution plots
(tests/train_tests/train_results.ipynb), and the MSD-vs-lag helper
(helpers/helpersMSD.py:58-85). Here each figure is a function of the
*committed artifacts* a run leaves behind (``history.json``,
``*_errors.csv``, ``in_order_predictions.npz``), so every figure regenerates
with one command:

    python -m moleculardiffusion_mivit_tpu_torch.evaluation.plots results/psfnoise_r1

or at the end of a run via ``run_experiment ... --plots``. matplotlib is
imported inside each function (Agg backend), so the module imports on a
machine without it; ``require_matplotlib`` raises a clear error up front.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Sequence

import numpy as np


def require_matplotlib():
    """Import matplotlib with the Agg backend, or raise ``RuntimeError``
    saying the figures need it. Returns ``matplotlib.pyplot``."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(f"the figures need matplotlib, which does not import here: {e}") from e
    return plt


def _smooth(arr, n: int):
    if n <= 1 or len(arr) < n:
        return np.asarray(arr, float)
    pad = n // 2
    padded = np.pad(np.asarray(arr, float), pad, mode="edge")
    return np.convolve(padded, np.ones(n) / n, mode="valid")[: len(arr)]


def plot_history(
    history: Dict[str, Dict[str, list]],
    out_png: str,
    smooth: int = 5,
    clip: Optional[float] = None,
) -> str:
    """Validation-MSE-vs-cycle curves for every model
    (train_resultsImagesFeatures.ipynb cell 0: smoothed, clipped
    ``val_avg``)."""
    plt = require_matplotlib()
    plt.figure(figsize=(12, 5))
    for name, h in sorted(history.items()):
        curve = h.get("val_avg") or []
        if not curve:
            continue
        y = np.asarray(curve, float)
        if clip is not None:
            y = np.clip(y, 0, clip)
        plt.plot(_smooth(y, smooth), label=name, linewidth=1.5)
    plt.xlabel("Cycle")
    plt.ylabel("Validation MSE" + (f" (clipped at {clip:g})" if clip else ""))
    plt.title("Validation loss over training")
    plt.legend(fontsize=8, ncol=2)
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


def plot_error_bars(
    tables: Dict[str, Dict[str, float]], out_png: str, title: str = "Model prediction errors"
) -> str:
    """Bar chart of in-order MSE with std error bars
    (train_resultsImagesFeatures.ipynb cell 9, ``plot_error_std``)."""
    plt = require_matplotlib()
    names = list(tables)
    if not names:
        raise ValueError("plot_error_bars: empty error table")
    mse = [tables[n]["mse"] for n in names]
    std = [tables[n].get("std", 0.0) for n in names]
    plt.figure(figsize=(max(6, 0.9 * len(names)), 5))
    plt.bar(range(len(names)), mse, yerr=std, capsize=5, alpha=0.75)
    for i, (m, s) in enumerate(zip(mse, std)):
        plt.text(i, m + s + 0.01 * max(mse), f"{m:.2f}", ha="center", fontsize=8)
    plt.xticks(range(len(names)), names, rotation=90, fontsize=8)
    plt.ylabel("Mean squared error")
    plt.title(title)
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


def plot_psfnoise_heatmap(
    tables: Dict[str, Dict[str, float]],
    out_png: str,
    psf_settings: Sequence[float] = (2.0, 1.75, 1.5, 1.25, 1.0),
    noise_settings: Sequence[float] = (0.0, 1 / 50, 1 / 25, 1 / 20, 1 / 10, 1 / 5),
    family: str = "tr",
) -> str:
    """MSE heatmap over the PSF-size × SNR grid
    (train_resultsPSFNoise.ipynb cell 12: grid indexed ``{family}_{psf}_{noise}``,
    axes labeled PSF px = 2.5/setting and SNR = 1/noise)."""
    plt = require_matplotlib()
    n_psf, n_noise = len(psf_settings), len(noise_settings)
    grid = np.full((n_noise, n_psf), np.nan)
    for i in range(n_noise):
        for j in range(n_psf):
            t = tables.get(f"{family}_{j}_{i}")
            if t:
                grid[i, j] = t["mse"]
    plt.figure(figsize=(10, 6))
    im = plt.imshow(grid, cmap="RdYlGn_r", aspect="auto")
    for i in range(n_noise):
        for j in range(n_psf):
            if not np.isnan(grid[i, j]):
                plt.text(j, i, f"{grid[i, j]:.2f}", ha="center", va="center", fontsize=12)
    cbar = plt.colorbar(im, shrink=0.85)
    cbar.set_label("Mean squared error")
    plt.xticks(range(n_psf), [f"{2.5 / p:.2f}" for p in psf_settings])
    plt.yticks(
        range(n_noise),
        ["no noise"] + [f"{1 / n:.0f}" for n in noise_settings[1:]],
    )
    plt.xlabel("PSF size (pixels)")
    plt.ylabel("SNR")
    plt.title(f"MSE across PSF size and SNR ({family} family)")
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


def plot_prediction_vs_d(
    predictions: Dict[str, np.ndarray],
    d_values: np.ndarray,
    out_png: str,
    models: Optional[Sequence[str]] = None,
) -> str:
    """Mean prediction vs true D with a ground-truth diagonal
    (train_resultsImagesFeatures.ipynb cell 8,
    ``plot_model_predictions_vs_D_in_order``). ``predictions[name]`` is
    ``(n_d, n_particles)`` in physical D units."""
    plt = require_matplotlib()
    plt.figure(figsize=(10, 6))
    for name in models or sorted(predictions):
        preds = np.asarray(predictions[name])
        plt.plot(d_values, preds.mean(axis=1), label=name, linewidth=2)
    plt.plot(d_values, d_values, "k--", label="ground truth")
    plt.xlabel("True D")
    plt.ylabel("Predicted D")
    plt.title("Model predictions across D")
    plt.legend(fontsize=8)
    plt.grid(True, alpha=0.4)
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


def plot_error_violins(
    predictions: Dict[str, np.ndarray],
    d_values: np.ndarray,
    out_png: str,
    models: Optional[Sequence[str]] = None,
) -> str:
    """Violin plot of per-sequence prediction errors (pred − true D) per
    model (tests/train_tests/train_results.ipynb error-distribution plots)."""
    plt = require_matplotlib()
    names = list(models or sorted(predictions))
    errs = [
        (np.asarray(predictions[n]) - np.asarray(d_values)[:, None]).ravel()
        for n in names
    ]
    plt.figure(figsize=(max(6, 0.9 * len(names)), 5))
    parts = plt.violinplot(errs, showmedians=True)
    for pc in parts["bodies"]:
        pc.set_alpha(0.6)
    plt.axhline(0.0, color="k", linestyle="--", linewidth=0.8)
    plt.xticks(range(1, len(names) + 1), names, rotation=90, fontsize=8)
    plt.ylabel("Prediction error (D units)")
    plt.title("Error distributions over the in-order sweep")
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


def plot_msd_vs_lag(
    trajectories: np.ndarray,
    out_png: str,
    dt: float = 1.0,
    max_lag: Optional[int] = None,
    label: str = "mean MSD",
) -> str:
    """Mean MSD vs lag with the linear 4·D·τ guide
    (helpers/helpersMSD.py:58-85 ``computeAndPlotMeanMSD``)."""
    plt = require_matplotlib()
    import torch

    from moleculardiffusion_mivit_tpu_torch.features.msd import mean_square_displacements

    msds = mean_square_displacements(torch.as_tensor(np.asarray(trajectories), dtype=torch.float32)).numpy()
    mean_msd = msds.mean(axis=0)[1:]  # drop the zero lag (msd[:, 0] = 0)
    lags = np.arange(1, len(mean_msd) + 1) * dt
    if max_lag:
        lags, mean_msd = lags[:max_lag], mean_msd[:max_lag]
    d_est = mean_msd[0] / (4 * dt)
    plt.figure(figsize=(8, 5))
    plt.plot(lags, mean_msd, "o-", label=label, markersize=3)
    plt.plot(lags, 4 * d_est * lags, "k--", label=f"4·D·τ (D={d_est:.3g})")
    plt.xlabel("Lag τ")
    plt.ylabel("MSD")
    plt.title("Mean squared displacement vs lag")
    plt.legend()
    plt.grid(True, alpha=0.4)
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


def plot_accuracy_vs_cost(
    times: Dict[str, Sequence[float]],
    tables: Dict[str, Dict[str, float]],
    out_png: str,
    unit: str = "ms / 10k sequences",
) -> str:
    """Inference-cost vs accuracy scatter — the poster's time-vs-MSE figure
    (outPoster/poster_plots_final.ipynb cell 3 ``plot_time_vs_error``:
    log-x scatter of per-model prediction time with std error bars, each
    point labeled). ``times[name] = (mean, std)`` in ``unit``; accuracy
    comes from ``tables[name]["mse"]``. Models missing from either dict are
    skipped. The reference's published costs (MSD 0.429 ms … MiViT
    11600 ms per 10k images, unspecified GPU) are not directly comparable
    to the port's numbers; the *shape* of the tradeoff curve is the figure's point."""
    plt = require_matplotlib()
    # non-positive timings are sub-noise-floor slope measurements (see
    # examples/serving_benchmark.py --per-arm) — unusable on a log axis
    names = [n for n in times if n in tables and times[n][0] > 0]
    if not names:
        raise ValueError(
            f"plot_accuracy_vs_cost: no overlap between timed models "
            f"{sorted(times)} and error table {sorted(tables)}"
        )
    x = np.array([times[n][0] for n in names], float)
    xerr = np.array([float(times[n][1]) if len(times[n]) > 1 else 0.0 for n in names])
    y = np.array([tables[n]["mse"] for n in names], float)
    plt.figure(figsize=(7, 5))
    order = np.argsort(x)
    cmap = plt.get_cmap("viridis")
    for rank, i in enumerate(order):
        plt.errorbar(
            x[i], y[i], xerr=xerr[i], fmt="o", markersize=9,
            color=cmap(rank / max(1, len(names) - 1)),
            markeredgecolor="gray", capsize=3,
        )
        plt.annotate(
            names[i], (x[i], y[i]), textcoords="offset points",
            xytext=(6, 6), fontsize=10,
        )
    plt.xscale("log")
    plt.xlabel(f"Inference time ({unit})")
    plt.ylabel("Mean squared error")
    plt.title("Prediction cost vs accuracy")
    plt.grid(True, alpha=0.4)
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


# Fixed arm order and colorblind-safe hues (Okabe-Ito blue/orange/green)
# for the changepoint study figures: identity follows the arm, never its
# rank, so filtered/partial reports keep stable colors.
_CHANGEPOINT_ARMS = [
    ("mod_images", "image-only", "#0072B2"),
    ("mod_both_concat", "+ per-frame tokens", "#E69F00"),
    ("mod_hybrid", "hybrid (+ global token)", "#009E73"),
]


def plot_changepoint_detection(report: Dict, out_png: str) -> str:
    """Detection rate vs planted ΔD contrast with 95% Wilson CIs, per arm —
    the round-5 changepoint study's headline figure
    (examples/sequence_changepoint_modular.py report format). The dashed
    line marks the arms' realized false-positive floor: a detection rate is
    only meaningful above it."""
    plt = require_matplotlib()
    plt.figure(figsize=(7.5, 4.5))
    fp_rates = []
    plotted = False
    for arm, label, color in _CHANGEPOINT_ARMS:
        r = report.get(arm)
        if not isinstance(r, dict) or "by_contrast" not in r:
            continue
        cells = {
            int(k.split("=")[1]): v
            for k, v in r["by_contrast"].items()
            if v.get("detection_rate") is not None and v.get("n", 0) > 0
        }
        if not cells:
            continue
        dds = sorted(cells)
        y = np.array([cells[d]["detection_rate"] for d in dds], float)
        lo = np.array(
            [cells[d].get("ci95", [c, c])[0] for d, c in zip(dds, y)], float
        )
        hi = np.array(
            [cells[d].get("ci95", [c, c])[1] for d, c in zip(dds, y)], float
        )
        auc = r.get("roc_auc")
        plt.errorbar(
            dds,
            y,
            yerr=[y - lo, hi - y],
            marker="o",
            markersize=5,
            linewidth=2,
            capsize=3,
            color=color,
            label=f"{label} (AUC {auc:.3f})" if auc is not None else label,
        )
        if r.get("false_positive_rate") is not None:
            fp_rates.append(r["false_positive_rate"])
        plotted = True
    if not plotted:
        raise ValueError("plot_changepoint_detection: no arm data in report")
    if fp_rates:
        plt.axhline(
            float(np.mean(fp_rates)), color="0.45", linestyle="--", linewidth=1
        )
        plt.text(
            plt.xlim()[0] + 0.05,
            float(np.mean(fp_rates)) + 0.015,
            "FP floor",
            ha="left",
            fontsize=8,
            color="0.35",
        )
    n_note = report.get("n_mixed")
    seed = report.get("seed")
    plt.xlabel("Planted D contrast (ΔD, rounded)")
    plt.ylabel("Detection rate @ ~5% FP (95% Wilson CI)")
    plt.title(
        "Change-point detection vs contrast"
        + (f" — {n_note} planted transitions" if n_note else "")
        + (f", seed {seed}" if seed is not None else "")
    )
    plt.ylim(-0.02, 1.05)
    plt.grid(alpha=0.25, linewidth=0.5)
    plt.legend(fontsize=9, loc="lower right")
    plt.tight_layout()
    plt.savefig(out_png, dpi=130)
    plt.close()
    return out_png


def _load_error_csv(path: str) -> Dict[str, Dict[str, float]]:
    out = {}
    with open(path) as f:
        f.readline()  # header
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 3 and parts[0]:
                try:
                    out[parts[0]] = {"mse": float(parts[1]), "std": float(parts[2])}
                except ValueError:
                    continue
    return out


def render_all(result_dir: str, out_dir: Optional[str] = None) -> Dict[str, str]:
    """Regenerate every applicable figure from a result directory's
    committed artifacts. Returns {figure name: png path}."""
    out_dir = out_dir or os.path.join(result_dir, "figures")
    os.makedirs(out_dir, exist_ok=True)
    made: Dict[str, str] = {}

    hist_path = os.path.join(result_dir, "history.json")
    if os.path.exists(hist_path):
        with open(hist_path) as f:
            history = json.load(f)
        finite = [
            v
            for h in history.values()
            for v in (h.get("val_avg") or [])
            if np.isfinite(v)
        ]
        clip = float(np.percentile(finite, 90)) if finite else None
        made["history"] = plot_history(
            history, os.path.join(out_dir, "val_mse_curves.png"), clip=clip
        )

    for fname in sorted(os.listdir(result_dir)):
        if fname.endswith("_errors.csv"):
            tables = _load_error_csv(os.path.join(result_dir, fname))
            stem = fname[: -len("_errors.csv")]
            if not tables:  # header-only/malformed CSV: skip, don't die at
                continue  # the end of a multi-hour run
            made[f"{stem}_bars"] = plot_error_bars(
                tables,
                os.path.join(out_dir, f"{stem}_error_bars.png"),
                title=f"{stem} in-order errors",
            )
            for family in ("tr", "res"):
                # PSF×noise grid rows are exactly "{family}_{psf}_{noise}"
                if any(re.fullmatch(rf"{family}_\d+_\d+", k) for k in tables):
                    made[f"heatmap_{family}"] = plot_psfnoise_heatmap(
                        tables,
                        os.path.join(out_dir, f"psfnoise_heatmap_{family}.png"),
                        family=family,
                    )

    times_path = os.path.join(result_dir, "inference_times.json")
    if os.path.exists(times_path):
        with open(times_path) as f:
            times = json.load(f)
        # pick the error table sharing the most model names with the timings
        best, overlap = None, 0
        for fname in sorted(os.listdir(result_dir)):
            if fname.endswith("_errors.csv"):
                t = _load_error_csv(os.path.join(result_dir, fname))
                n = sum(1 for k in times if k in t)
                if n > overlap:
                    best, overlap = t, n
        if best and overlap >= 2:
            made["accuracy_vs_cost"] = plot_accuracy_vs_cost(
                times, best, os.path.join(out_dir, "accuracy_vs_cost.png")
            )

    cp_path = os.path.join(result_dir, "changepoint_modular.json")
    if os.path.exists(cp_path):
        with open(cp_path) as f:
            cp_report = json.load(f)
        try:
            made["changepoint_detection"] = plot_changepoint_detection(
                cp_report, os.path.join(out_dir, "detection_vs_contrast.png")
            )
        except ValueError:
            pass  # report predates the CI format

    preds_path = os.path.join(result_dir, "in_order_predictions.npz")
    if os.path.exists(preds_path):
        with np.load(preds_path) as z:
            d_values = z["d_values"]
            preds = {k: z[k] for k in z.files if k != "d_values"}
        made["pred_vs_d"] = plot_prediction_vs_d(
            preds, d_values, os.path.join(out_dir, "prediction_vs_d.png")
        )
        made["violins"] = plot_error_violins(
            preds, d_values, os.path.join(out_dir, "error_violins.png")
        )
    return made


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("result_dir", help="e.g. results/psfnoise_r1")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    made = render_all(args.result_dir, args.out_dir)
    for name, path in made.items():
        print(f"{name}: {path}")
    if not made:
        print(f"no plottable artifacts found in {args.result_dir}")


if __name__ == "__main__":
    main()
