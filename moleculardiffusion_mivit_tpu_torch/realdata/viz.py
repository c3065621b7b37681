"""Visualization helpers (matplotlib).

Port of ``moleculardiffusion_mivit_tpu/realdata/viz.py`` (numpy and
matplotlib only; the port keeps its own copy). matplotlib is imported inside
each function, so the module imports on a machine without it. Parity
targets: helpers/helpersPlot.py (``play_video``,
``plot1ParticleTrajectory``, ``show_plt``) and the tracking visualizations of
helpers/helpersTracking.py:62-111, 343-431, 687-781 (``visualize_dog_detection``,
``visualize_tracks``, ``plot_comparison_with_std``, feature-correlation
heatmap). All functions return the figure (and optionally animation) instead
of calling ``plt.show`` so they work headless; pass ``show=True`` for
interactive use.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def show_plt(fig=None, show: bool = False):
    plt = _plt()
    if show:  # pragma: no cover - interactive
        plt.show()
    return fig


def plot_particle_trajectory(trajectory: np.ndarray, title: str = "Trajectory", show=False):
    """Single-particle 2-D path with start/end markers
    (helpersPlot.plot1ParticleTrajectory)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(trajectory[:, 0], trajectory[:, 1], lw=0.8)
    ax.scatter(*trajectory[0], c="g", label="start", zorder=3)
    ax.scatter(*trajectory[-1], c="r", label="end", zorder=3)
    ax.set_title(title)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.legend()
    ax.set_aspect("equal")
    return show_plt(fig, show)


def play_video(
    video: np.ndarray,
    interval_ms: int = 100,
    cmap: str = "gray",
    show=False,
    save_path: Optional[str] = None,
    tracks: Optional[Dict[int, List[Tuple[int, float, float]]]] = None,
):
    """Animate a (F, H, W) stack (helpersPlot.play_video /
    helpersTracking.play_video), optionally overlaying growing track traces
    (the reference's animated track player, helpersTracking.py:343-431).
    ``save_path`` ending in .gif exports via Pillow (no ffmpeg needed).
    Returns (fig, animation)."""
    plt = _plt()
    from matplotlib import animation

    video = np.asarray(video)
    fig, ax = plt.subplots()
    im = ax.imshow(video[0], cmap=cmap)
    ax.axis("off")
    lines = {}
    if tracks:
        colors = plt.get_cmap("tab20")
        for tid in tracks:
            (lines[tid],) = ax.plot([], [], "-", color=colors(tid % 20), lw=1)

    def update(i):
        im.set_data(video[i])
        ax.set_title(f"frame {i}")
        artists = [im]
        if tracks:
            for tid, positions in tracks.items():
                arr = np.asarray([(x, y) for fr, y, x in positions if fr <= i])
                if len(arr):
                    lines[tid].set_data(arr[:, 0], arr[:, 1])
                artists.append(lines[tid])
        return tuple(artists)

    anim = animation.FuncAnimation(fig, update, frames=len(video), interval=interval_ms)
    if save_path:
        writer = "pillow" if save_path.endswith(".gif") else None
        anim.save(save_path, writer=writer, fps=max(int(1000 / interval_ms), 1))
    show_plt(fig, show)
    return fig, anim


def visualize_dog_detection(original, dog, coordinates, show=False):
    """Original / DoG / detections triptych (helpersTracking.py:62-111)."""
    plt = _plt()
    from matplotlib.patches import Circle

    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    axes[0].imshow(original, cmap="gray")
    axes[0].set_title("Original Image")
    im = axes[1].imshow(dog, cmap="viridis")
    axes[1].set_title("DoG Filtered Image")
    fig.colorbar(im, ax=axes[1], fraction=0.046, pad=0.04)
    axes[2].imshow(original, cmap="gray")
    axes[2].set_title(f"Detected Particles ({len(coordinates)})")
    for y, x in coordinates:
        axes[2].add_patch(Circle((x, y), radius=3, color="red", fill=False, lw=1.5))
    for ax in axes:
        ax.axis("off")
    return show_plt(fig, show)


def visualize_tracks(
    image_sequence: np.ndarray,
    tracks: Dict[int, List[Tuple[int, float, float]]],
    frame: Optional[int] = None,
    show=False,
):
    """Tracks overlaid on a background frame (helpersTracking.visualize_tracks)."""
    plt = _plt()
    frame = frame if frame is not None else len(image_sequence) - 1
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(image_sequence[frame], cmap="gray")
    cmap = plt.get_cmap("tab20")
    for tid, positions in tracks.items():
        arr = np.asarray(positions)
        ax.plot(arr[:, 2], arr[:, 1], "-", color=cmap(tid % 20), lw=1)
        ax.scatter(arr[-1, 2], arr[-1, 1], s=10, color=cmap(tid % 20))
    ax.set_title(f"{len(tracks)} tracks")
    ax.axis("off")
    return show_plt(fig, show)


def plot_comparison_with_std(df_a, df_b, columns: Sequence[str], labels=("A", "B"), show=False):
    """Mean ± std bars for selected columns of two track DataFrames
    (helpersTracking.plot_comparison_with_std)."""
    plt = _plt()
    fig, axes = plt.subplots(1, len(columns), figsize=(4 * len(columns), 4))
    axes = np.atleast_1d(axes)
    for ax, col in zip(axes, columns):
        means = [df_a[col].mean(), df_b[col].mean()]
        stds = [df_a[col].std(), df_b[col].std()]
        ax.bar(labels, means, yerr=stds, capsize=4)
        ax.set_title(col)
    fig.tight_layout()
    return show_plt(fig, show)


def plot_feature_correlation(df, columns: Optional[Sequence[str]] = None, show=False):
    """Correlation heatmap of track features
    (helpersTracking.computeCorrforFeaturesPlotCorr)."""
    plt = _plt()
    sub = df[list(columns)] if columns else df.select_dtypes("number")
    corr = sub.corr()
    fig, ax = plt.subplots(figsize=(0.6 * len(corr) + 2, 0.6 * len(corr) + 2))
    im = ax.imshow(corr.values, cmap="coolwarm", vmin=-1, vmax=1)
    ax.set_xticks(range(len(corr)), corr.columns, rotation=90)
    ax.set_yticks(range(len(corr)), corr.columns)
    for i in range(len(corr)):
        for j in range(len(corr)):
            ax.text(j, i, f"{corr.values[i, j]:.2f}", ha="center", va="center", fontsize=7)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return show_plt(fig, show)
