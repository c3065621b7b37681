"""Per-track statistics and the tracks DataFrame.

Port of ``moleculardiffusion_mivit_tpu/realdata/stats.py`` (the
reference's ``tracks_to_dataframe`` / ``compute_displacement``): rows
indexed by ``(track_id, frame)`` with the columns nbr_frames, x, y,
x_refined, y_refined, psf_size, max_intensity, displacement,
mean_displacement, mean_psf_size, max_intensity_over_track,
mean_max_intensity_over_track, std_max_intensity_over_track.

The columns are computed in numpy (``track_columns``,
``displacement_columns``); only ``tracks_to_dataframe`` and
``compute_displacement`` build a pandas DataFrame, and import pandas inside
the function, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from moleculardiffusion_mivit_tpu_torch.realdata.localize import refine_localizations

REFINED = ("x_refined", "y_refined", "psf_size", "max_intensity")


def displacement_columns(track_id, x_refined, y_refined, psf_size, max_intensity) -> Dict[str, np.ndarray]:
    """The per-step displacement (0 at a track's first frame) and the
    per-track aggregates, broadcast to every row, from rows sorted by
    (track_id, frame): the mean displacement and PSF size, and the max, mean
    and standard deviation (ddof = 1, NaN for one row, as pandas) of the
    max intensity."""
    track_id = np.asarray(track_id)
    x, y = np.asarray(x_refined, np.float64), np.asarray(y_refined, np.float64)
    psf, peak = np.asarray(psf_size, np.float64), np.asarray(max_intensity, np.float64)
    first = np.ones(len(track_id), bool)
    first[1:] = track_id[1:] != track_id[:-1]
    disp = np.zeros(len(track_id))
    step = ~first
    disp[step] = np.sqrt(np.diff(x)[step[1:]] ** 2 + np.diff(y)[step[1:]] ** 2)

    cols = {k: np.empty(len(track_id)) for k in (
        "mean_displacement", "mean_psf_size", "max_intensity_over_track", "mean_max_intensity_over_track",
        "std_max_intensity_over_track")}
    starts = np.flatnonzero(first)
    for a, b in zip(starts, np.append(starts[1:], len(track_id))):
        rows = slice(a, b)
        cols["mean_displacement"][rows] = disp[rows].mean()
        cols["mean_psf_size"][rows] = psf[rows].mean()
        cols["max_intensity_over_track"][rows] = peak[rows].max()
        cols["mean_max_intensity_over_track"][rows] = peak[rows].mean()
        cols["std_max_intensity_over_track"][rows] = peak[rows].std(ddof=1) if b - a > 1 else np.nan
    return {"displacement": disp, **cols}


def track_columns(
    tracks: Dict[int, List[Tuple[int, float, float]]], refined: Dict[Tuple[int, int], dict]
) -> Dict[str, np.ndarray]:
    """Every column of the tracks table, rows sorted by (track_id, frame),
    from the tracks and their refined localisations
    (``refine_localizations``' dict)."""
    rows = sorted(
        (track_id, int(frame), len(positions), x, y)
        for track_id, positions in tracks.items()
        for frame, y, x in positions
    )
    track_id, frame, nbr, x, y = (np.asarray(v) for v in zip(*rows)) if rows else [np.zeros(0)] * 5
    cols = {"track_id": track_id.astype(np.int64), "frame": frame.astype(np.int64),
            "nbr_frames": nbr.astype(np.int64), "x": x.astype(np.float64), "y": y.astype(np.float64)}
    for col in REFINED:
        cols[col] = np.asarray([refined[(t, f)][col] for t, f in zip(cols["track_id"], cols["frame"])],
                               np.float64)
    cols.update(displacement_columns(cols["track_id"], *(cols[c] for c in REFINED)))
    return cols


def compute_displacement(df):
    """Add the per-step displacement (first step 0) and the per-track
    aggregates to a DataFrame indexed by (track_id, frame) that holds the
    refined columns; returns it sorted by its index."""
    df = df.reset_index().sort_values(["track_id", "frame"])
    cols = displacement_columns(df["track_id"].to_numpy(), *(df[c].to_numpy() for c in REFINED))
    for name, values in cols.items():
        df[name] = values
    return df.set_index(["track_id", "frame"]).sort_index()


def tracks_to_dataframe(
    tracks: Dict[int, List[Tuple[int, float, float]]],
    patches: Dict[int, np.ndarray],
    patch_size: int,
    device=None,
):
    """tracks + patches → the fully annotated DataFrame (the reference's
    column set); the localisation fit runs on ``device``."""
    import pandas as pd

    cols = track_columns(tracks, refine_localizations(tracks, patches, patch_size, device))
    return pd.DataFrame(cols).set_index(["track_id", "frame"])
