"""End-to-end real-data workflow: detect → track → patch → localise → D.

Port of ``moleculardiffusion_mivit_tpu/realdata/pipeline.py`` (the
reference's ``analyze_microscopy_sequence``, and the per-track inference of
its project report: patches fed to a trained model, beside the MSD
baseline).

``estimate_d_for_tracks`` batches same-length tracks, normalises their
patches with the training statistics on the device, runs the trained model
on them and adds the classical MSD(τ=1) estimate of the refined positions.
"""

from __future__ import annotations

import csv
import pickle
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch import resolve_device
from moleculardiffusion_mivit_tpu_torch.features.msd import d_from_msd_tau1
from moleculardiffusion_mivit_tpu_torch.realdata.patches import extract_particle_patches
from moleculardiffusion_mivit_tpu_torch.realdata.stats import tracks_to_dataframe
from moleculardiffusion_mivit_tpu_torch.realdata.track import track_particles
from moleculardiffusion_mivit_tpu_torch.sim import normalize_images

DETECTION_COLUMNS = ("frame", "y", "x", "track_id")


def analyze_microscopy_sequence(
    image_sequence: np.ndarray,
    sigma1: float = 1.0,
    sigma2: float = 2.0,
    threshold_percentage: float = 0.1,
    min_distance: int = 3,
    max_linking_distance: float = 15.0,
    min_track_length: int = 3,
    verbose: bool = False,
    output_prefix: Optional[str] = None,
    device=None,
):
    """Track particles across a sequence (detection on ``device``, CUDA
    unless the caller passes another). With ``output_prefix`` it writes
    ``<prefix>_detections.csv`` (columns frame, y, x, track_id) and
    ``<prefix>_tracks.pkl`` (the tracks dict), the reference's save path.

    Returns ``(tracks, detections, dog_images)``.
    """
    tracks, detections, dog_images = track_particles(
        image_sequence,
        sigma1=sigma1,
        sigma2=sigma2,
        threshold_percentage=threshold_percentage,
        min_distance=min_distance,
        max_linking_distance=max_linking_distance,
        min_track_length=min_track_length,
        verbose=verbose,
        device=device,
    )
    if output_prefix:
        with open(f"{output_prefix}_detections.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=DETECTION_COLUMNS)
            writer.writeheader()
            writer.writerows(detections)
        with open(f"{output_prefix}_tracks.pkl", "wb") as f:
            pickle.dump(tracks, f)
        print(f"Results saved with prefix: {output_prefix}")
    return tracks, detections, dog_images


def estimate_d_for_tracks(
    tracks: Dict[int, List[Tuple[int, float, float]]],
    image_sequence: np.ndarray,
    predict_fn: Callable[[torch.Tensor], torch.Tensor],
    patch_size: int = 9,
    background_mean: Optional[float] = None,
    background_sigma: Optional[float] = None,
    theoretical_max: Optional[float] = None,
    msd_calibration: float = 37.5 * 10.0,
    min_frames: int = 3,
    refined_positions: Optional[Dict] = None,
    device=None,
):
    """Per-track D estimates from a trained model and the MSD baseline.

    ``predict_fn(videos (B, T, S, S) on the device) -> (B, 1)`` returns
    predictions already rescaled to physical D units (``evaluate`` of
    ``train.loop.make_train_impls`` applies the ×D_max). ``msd_calibration``
    converts the pixel-domain MSD(τ=1) of the refined positions (or of the
    integer ones without ``refined_positions``) to D units. Tracks of one
    length go to ``predict_fn`` together, normalised on ``device`` (CUDA
    unless the caller passes another).

    Returns a dict track_id → {"d_model", "d_msd", "n_frames"}.
    """
    dev = resolve_device(device)
    patches = extract_particle_patches(np.asarray(image_sequence), tracks, patch_size)

    by_length: Dict[int, List[int]] = defaultdict(list)
    for tid, pos in tracks.items():
        if len(pos) >= min_frames:
            by_length[len(pos)].append(tid)

    results: Dict[int, dict] = {}
    for length, tids in sorted(by_length.items()):
        batch = torch.as_tensor(np.stack([patches[t] for t in tids]), device=dev)  # (B, L, S, S)
        norm, _ = normalize_images(batch, background_mean, background_sigma, theoretical_max)
        preds = predict_fn(norm).detach().cpu().numpy().reshape(len(tids), -1)
        if refined_positions is not None:
            pos = [[[refined_positions[(tid, int(f))][k] for k in ("x_refined", "y_refined")]
                    for f, _, _ in tracks[tid]] for tid in tids]
        else:
            pos = [[[x, y] for _, y, x in tracks[tid]] for tid in tids]
        msd1 = d_from_msd_tau1(torch.tensor(np.asarray(pos), dtype=torch.float32, device=dev)).cpu().numpy()
        for bi, tid in enumerate(tids):
            results[tid] = {
                "d_model": float(preds[bi].mean()),
                "d_msd": float(msd1[bi]) * msd_calibration,
                "n_frames": length,
            }
    return results


def full_pipeline_dataframe(image_sequence: np.ndarray, patch_size: int = 9, device=None, **track_kwargs):
    """Track → patches → annotated DataFrame (the reference's
    ``tracks_to_dataframe`` flow), on ``device``."""
    tracks, _, _ = analyze_microscopy_sequence(image_sequence, device=device, **track_kwargs)
    patches = extract_particle_patches(np.asarray(image_sequence), tracks, patch_size)
    df = tracks_to_dataframe(tracks, patches, patch_size, device)
    return tracks, patches, df
