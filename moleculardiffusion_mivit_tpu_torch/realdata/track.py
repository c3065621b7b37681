"""Greedy multi-frame particle tracking.

Port of ``moleculardiffusion_mivit_tpu/realdata/track.py`` (the reference's
``track_particles``): detect every frame, link the active tracks to the
current detections, start tracks for unlinked detections, retire tracks that
missed a frame, keep those of ``min_track_length`` frames or more and number
them anew in order.

Detection runs for the whole stack at once on the device; the
variable-count linking loop stays on the host. ``track_particles.seconds``
holds the wall seconds of the last call's two parts, ``detect`` (device
work and the copy back included) and ``link``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from moleculardiffusion_mivit_tpu_torch.realdata.detect import detect_particles_stack
from moleculardiffusion_mivit_tpu_torch.realdata.link import link_particles

Track = List[Tuple[int, float, float]]  # (frame, y, x)


def track_particles(
    image_sequence: np.ndarray,
    sigma1: float = 1.0,
    sigma2: float = 2.0,
    threshold_percentage: float = 0.1,
    min_distance: int = 3,
    max_linking_distance: float = 15.0,
    min_track_length: int = 3,
    verbose: bool = False,
    device=None,
):
    """Returns ``(tracks, detections, dog_images)`` where tracks maps
    track_id → [(frame, y, x), ...], detections is a list of dicts
    (frame, y, x, track_id) and dog_images is the filtered stack. Detection
    runs on ``device`` (CUDA unless the caller passes another)."""
    t0 = time.perf_counter()
    coords_per_frame, dog_images = detect_particles_stack(
        np.asarray(image_sequence), sigma1, sigma2, threshold_percentage, min_distance, device
    )
    t1 = time.perf_counter()
    if verbose:
        for f, c in enumerate(coords_per_frame):
            print(f"Frame {f}: {len(c)} particles detected")

    tracks: Dict[int, Track] = {}
    active: Dict[int, Tuple[np.ndarray, int]] = {}  # id -> (pos, last_frame)
    detections: List[dict] = []
    next_id = 0

    for pos in coords_per_frame[0]:
        tracks[next_id] = [(0, float(pos[0]), float(pos[1]))]
        active[next_id] = (pos, 0)
        detections.append({"frame": 0, "y": float(pos[0]), "x": float(pos[1]), "track_id": next_id})
        next_id += 1

    for frame_idx in range(1, len(coords_per_frame)):
        coords_current = coords_per_frame[frame_idx]
        track_ids = list(active.keys())
        coords_prev = np.asarray([active[t][0] for t in track_ids]).reshape(-1, 2)

        if len(coords_prev) > 0 and len(coords_current) > 0:
            links, _, unlinked_current = link_particles(
                coords_prev, coords_current, max_distance=max_linking_distance
            )
            for prev_idx, cur_idx in links:
                tid = track_ids[prev_idx]
                pos = coords_current[cur_idx]
                tracks[tid].append((frame_idx, float(pos[0]), float(pos[1])))
                active[tid] = (pos, frame_idx)
                detections.append(
                    {"frame": frame_idx, "y": float(pos[0]), "x": float(pos[1]), "track_id": tid}
                )
            new_idxs = unlinked_current
        else:
            new_idxs = range(len(coords_current))

        for idx in new_idxs:
            pos = coords_current[idx]
            tracks[next_id] = [(frame_idx, float(pos[0]), float(pos[1]))]
            active[next_id] = (pos, frame_idx)
            detections.append(
                {"frame": frame_idx, "y": float(pos[0]), "x": float(pos[1]), "track_id": next_id}
            )
            next_id += 1

        # retire tracks not updated this frame
        for tid in [t for t, (_, last) in active.items() if last < frame_idx]:
            del active[tid]

    long_tracks = {k: v for k, v in tracks.items() if len(v) >= min_track_length}
    mapping = {old: new for new, old in enumerate(sorted(long_tracks))}
    reindexed = {mapping[k]: v for k, v in long_tracks.items()}
    for det in detections:
        det["track_id"] = mapping.get(det["track_id"], det["track_id"])
    print(
        f"Tracking complete: {len(tracks)} total tracks, "
        f"{len(reindexed)} tracks with ≥{min_track_length} frames"
    )
    track_particles.seconds = {"detect": t1 - t0, "link": time.perf_counter() - t1}
    return reindexed, detections, dog_images


track_particles.seconds = {}
