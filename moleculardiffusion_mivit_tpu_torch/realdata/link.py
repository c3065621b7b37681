"""Frame-to-frame particle linking by optimal assignment.

Port of ``moleculardiffusion_mivit_tpu/realdata/link.py`` (the reference's
``link_particles``): the dense pairwise Euclidean cost, the Hungarian
assignment of ``scipy.optimize.linear_sum_assignment``, and a cut of links
longer than ``max_distance``. Detections a frame are tens, so this runs on
the host.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


def link_particles(
    coords_t0: np.ndarray, coords_t1: np.ndarray, max_distance: float = 15.0
) -> Tuple[List[Tuple[int, int]], List[int], List[int]]:
    """Returns ``(links [(i0, i1)...], unlinked_t0, unlinked_t1)``."""
    coords_t0 = np.asarray(coords_t0, np.float64).reshape(-1, 2)
    coords_t1 = np.asarray(coords_t1, np.float64).reshape(-1, 2)
    if len(coords_t0) == 0 or len(coords_t1) == 0:
        return [], list(range(len(coords_t0))), list(range(len(coords_t1)))

    diff = coords_t0[:, None, :] - coords_t1[None, :, :]
    cost = np.sqrt((diff**2).sum(-1))
    rows, cols = linear_sum_assignment(cost)

    links = []
    unlinked_t0 = list(range(len(coords_t0)))
    unlinked_t1 = list(range(len(coords_t1)))
    for i, j in zip(rows, cols):
        if cost[i, j] <= max_distance:
            links.append((int(i), int(j)))
            unlinked_t0.remove(int(i))
            unlinked_t1.remove(int(j))
    return links, unlinked_t0, unlinked_t1
