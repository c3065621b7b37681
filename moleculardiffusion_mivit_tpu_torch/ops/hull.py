"""Convex hull area of small point sets, batched.

Port of ``moleculardiffusion_mivit_tpu/ops/hull.py`` (the hull-area
feature): a Jarvis gift wrap of ``n`` steps with a shoelace sum. The JAX
function picks each next hull point by a sequential scan over the
candidates; here every point set of the batch takes one step at once, and
the scan becomes one vectorised choice: the lowest-indexed candidate that no
other point beats under the same ``better`` test (which is where the scan
ends, since the test orders the points around a hull vertex). Among
collinear candidates the farthest wins, so the wrap visits vertices only,
and coincident candidates tie, so the area does not depend on which one is
taken. Every set runs all ``n`` steps; a ``done`` mask stops its sum once
the wrap is back at the start. Collinear or coincident sets give area 0.
"""

from __future__ import annotations

import torch


def convex_hull_area(points: torch.Tensor) -> torch.Tensor:
    """Area of the convex hull of each point set ``(N, n, 2)`` → ``(N,)``."""
    pts = points.to(torch.float32)
    num, n, _ = pts.shape
    rows = torch.arange(num, device=pts.device)
    x, y = pts[..., 0], pts[..., 1]
    # lowest y, then lowest x, then lowest index: a hull vertex
    by_x = torch.sort(x, dim=1, stable=True).indices
    by_y = torch.sort(y.gather(1, by_x), dim=1, stable=True).indices
    start = by_x.gather(1, by_y[:, :1])[:, 0]
    index = torch.arange(n, device=pts.device)

    current = start
    done = torch.zeros(num, dtype=torch.bool, device=pts.device)
    area2 = torch.zeros(num, dtype=torch.float32, device=pts.device)
    for _ in range(n):
        c = pts[rows, current]  # (N, 2)
        rel = pts - c[:, None, :]  # (N, n, 2)
        dist = (rel * rel).sum(-1)  # (N, n)
        # cross[k, q, r] = (q - c) × (r - c): r beats q when it is clockwise
        # of c→q, or collinear and farther
        cross = rel[:, :, None, 0] * rel[:, None, :, 1] - rel[:, :, None, 1] * rel[:, None, :, 0]
        beats = (cross < 0) | ((cross == 0) & (dist[:, None, :] > dist[:, :, None]))
        other = index[None, :] != current[:, None]  # (N, n): candidates and challengers
        beaten = (beats & other[:, None, :]).any(dim=2)
        nxt = torch.argmax((other & ~beaten).to(torch.int8), dim=1)  # first unbeaten candidate
        p_nxt = pts[rows, nxt]
        seg = c[:, 0] * p_nxt[:, 1] - p_nxt[:, 0] * c[:, 1]
        area2 = torch.where(done, area2, area2 + seg)
        done = done | (nxt == start)
        current = nxt
    return area2.abs() / 2.0
