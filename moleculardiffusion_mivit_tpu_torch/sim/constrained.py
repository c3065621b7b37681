"""Constrained diffusion simulators (mitochondria geometry).

Port of ``moleculardiffusion_mivit_tpu/sim/constrained.py``:

- ``Edge`` / ``PiecewiseLinearGeometry``: a connected piecewise-linear path
  with cumulative-length position lookup, and ``map_displacements``: 1-D
  diffusion along the path, the arclength clamped at the path's ends at
  every step;
- ``disp_fbm``: fractional Gaussian displacements scaled ``sqrt(2·D·dt)``;
- ``reflected_rectangle_trajectories``: fBm confined to a (rotated)
  rectangle by reflection at every step.

The geometry is numpy arrays (vertices, lengths, cumulative lengths); the
lookups run on the displacements' device (``torch.searchsorted(...,
right=True)`` for JAX's ``side="right"``). The JAX package's two sequential
``lax.scan`` walks become loops over the T steps that move all particles at
once; ``map_displacements`` and ``reflected_walk`` take the displacements,
so the same displacements give the JAX package's positions. None of this is
a kernel of its own: it is plain torch on any device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from moleculardiffusion_mivit_tpu_torch.sim.trajectory import fractional_gaussian_noise, reflect_into_box


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def disp_fbm(
    generator: torch.Generator, alpha: float, D: float, T: int, delta_t: float = 1.0, batch: int = 1
) -> torch.Tensor:
    """Fractional Gaussian displacements ``(batch, T)`` with ``<x²(dt)> =
    2·D·dt``, on the generator's device."""
    dev = generator.device
    disp = fractional_gaussian_noise(generator, _f32(alpha, dev) / 2.0, T, batch)
    return disp * torch.sqrt(_f32(2.0 * D * delta_t, dev))


class Edge:
    """One line segment of the skeleton: ``length``, ``angle``,
    ``start_point`` / ``end_point``, ``get_position_at_distance`` (clamped
    lerp) and ``distance_to_end`` (projection onto the edge direction)."""

    def __init__(self, start_point: Tuple[float, float], end_point: Tuple[float, float]):
        self.start_point = np.asarray(start_point, np.float32)
        self.end_point = np.asarray(end_point, np.float32)
        self.vector = self.end_point - self.start_point
        self.length = float(np.linalg.norm(self.vector))
        if self.length <= 0:
            raise ValueError("zero-length edge")
        self.angle = float(np.arctan2(self.vector[1], self.vector[0]))

    def get_position_at_distance(self, distance: float) -> np.ndarray:
        d = min(max(float(distance), 0.0), self.length)
        return self.start_point + (d / self.length) * self.vector

    def distance_to_end(self, current_position) -> float:
        to_end = self.end_point - np.asarray(current_position, np.float32)
        return max(0.0, float(np.dot(to_end, self.vector / self.length)))

    def __repr__(self):
        return (
            f"Edge(start={tuple(self.start_point)}, end={tuple(self.end_point)}, "
            f"length={self.length:.2f})"
        )


class PiecewiseLinearGeometry:
    """A connected piecewise-linear path (the mitochondria skeleton), from
    vertices ``[(x0, y0), (x1, y1), ...]`` (consecutive vertices make the
    edges) or from a connected edge list through ``from_edges``."""

    def __init__(self, vertices: Sequence[Tuple[float, float]]):
        v = np.asarray(vertices, np.float32)
        if v.ndim != 2 or v.shape[0] < 2 or v.shape[1] != 2:
            raise ValueError("need at least 2 (x, y) vertices")
        self.vertices = v
        seg = v[1:] - v[:-1]
        self.lengths = np.sqrt((seg**2).sum(-1))
        if np.any(self.lengths <= 0):
            raise ValueError("zero-length edge")
        self.cum_lengths = np.concatenate([[0.0], np.cumsum(self.lengths)]).astype(np.float32)
        self.total_length = float(self.cum_lengths[-1])
        self.edges = [Edge(v[i], v[i + 1]) for i in range(len(v) - 1)]

    @classmethod
    def from_edges(cls, edges: Sequence) -> "PiecewiseLinearGeometry":
        """Build from a connected edge list (``Edge`` objects or ``((x0,
        y0), (x1, y1))`` pairs): the end point of edge ``i`` must equal the
        start point of edge ``i+1``, else ``ValueError``."""
        if not edges:
            raise ValueError("need at least one edge")
        es = [e if isinstance(e, Edge) else Edge(*e) for e in edges]
        for i in range(len(es) - 1):
            if not np.allclose(es[i].end_point, es[i + 1].start_point):
                raise ValueError(
                    f"edge chain breaks between edges {i} and {i + 1}: "
                    f"{tuple(es[i].end_point)} != {tuple(es[i + 1].start_point)}"
                )
        return cls([es[0].start_point] + [e.end_point for e in es])

    @property
    def n_edges(self) -> int:
        return len(self.lengths)

    @property
    def bounding_box(self) -> Tuple[float, float, float, float]:
        """(min_x, max_x, min_y, max_y) over all vertices."""
        return (
            float(self.vertices[:, 0].min()),
            float(self.vertices[:, 0].max()),
            float(self.vertices[:, 1].min()),
            float(self.vertices[:, 1].max()),
        )

    def get_edge_at_position(self, position, tol: float = 1e-10):
        """The edge whose segment contains ``position``, or None: the point
        projected onto every segment, accepted where the projection lies in
        [0, length] and the perpendicular distance is below ``tol``; a shared
        vertex belongs to the first edge in chain order."""
        pos = np.asarray(position, np.float64)
        starts = self.vertices[:-1].astype(np.float64)
        vecs = self.vertices[1:].astype(np.float64) - starts
        lengths = np.asarray(self.lengths, np.float64)
        rel = pos[None, :] - starts
        proj = (rel * vecs).sum(axis=1) / lengths
        perp = rel - (proj / lengths)[:, None] * vecs
        ok = (proj >= 0.0) & (proj <= lengths) & (np.linalg.norm(perp, axis=1) < tol)
        hits = np.nonzero(ok)[0]
        return self.edges[int(hits[0])] if hits.size else None

    def get_edge_at_length(self, distance: float):
        """(edge, remaining distance along it) at an arclength from the
        start; (None, 0.0) outside [0, total_length]."""
        if distance < 0 or distance > self.total_length:
            return None, 0.0
        idx = int(np.clip(np.searchsorted(self.cum_lengths, distance, side="right") - 1, 0, self.n_edges - 1))
        return self.edges[idx], float(distance - self.cum_lengths[idx])

    def draw(self, ax=None, edge_color="blue", vertex_color="red", show_vertices=False):
        """Plot the skeleton (matplotlib, imported here)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(8, 6))
        for e in self.edges:
            ax.plot([e.start_point[0], e.end_point[0]], [e.start_point[1], e.end_point[1]],
                    color=edge_color, linewidth=1.5)
        if show_vertices:
            ax.scatter(self.vertices[:, 0], self.vertices[:, 1], color=vertex_color, zorder=10)
        ax.set_aspect("equal")
        return ax

    def _arrays(self, device):
        return tuple(torch.as_tensor(a, device=device) for a in (self.vertices, self.lengths, self.cum_lengths))

    def position_at_distance(self, distance) -> torch.Tensor:
        """Arclength → 2-D position (lerp on the owning edge), distances
        clamped into [0, total_length]; on ``distance``'s device (a CPU
        tensor for anything else)."""
        d = torch.as_tensor(distance, dtype=torch.float32)
        vertices, lengths, cum = self._arrays(d.device)
        return _lerp(vertices, lengths, cum, torch.clamp(d, 0.0, self.total_length))

    def map_displacements(self, displacements: torch.Tensor, initial_distance: float = 0.0) -> torch.Tensor:
        """Per-step clamped cumulative walk along the path → 2-D positions:
        ``(T,)`` → ``(T, 2)`` or ``(B, T)`` → ``(B, T, 2)``, on the
        displacements' device."""
        disp = torch.as_tensor(displacements, dtype=torch.float32)
        pos = _walk_and_lerp(*self._arrays(disp.device), torch.atleast_2d(disp), initial_distance)
        return pos if disp.ndim > 1 else pos[0]

    def simulate(
        self,
        generator: torch.Generator,
        n_particles: int,
        T: int,
        D: float,
        alpha: float = 1.0,
        delta_t: float = 1.0,
        initial_distance: float = 0.0,
    ) -> torch.Tensor:
        """fBm along the geometry: ``(n_particles, T, 2)`` positions on the
        generator's device (``disp_fbm``, then ``map_displacements``)."""
        disp = disp_fbm(generator, alpha, D, T, delta_t, n_particles)
        return self.map_displacements(disp, initial_distance)


def _lerp(vertices, lengths, cum_lengths, dists):
    """Arclengths inside [0, total] → positions: the owning edge by
    ``searchsorted(side="right") − 1``, then linear interpolation on it."""
    edge = torch.clamp(torch.searchsorted(cum_lengths, dists.contiguous(), right=True) - 1, 0, lengths.shape[0] - 1)
    t = (dists - cum_lengths[edge]) / lengths[edge]
    return vertices[edge] + t[..., None] * (vertices[edge + 1] - vertices[edge])


def _walk_and_lerp(vertices, lengths, cum_lengths, disp, initial_distance):
    """Clamped cumulative arclength walk and edge lerp: ``disp (B, T)`` →
    positions ``(B, T, 2)``. Each step clamps into [0, total_length]."""
    total = cum_lengths[-1]
    zero = torch.zeros((), dtype=torch.float32, device=disp.device)
    carry = torch.clamp(_f32(initial_distance, disp.device), zero, total).expand(disp.shape[0])
    dists = torch.empty_like(disp)
    for t in range(disp.shape[1]):
        carry = torch.clamp(carry + disp[:, t], zero, total)
        dists[:, t] = carry
    return _lerp(vertices, lengths, cum_lengths, dists)


def _reflect_into(x, low, high):
    """Fold coordinates into [low, high] by reflection (the shifted form of
    ``reflect_into_box``)."""
    return low + reflect_into_box(x - low, high - low)


def reflected_walk(
    dxy: torch.Tensor, rect_center: Tuple[float, float], rect_size: Tuple[float, float], angle: float = 0.0
) -> torch.Tensor:
    """Displacements ``(B, T, 2)`` in the rectangle's frame → lab-frame
    positions ``(B, T, 2)``: from the centre, each step adds its
    displacement and folds each coordinate into ``[-w/2, w/2] × [-h/2,
    h/2]``; then the rotation by ``angle`` and the shift to ``rect_center``."""
    dev = dxy.device
    w, h = rect_size
    half = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float32, device=dev)
    pos = torch.zeros((dxy.shape[0], 2), dtype=torch.float32, device=dev)
    local = torch.empty_like(dxy)
    for t in range(dxy.shape[1]):
        pos = _reflect_into(pos + dxy[:, t], -half, half)
        local[:, t] = pos
    a = _f32(angle, dev)
    c, s = torch.cos(a), torch.sin(a)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    return local @ rot.T + torch.tensor(rect_center, dtype=torch.float32, device=dev)


def reflected_rectangle_trajectories(
    generator: torch.Generator,
    n_particles: int,
    T: int,
    rect_center: Tuple[float, float],
    rect_size: Tuple[float, float],
    angle: float = 0.0,
    D: float = 1.0,
    alpha: float = 1.0,
    delta_t: float = 1.0,
) -> torch.Tensor:
    """fBm confined to a rotated rectangle by per-step reflection, starting
    at the rectangle's centre: ``(n_particles, T, 2)`` lab-frame positions
    on the generator's device (x displacements drawn before y)."""
    dx = disp_fbm(generator, alpha, D, T, delta_t, n_particles)
    dy = disp_fbm(generator, alpha, D, T, delta_t, n_particles)
    return reflected_walk(torch.stack([dx, dy], dim=-1), rect_center, rect_size, angle)
