"""Precomputed signed-distance voxel grids for complex static worlds.

Counterpart of ``trajopt_tpu/collision/sdf_grid.py`` (the reference's
octree / octomap worlds): a static environment of arbitrary geometry is
baked once into a regular SDF grid, and queries are trilinear interpolation
over any batch of points.  The interpolation is written out as the JAX
function does it (corner values at ``origin + idx * spacing``, indices
clamped to the last full cell, the distance to the grid box added outside
it); ``torch.nn.functional.grid_sample`` has other corner and boundary
semantics.

Trilinear interpolation of an SDF under- or over-estimates near surfaces by
O(h^2 * curvature); choose the cell size h against the collision margin.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from trajopt_tpu_torch.collision.geometry import clip


@dataclasses.dataclass(frozen=True)
class SdfGrid:
    """``values [nx, ny, nz]`` sampled at ``origin + idx * spacing`` (cell
    corners), held as float64 on the host and copied to a query's device and
    dtype once (cached)."""

    values: np.ndarray
    origin: np.ndarray    # [3]
    spacing: float
    _on: dict = dataclasses.field(default_factory=dict, compare=False,
                                  repr=False)

    def __post_init__(self):
        object.__setattr__(self, "values",
                           np.asarray(self.values, np.float64))
        object.__setattr__(self, "origin",
                           np.asarray(self.origin, np.float64))

    def _tensors(self, like: torch.Tensor):
        key = (like.device, like.dtype)
        if key not in self._on:
            kw = dict(dtype=like.dtype, device=like.device)
            top = np.asarray(self.values.shape) - 1
            self._on[key] = (torch.as_tensor(self.values, **kw).reshape(-1),
                             torch.as_tensor(self.origin, **kw),
                             torch.as_tensor(top, **kw),
                             torch.as_tensor(top - 1, device=like.device))
        return self._on[key]

    def query(self, p: torch.Tensor) -> torch.Tensor:
        """Trilinear-interpolated signed distance at world points ``p [...,
        3]`` -> ``[...]``.  Outside the grid: the boundary value plus the
        Euclidean distance to the grid box (conservative for enclosed
        obstacles)."""
        flat, origin, max_idx, hi = self._tensors(p)
        nx, ny, nz = self.values.shape
        rel = (p - origin) / self.spacing
        clamped = clip(rel, 0.0, max_idx)
        i0 = torch.minimum(torch.clamp_min(
            torch.floor(clamped).to(torch.int64), 0), hi)
        f = clamped - i0.to(p.dtype)
        x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

        def v(dx, dy, dz):
            return flat[((x0 + dx) * ny + (y0 + dy)) * nz + (z0 + dz)]

        c00 = v(0, 0, 0) * (1 - fx) + v(1, 0, 0) * fx
        c10 = v(0, 1, 0) * (1 - fx) + v(1, 1, 0) * fx
        c01 = v(0, 0, 1) * (1 - fx) + v(1, 0, 1) * fx
        c11 = v(0, 1, 1) * (1 - fx) + v(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        inside_val = c0 * (1 - fz) + c1 * fz
        out_vec = (rel - clamped) * self.spacing
        return inside_val + torch.sqrt((out_vec * out_vec).sum(-1) + 1e-12)

    def query_many(self, ps: torch.Tensor) -> torch.Tensor:
        """``[N, 3]`` points -> ``[N]`` distances (:meth:`query` is already
        batched; kept for the JAX package's name)."""
        return self.query(ps)


def bake_sdf(distance_fn: Callable[[torch.Tensor], torch.Tensor],
             lower, upper, spacing: float) -> SdfGrid:
    """Sample ``distance_fn(points [N, 3] float64) -> [N]`` signed distances
    onto a grid spanning [lower, upper] (the JAX function maps a per-point
    function over the points; here the function takes the batch)."""
    lower = np.asarray(lower, float)
    upper = np.asarray(upper, float)
    counts = np.maximum(np.ceil((upper - lower) / spacing).astype(int) + 1, 2)
    xs = [lower[i] + spacing * np.arange(counts[i]) for i in range(3)]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1).reshape(-1, 3)
    with torch.no_grad():
        vals = distance_fn(torch.as_tensor(pts, dtype=torch.float64))
    values = np.asarray(torch.as_tensor(vals).cpu(), np.float64)
    return SdfGrid(values=values.reshape(tuple(counts)), origin=lower,
                   spacing=spacing)


def sphere_sdf_distance(grid: SdfGrid, center: torch.Tensor, radius):
    """Signed distance of spheres ``center [..., 3]`` to the SDF world."""
    return grid.query(center) - radius


def capsule_sdf_distance(grid: SdfGrid, a: torch.Tensor, b: torch.Tensor,
                         radius, n_samples: int = 8):
    """Least SDF value along the capsule axes ``a -> b [..., 3]`` (at
    ``n_samples`` evenly spaced points, ends included) minus the radius."""
    ts = torch.linspace(0.0, 1.0, n_samples, dtype=a.dtype, device=a.device)
    pts = a[..., None, :] + ts[:, None] * (b - a)[..., None, :]
    return torch.amin(grid.query(pts), -1) - radius
