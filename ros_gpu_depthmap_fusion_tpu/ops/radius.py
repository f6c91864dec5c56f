"""Radius outlier filter.

The reference exposes the full parameter set for a radius filter
(``radius_filter_*`` params, enable flag) but never implemented the filter
itself — call sites are commented out (``_component.cpp:414-421``,
SURVEY.md §2.9). This provides the capability with static shapes: a density test
on a uniform grid with cell size = radius. A point survives when the
population of its own cell plus its 26 neighbor cells reaches
``min_neighbors`` — a standard O(N) approximation of the exact
neighbor-count radius filter (exact for neighbors within one cell,
superset within sqrt(3) * radius).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid


def filter_radius_outliers(points: jnp.ndarray,
                           mask: jnp.ndarray,
                           lower: Tuple[float, float, float],
                           upper: Tuple[float, float, float],
                           radius: float,
                           min_neighbors: int = 2) -> jnp.ndarray:
    """AND a density gate into the mask.

    Args:
        points: ``[N, 4]`` (or ``[N, 3]``) world points.
        mask:   ``[N]`` bool.
        lower/upper/radius: filter AABB + neighborhood radius (= cell size).
        min_neighbors: minimum population (including the point itself) in
            the 3x3x3 cell neighborhood.
    """
    grid = VoxelGrid(lower=lower, upper=upper,
                     cell_size=(radius, radius, radius))
    xyz = points[..., :3]
    coord = jnp.stack([
        jnp.clip(((xyz[:, i] - grid.lower[i]) / radius).astype(jnp.int32),
                 0, grid.grid_size[i] - 1)
        for i in range(3)], axis=-1)
    num_cells = grid.num_cells
    cell = grid.cell_index_of_coord(coord)
    target = jnp.where(mask, cell, num_cells)
    counts = jnp.zeros((num_cells,), jnp.int32).at[target].add(
        1, mode="drop")

    gx, gy, gz = grid.grid_size
    c3 = counts.reshape(gz, gy, gx)
    # 3x3x3 box sum via three separable pads+adds
    def box1(a, axis):
        lo = jnp.roll(a, 1, axis=axis)
        hi = jnp.roll(a, -1, axis=axis)
        idx = jnp.arange(a.shape[axis])
        shape = [1, 1, 1]
        shape[axis] = a.shape[axis]
        idxr = idx.reshape(shape)
        lo = jnp.where(idxr > 0, lo, 0)
        hi = jnp.where(idxr < a.shape[axis] - 1, hi, 0)
        return a + lo + hi

    dens = box1(box1(box1(c3, 0), 1), 2).reshape(-1)
    neighborhood = jnp.take(dens, jnp.minimum(cell, num_cells - 1))
    return mask & (neighborhood >= min_neighbors)
