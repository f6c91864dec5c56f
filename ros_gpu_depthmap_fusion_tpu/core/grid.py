"""Voxel-grid geometry.

Device-side re-expression of the reference ``GridMeta`` descriptor
(``include/gpu_depthmap_fusion/grid_meta.h:17-169``): bounds + cell size
define a static integer grid; conversions between world coordinates, integer
grid coordinates and linear cell indices.

The grid descriptor is a *static* (hashable, frozen) dataclass: grid shape
feeds XLA shapes, so it must be known at trace time. The coordinate
conversions themselves are pure jnp functions usable inside jit.

Two world->cell conventions exist in the reference and both are preserved:

- ``cell_index_clamped``: the production GPU kernel semantics
  (``shader/compute_voxel_coords.glsl:44-53``) — points outside the bounds
  are clamped onto border cells.
- ``grid_coord_wrapped``: ``GridMeta::gridCoord`` semantics
  (``grid_meta.h:58-71``) — truncation + per-axis modulo wrap.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class VoxelGrid:
    """Static grid descriptor (reference GridMeta translation).

    ``grid_size[i] = max(1, ceil((upper-lower)/cell))`` per axis
    (grid_meta.h:153-154); linear index stride order is x-fastest:
    ``index = x + y*W + z*W*H`` (compute_voxel_coords.glsl:53).
    """

    lower: Tuple[float, float, float]
    upper: Tuple[float, float, float]
    cell_size: Tuple[float, float, float]
    wrap: Tuple[bool, bool, bool] = (False, False, False)

    def __post_init__(self):
        # normalize bounds so lower <= upper (grid_meta.h:142-148)
        lo = tuple(min(l, u) for l, u in zip(self.lower, self.upper))
        hi = tuple(max(l, u) for l, u in zip(self.lower, self.upper))
        object.__setattr__(self, "lower", lo)
        object.__setattr__(self, "upper", hi)

    # --- static properties -------------------------------------------------
    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return tuple(
            max(1, int(math.ceil((u - l) / c)))
            for l, u, c in zip(self.lower, self.upper, self.cell_size)
        )

    @property
    def steps(self) -> Tuple[int, int, int]:
        """Linear-index strides per axis; steps[0] == 1 (grid_meta.h:155)."""
        gs = self.grid_size
        return (1, gs[0], gs[0] * gs[1])

    @property
    def num_cells(self) -> int:
        gs = self.grid_size
        return gs[0] * gs[1] * gs[2]

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        """Array shape for a dense grid laid out [z, y, x] (z = layers),
        matching the reference's layer-major occupancy download
        (gpu_depthmap_fusion.cpp:1829-1838)."""
        gs = self.grid_size
        return (gs[2], gs[1], gs[0])

    # --- conversions (jit-safe) -------------------------------------------
    def cell_index_clamped(self, points_xyz: jnp.ndarray) -> jnp.ndarray:
        """World points ``[..., 3]`` -> linear cell index (int32), clamped to
        border cells. Production semantics of compute_voxel_coords.glsl:44-53:
        the *float* scaled coordinate is clamped to [0, grid_size-1] before
        flooring."""
        gs = jnp.asarray(self.grid_size, dtype=points_xyz.dtype)
        lo = jnp.asarray(self.lower, dtype=points_xyz.dtype)
        cs = jnp.asarray(self.cell_size, dtype=points_xyz.dtype)
        f = jnp.clip((points_xyz - lo) / cs, 0.0, gs - 1.0)
        u = jnp.floor(f).astype(jnp.int32)
        st = jnp.asarray(self.steps, dtype=jnp.int32)
        return u[..., 0] * st[0] + u[..., 1] * st[1] + u[..., 2] * st[2]

    def grid_coord_wrapped(self, points_xyz: jnp.ndarray) -> jnp.ndarray:
        """World points ``[..., 3]`` -> int grid coord with C-style truncation
        and positive modulo (grid_meta.h:58-71)."""
        lo = jnp.asarray(self.lower, dtype=points_xyz.dtype)
        cs = jnp.asarray(self.cell_size, dtype=points_xyz.dtype)
        gs = jnp.asarray(self.grid_size, dtype=jnp.int32)
        scaled = (points_xyz - lo) / cs
        trunc = jnp.trunc(scaled).astype(jnp.int32)  # C cast truncates
        return jnp.mod(trunc, gs)  # jnp.mod is already the positive modulo

    def grid_coord_of_index(self, cell_index: jnp.ndarray) -> jnp.ndarray:
        """Linear index -> ``[..., 3]`` int grid coord (grid_meta.h:45-56)."""
        gs = jnp.asarray(self.grid_size, dtype=jnp.int32)
        st = jnp.asarray(self.steps, dtype=jnp.int32)
        idx = cell_index.astype(jnp.int32)
        return jnp.stack(
            [(idx // st[i]) % gs[i] for i in range(3)], axis=-1
        )

    def cell_index_of_coord(self, grid_coord: jnp.ndarray) -> jnp.ndarray:
        """``[..., 3]`` int grid coord -> linear index (grid_meta.h:79-87)."""
        st = jnp.asarray(self.steps, dtype=jnp.int32)
        gc = grid_coord.astype(jnp.int32)
        return gc[..., 0] * st[0] + gc[..., 1] * st[1] + gc[..., 2] * st[2]

    def world_coord_of_coord(self, grid_coord: jnp.ndarray,
                             dtype=jnp.float32) -> jnp.ndarray:
        """Grid coord -> world coordinate of the cell's lower corner
        (grid_meta.h:94-100: ``grid*cell + lower``)."""
        lo = jnp.asarray(self.lower, dtype=dtype)
        cs = jnp.asarray(self.cell_size, dtype=dtype)
        return grid_coord.astype(dtype) * cs + lo

    def world_coord_of_index(self, cell_index: jnp.ndarray,
                             dtype=jnp.float32) -> jnp.ndarray:
        return self.world_coord_of_coord(
            self.grid_coord_of_index(cell_index), dtype=dtype)

    # --- numpy mirrors for host-side assembly ------------------------------
    def np_world_coord_of_index(self, cell_index: np.ndarray) -> np.ndarray:
        gs = np.asarray(self.grid_size, dtype=np.int64)
        st = np.asarray(self.steps, dtype=np.int64)
        idx = np.asarray(cell_index, dtype=np.int64)
        coord = np.stack([(idx // st[i]) % gs[i] for i in range(3)], axis=-1)
        lo = np.asarray(self.lower, dtype=np.float32)
        cs = np.asarray(self.cell_size, dtype=np.float32)
        return coord.astype(np.float32) * cs + lo

    @staticmethod
    def from_config(cfg) -> "VoxelGrid":
        return VoxelGrid(lower=tuple(cfg.voxel_min), upper=tuple(cfg.voxel_max),
                         cell_size=tuple(cfg.voxel_size))
