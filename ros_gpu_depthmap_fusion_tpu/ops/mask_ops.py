"""Mask predicates and deterministic stream compaction.

- :func:`crop_points` — ``shader/crop_points.glsl:47-66``: AABB test in the
  crop frame, ANDed into the validity mask.
- :func:`compact` — replaces ``shader/apply_point_mask.glsl``'s atomic-counter
  compaction (glsl:50-54, output order nondeterministic) with a
  deterministic, *stable* device idiom: one ``lax.sort`` on the inverted mask
  carrying the payload columns. Valid points keep their input order; the
  valid count replaces the reference's scratchpad readback
  (gpu_depthmap_fusion.cpp:1675-1677) and stays on device.

  A stable sort on key ``!mask`` IS stream compaction, and its output is
  the same on every backend.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def _sort_compact(arrays, mask: jnp.ndarray, capacity: int, fills):
    """Shared core: stable-sort all payload columns by ``!mask`` so valid
    rows land first in original order; slice/pad to ``capacity`` and blank
    rows beyond the valid count with each array's fill value."""
    n = mask.shape[0]
    key = (~mask).astype(jnp.uint8)
    cols = []
    specs = []
    for a in arrays:
        flat = a.reshape(n, -1)
        ncol = flat.shape[1]
        bool_in = a.dtype == jnp.bool_
        specs.append((ncol, a.shape[1:], bool_in))
        for j in range(ncol):
            col = flat[:, j]
            cols.append(col.astype(jnp.uint8) if bool_in else col)
    sorted_all = jax.lax.sort((key, *cols), num_keys=1, is_stable=True)
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)),
                        jnp.int32(capacity))
    live = jnp.arange(capacity, dtype=jnp.int32) < count
    outs = []
    pos = 1
    for (ncol, tail_shape, bool_in), a, fill in zip(specs, arrays, fills):
        out_cols = []
        for j in range(ncol):
            col = sorted_all[pos + j]
            if capacity <= n:
                col = col[:capacity]
            else:
                col = jnp.pad(col, (0, capacity - n))
            out_cols.append(col)
        pos += ncol
        if tail_shape:
            out = jnp.stack(out_cols, axis=-1).reshape(
                (capacity,) + tail_shape)
        else:
            out = out_cols[0]
        if bool_in:
            out = out.astype(jnp.bool_)
        live_b = live.reshape((capacity,) + (1,) * len(tail_shape))
        outs.append(jnp.where(live_b, out, jnp.asarray(fill, a.dtype)))
    return tuple(outs), count


def crop_points(points: jnp.ndarray,
                mask: jnp.ndarray,
                lower: Tuple[float, float, float],
                upper: Tuple[float, float, float]) -> jnp.ndarray:
    """AND an axis-aligned-box containment test into the mask.

    Args:
        points: ``[..., 4]`` points in the crop frame.
        mask:   ``[...]`` bool.
    """
    lo = jnp.asarray(lower, dtype=points.dtype)
    hi = jnp.asarray(upper, dtype=points.dtype)
    xyz = points[..., :3]
    inside = jnp.all((xyz >= lo) & (xyz <= hi), axis=-1)
    return mask & inside


def compact(values: jnp.ndarray,
            mask: jnp.ndarray,
            capacity: int,
            fill_value=0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable stream compaction of ``values`` rows where ``mask`` is true.

    Args:
        values:   ``[N, ...]`` input rows.
        mask:     ``[N]`` bool.
        capacity: static output length (rows beyond it are dropped; callers
            size it to N for lossless compaction).
        fill_value: value for unused output rows.

    Returns:
        (out ``[capacity, ...]``, count scalar int32). Rows ``[0, count)``
        hold the valid inputs in their original order.
    """
    (out,), count = _sort_compact((values,), mask, capacity, (fill_value,))
    return out, count


def compact_multi(arrays, mask: jnp.ndarray, capacity: int):
    """Compact several parallel arrays with one shared sort.

    Returns (tuple of compacted arrays, count).
    """
    arrays = tuple(arrays)
    return _sort_compact(arrays, mask, capacity, (0,) * len(arrays))
