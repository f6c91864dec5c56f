"""On-device voxelization (downsampling points into grid cells).

The reference's biggest structural weakness is here: it downloads ~2.4M
point cell-ids to the host, radix-sorts + groups them on CPU with OpenMP
(``voxelize.h:74-105``, ``radix_sort.h``, ``radix_grouper.h``) and averages
per-cell members, every frame. This design keeps the whole stage on
device as sort-and-segment reductions:

- average mode (``averageGridCells``, voxelize.h:9-48): scatter-add point
  coordinates + counts over cells, then compact occupied cells -> per-cell
  mean points.
- occupied mode (``occupiedGridCells``, voxelize.h:50-71): compact occupied
  cells -> world coordinate of each cell's lower corner
  (``GridMeta::worldCoord``).

Both modes emit cells in ascending cell-index order — the same order the
reference's radix grouper produces.

The *capability* of the standalone radix sorter/grouper (sort u32 keys
carrying payload indices, run-length group equal keys) is provided by
:func:`sort_by_key` / :func:`group_by_key` built on ``jax.lax.sort``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import compact_multi


def voxelize_average(points: jnp.ndarray,
                     cell_indices: jnp.ndarray,
                     mask: jnp.ndarray,
                     grid: VoxelGrid,
                     capacity: int,
                     return_occupancy: bool = False):
    """Mean point per occupied cell.

    Args:
        points:       ``[N, 4]`` homogeneous points (w=1 when valid).
        cell_indices: ``[N]`` int32 linear cell ids.
        mask:         ``[N]`` bool validity.
        capacity:     static max number of emitted cells.
        return_occupancy: also return the dense ``[num_cells]`` int32 0/1
            occupancy (free here — it is ``counts > 0`` — and saves the
            engine a separate full-size occupancy scatter).

    Returns:
        (``[capacity, 4]`` mean points, count[, occupancy]). Means of the
        homogeneous w component are exact 1s for valid cells by
        construction. Cells are emitted in ascending cell-index order (the
        order the reference's radix grouper produces).

    Implementation: ``lax.sort`` + log-doubling segmented sums — the
    on-device re-expression of the reference's CPU radix sort -> group ->
    average (voxelize.h:9-48). Summation order is fixed by the sort, so
    the result is deterministic (a float scatter-add is not).
    """
    num_cells = grid.num_cells
    n = mask.shape[0]
    sentinel = jnp.int32(num_cells)
    key = jnp.where(mask, cell_indices.astype(jnp.int32), sentinel)
    ks, x, y, z = jax.lax.sort(
        (key, points[:, 0], points[:, 1], points[:, 2]), num_keys=1)
    # the homogeneous w of valid points is 1 by construction — carry the
    # count in its column slot instead of summing w
    acc = jnp.stack(
        [x, y, z, jnp.where(ks < sentinel, 1.0, 0.0).astype(points.dtype)],
        axis=-1)
    # log-doubling segmented inclusive sums gated on equal keys: after the
    # loop, each run's LAST element holds the run's full column sums
    s = 1
    while s < n:
        shifted = jnp.pad(acc[:-s], ((s, 0), (0, 0)))
        same = jnp.pad(ks[s:] == ks[:-s], (s, 0))
        acc = acc + jnp.where(same[:, None], shifted, 0.0)
        s *= 2
    is_end = (jnp.concatenate([ks[1:] != ks[:-1], jnp.array([True])])
              & (ks < sentinel))
    means3 = acc[:, :3] / jnp.maximum(acc[:, 3:4], 1.0)
    (out_means, out_cells), count = compact_multi((means3, ks), is_end,
                                                  capacity)
    w_col = (jnp.arange(capacity, dtype=jnp.int32) < count).astype(
        points.dtype)
    out_points = jnp.concatenate([out_means, w_col[:, None]], axis=-1)
    if return_occupancy:
        # scatter only the compacted unique cells (<= capacity update
        # slots), not all N points
        target = jnp.where(w_col > 0, out_cells, sentinel)
        occ = jnp.zeros((num_cells,), jnp.int32)
        occ = occ.at[target].max(1, mode="drop")
        return out_points, count, occ
    return out_points, count


def voxelize_average_packed(points: jnp.ndarray,
                            cell_indices: jnp.ndarray,
                            mask: jnp.ndarray,
                            grid: VoxelGrid,
                            capacity: int,
                            return_occupancy: bool = False):
    """Mean point per occupied cell with a PACKED sort payload.

    The exact path (:func:`voxelize_average`) sorts 4 operands
    (key, x, y, z), and a sort's cost grows with its operand bytes. Here
    each point's coordinates are quantized RELATIVE TO
    ITS CELL CORNER into one u32 (10/10/12 bits -> half-step error of at
    most cell_size/2048 in x/y and /8192 in z, ~0.05 mm at the 0.1 m
    deployment grids — an order below depth-sensor noise), so the sort
    carries (key, packed) only. Accumulation and the final
    ``corner + (mean_q + 0.5)*cell/2^b`` reconstruction stay f32 and the
    result is deterministic.

    Caveat: points clamped onto border cells from OUTSIDE the grid (crop
    box larger than the voxel box, or crop frame != world frame) have
    out-of-cell fractions and are clamped to the cell; interior points are
    within the stated bound. The engine selects this path via
    ``FusionConfig.voxel_mean_mode = "packed"`` (or ``"auto"``, the
    default) and the exact path via ``"exact"``.
    """
    num_cells = grid.num_cells
    n = mask.shape[0]
    sentinel = jnp.int32(num_cells)
    key = jnp.where(mask, cell_indices.astype(jnp.int32), sentinel)

    corner = grid.world_coord_of_coord(
        grid.grid_coord_of_index(cell_indices), dtype=points.dtype)
    cs = jnp.asarray(grid.cell_size, points.dtype)
    bits = (10, 10, 12)
    qs = []
    for a, b in enumerate(bits):
        scale = jnp.asarray(1 << b, points.dtype)
        f = (points[:, a] - corner[:, a]) / cs[a]
        qs.append(jnp.clip(jnp.floor(f * scale), 0, (1 << b) - 1)
                  .astype(jnp.uint32))
    packed = qs[0] | (qs[1] << jnp.uint32(10)) | (qs[2] << jnp.uint32(20))

    ks, ps = jax.lax.sort((key, packed), num_keys=1)
    valid = ks < sentinel
    acc = jnp.stack(
        [(ps & jnp.uint32(1023)).astype(points.dtype),
         ((ps >> jnp.uint32(10)) & jnp.uint32(1023)).astype(points.dtype),
         (ps >> jnp.uint32(20)).astype(points.dtype),
         valid.astype(points.dtype)], axis=-1)
    s = 1
    while s < n:
        shifted = jnp.pad(acc[:-s], ((s, 0), (0, 0)))
        same = jnp.pad(ks[s:] == ks[:-s], (s, 0))
        acc = acc + jnp.where(same[:, None], shifted, 0.0)
        s *= 2
    is_end = (jnp.concatenate([ks[1:] != ks[:-1], jnp.array([True])])
              & valid)
    mean_q = acc[:, :3] / jnp.maximum(acc[:, 3:4], 1.0)
    (out_q, out_cells), count = compact_multi((mean_q, ks), is_end,
                                              capacity)
    w_col = (jnp.arange(capacity, dtype=jnp.int32) < count).astype(
        points.dtype)
    out_corner = grid.world_coord_of_coord(
        grid.grid_coord_of_index(out_cells), dtype=points.dtype)
    inv_scale = cs / jnp.asarray([float(1 << b) for b in bits],
                                 points.dtype)
    out_means = out_corner + (out_q + 0.5) * inv_scale
    out_means = out_means * w_col[:, None]
    out_points = jnp.concatenate([out_means, w_col[:, None]], axis=-1)
    if return_occupancy:
        target = jnp.where(w_col > 0, out_cells, sentinel)
        occ = jnp.zeros((num_cells,), jnp.int32)
        occ = occ.at[target].max(1, mode="drop")
        return out_points, count, occ
    return out_points, count


def voxelize_partial_sums(points: jnp.ndarray,
                          cell_indices: jnp.ndarray,
                          mask: jnp.ndarray,
                          grid: VoxelGrid,
                          capacity: int):
    """Per-cell PARTIAL sums for distributed average-voxelize.

    Same packed 10/10/12 cell-relative quantization and 2-operand sort as
    :func:`voxelize_average_packed`, but stops before the mean: returns the
    compacted per-cell integer sums so shards can combine them exactly
    (integer partial sums commute — a ``psum`` over shards followed by one
    division reproduces the single-device packed means bit-for-bit while
    every per-cell count stays below 2^24).

    Returns:
        (cells ``[capacity]`` int32, ``num_cells`` beyond the count;
         qsums ``[capacity, 3]`` f32 exact-integer quantized-coordinate sums;
         cnts ``[capacity]`` f32 exact-integer member counts;
         count scalar int32).
    """
    num_cells = grid.num_cells
    n = mask.shape[0]
    sentinel = jnp.int32(num_cells)
    key = jnp.where(mask, cell_indices.astype(jnp.int32), sentinel)
    corner = grid.world_coord_of_coord(
        grid.grid_coord_of_index(cell_indices), dtype=points.dtype)
    cs = jnp.asarray(grid.cell_size, points.dtype)
    bits = (10, 10, 12)
    qs = []
    for a, b in enumerate(bits):
        scale = jnp.asarray(1 << b, points.dtype)
        f = (points[:, a] - corner[:, a]) / cs[a]
        qs.append(jnp.clip(jnp.floor(f * scale), 0, (1 << b) - 1)
                  .astype(jnp.uint32))
    packed = qs[0] | (qs[1] << jnp.uint32(10)) | (qs[2] << jnp.uint32(20))
    ks, ps = jax.lax.sort((key, packed), num_keys=1)
    valid = ks < sentinel
    acc = jnp.stack(
        [(ps & jnp.uint32(1023)).astype(points.dtype),
         ((ps >> jnp.uint32(10)) & jnp.uint32(1023)).astype(points.dtype),
         (ps >> jnp.uint32(20)).astype(points.dtype),
         valid.astype(points.dtype)], axis=-1)
    s = 1
    while s < n:
        shifted = jnp.pad(acc[:-s], ((s, 0), (0, 0)))
        same = jnp.pad(ks[s:] == ks[:-s], (s, 0))
        acc = acc + jnp.where(same[:, None], shifted, 0.0)
        s *= 2
    is_end = (jnp.concatenate([ks[1:] != ks[:-1], jnp.array([True])])
              & valid)
    (out_acc, out_cells), count = compact_multi((acc, ks), is_end, capacity)
    live = jnp.arange(capacity, dtype=jnp.int32) < count
    out_cells = jnp.where(live, out_cells, sentinel)
    out_acc = jnp.where(live[:, None], out_acc, 0.0)
    return out_cells, out_acc[:, :3], out_acc[:, 3], count


def dequantize_cell_means(cells: jnp.ndarray, qsums: jnp.ndarray,
                          cnts: jnp.ndarray, grid: VoxelGrid,
                          bits=(10, 10, 12)):
    """World-coordinate means from combined quantized per-cell sums
    (the reconstruction half of :func:`voxelize_average_packed`)."""
    live = cnts > 0
    safe = jnp.where(live, cells, 0).astype(jnp.int32)
    corner = grid.world_coord_of_coord(grid.grid_coord_of_index(safe),
                                       dtype=qsums.dtype)
    cs = jnp.asarray(grid.cell_size, qsums.dtype)
    inv_scale = cs / jnp.asarray([float(1 << b) for b in bits],
                                 qsums.dtype)
    mean_q = qsums / jnp.maximum(cnts[:, None], 1.0)
    means = (corner + (mean_q + 0.5) * inv_scale) * live[:, None]
    return jnp.concatenate(
        [means, live.astype(qsums.dtype)[:, None]], axis=-1)


def voxelize_occupied(occupancy: jnp.ndarray,
                      grid: VoxelGrid,
                      capacity: int,
                      dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """World coordinates (cell lower corners, w=1) of occupied cells from a
    dense ``[num_cells]`` occupancy vector."""
    occupied = occupancy > 0
    cell_ids = jnp.arange(grid.num_cells, dtype=jnp.int32)
    xyz = grid.world_coord_of_index(cell_ids, dtype=dtype)
    pts = jnp.concatenate([xyz, jnp.ones_like(xyz[:, :1])], axis=-1)
    (out_points,), count = compact_multi((pts,), occupied, capacity)
    return out_points, count


# ---------------------------------------------------------------------------
# Sort/group capability (reference RadixSorter / RadixGrouper / UIntGrouper)
# ---------------------------------------------------------------------------

def sort_by_key(keys: jnp.ndarray, *payloads) -> Tuple[jnp.ndarray, ...]:
    """Stable ascending sort of u32/i32 keys carrying payload arrays
    (reference ``RadixSorter::sort``, radix_sort.h:108-239)."""
    return jax.lax.sort((keys,) + payloads, dimension=0, is_stable=True,
                        num_keys=1)


def group_by_key(keys: jnp.ndarray,
                 mask: jnp.ndarray,
                 group_capacity: int):
    """Sort + run-length-encode equal keys (reference ``RadixGrouper::group``,
    radix_grouper.h:35-64).

    Invalid entries are sorted to the end (key replaced by int32 max) and
    excluded from groups.

    Returns dict with:
        sorted_indices ``[N]``  — original index per sorted slot,
        group_starts   ``[group_capacity]`` — start slot of each group,
        group_sizes    ``[group_capacity]``,
        group_values   ``[group_capacity]`` — the shared key,
        num_groups     scalar int32.
    """
    n = keys.shape[0]
    big = jnp.iinfo(jnp.int32).max
    k = jnp.where(mask, keys.astype(jnp.int32), big)
    idx = jnp.arange(n, dtype=jnp.int32)
    ks, sorted_idx = sort_by_key(k, idx)

    valid = ks != big
    is_start = valid & jnp.concatenate(
        [jnp.array([True]), ks[1:] != ks[:-1]])
    starts_all = jnp.arange(n, dtype=jnp.int32)
    (group_starts, group_values), num_groups = compact_multi(
        (starts_all, ks), is_start, group_capacity)
    # size = next group's start - own start; last group ends at valid count
    valid_count = jnp.sum(valid.astype(jnp.int32))
    next_starts = jnp.concatenate(
        [group_starts[1:], jnp.array([0], dtype=jnp.int32)])
    gi = jnp.arange(group_capacity, dtype=jnp.int32)
    ends = jnp.where(gi == num_groups - 1, valid_count, next_starts)
    group_sizes = jnp.where(gi < num_groups, ends - group_starts, 0)
    return {
        "sorted_indices": sorted_idx,
        "sorted_keys": ks,
        "group_starts": group_starts,
        "group_sizes": group_sizes,
        "group_values": group_values,
        "num_groups": num_groups,
    }


def bincount_group(values: jnp.ndarray,
                   mask: jnp.ndarray,
                   num_bins: int):
    """O(N + M) counting-sort grouping by small-integer key (reference
    ``UIntGrouper::group``, uint_grouper.h:44-102): per-bin counts + the
    stable permutation that groups equal keys.

    Returns (counts ``[num_bins]``, starts ``[num_bins]``,
    grouped_indices ``[N]`` — original indices ordered by bin).
    """
    n = values.shape[0]
    target = jnp.where(mask, values.astype(jnp.int32), num_bins)
    counts = jnp.zeros((num_bins,), jnp.int32).at[target].add(
        jnp.where(mask, 1, 0), mode="drop")
    starts = jnp.cumsum(counts) - counts
    # stable within-bin order via sort on the key with index payload
    idx = jnp.arange(n, dtype=jnp.int32)
    _, grouped_indices = sort_by_key(target, idx)
    return counts, starts, grouped_indices
