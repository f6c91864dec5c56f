"""Voxel occupancy ops.

Device equivalents of the occupancy kernel group
(``gpu_depthmap_fusion.cpp:1757-1823`` orchestration):

- ``compute_voxel_coords``  -> :meth:`core.grid.VoxelGrid.cell_index_clamped`
- ``zero_uints`` + ``voxel_grid_occupancy_of_points`` (racy atomic scatter of
  1s, glsl:38-39) -> :func:`scatter_occupancy` — an idempotent ``max``
  scatter, deterministic by construction.
- ``decrement_uints`` (saturating age) + ``max_with_uints_times_scalar``
  (merge fresh occupancy x lifetime) -> :func:`update_historic_occupancy`,
  one fused elementwise expression.
- ``uints_to_chars`` pack for download -> :func:`occupancy_to_u8`.
"""

from __future__ import annotations

import jax.numpy as jnp


def scatter_occupancy(cell_indices: jnp.ndarray,
                      mask: jnp.ndarray,
                      num_cells: int,
                      occupied_value: int = 1) -> jnp.ndarray:
    """Scatter ``occupied_value`` into a fresh ``[num_cells]`` int32 grid at
    each valid point's cell index. Benign write races in the reference become
    a deterministic ``max`` scatter here (same result: occupancy is
    idempotent)."""
    target = jnp.where(mask, cell_indices, num_cells)  # invalid -> dropped
    occ = jnp.zeros((num_cells,), dtype=jnp.int32)
    return occ.at[target].max(jnp.int32(occupied_value), mode="drop")


def update_historic_occupancy(historic: jnp.ndarray,
                              fresh: jnp.ndarray,
                              lifetime: int,
                              decrement: int = 1,
                              min_value: int = 0) -> jnp.ndarray:
    """One temporal-decay step of the historic occupancy grid.

    Reference order (gpu_depthmap_fusion.cpp:1796-1812): age the historic
    grid by a saturating decrement, then take the elementwise max with the
    fresh occupancy scaled by ``lifetime``. A freshly seen cell therefore
    holds ``lifetime`` and fades by ``decrement`` per frame once unseen.
    """
    aged = jnp.maximum(historic - decrement, min_value)
    return jnp.maximum(aged, fresh * lifetime)


def occupancy_to_u8(grid: jnp.ndarray) -> jnp.ndarray:
    """int32 occupancy -> u8 (the reference packs 4 cells per u32 for
    download, uints_to_chars; here a plain clamp-cast)."""
    return jnp.clip(grid, 0, 255).astype(jnp.uint8)


def occupancy_bitmap(grid: jnp.ndarray) -> jnp.ndarray:
    """Binarized occupancy packed 8 cells/byte (little-endian bit order,
    np.unpackbits-compatible). Emitted by the fused step so the mapping
    consumer's d2h is one small materialization instead of a separate
    pack dispatch per cycle."""
    n = grid.shape[0]
    m = -(-n // 8) * 8
    bits = jnp.pad((grid[:n] > 0).astype(jnp.uint8),
                   (0, m - n)).reshape(-1, 8)
    w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return jnp.sum(bits * w, axis=-1, dtype=jnp.uint8)


def occupancy_bitmap_sparse(grid: jnp.ndarray, capacity: int):
    """Sparse form of :func:`occupancy_bitmap`: the NONZERO 128-bit
    BLOCKS (4 u32 words = 128 cells) of the packed bitmap as
    (block_index, 4 words) rows.

    At production grids the binarized occupancy is overwhelmingly zero
    (~7-20k occupied of 3.4M cells at the reference's largest deployment
    preset), so the mapping consumer's per-cycle d2h drops from
    ~num_cells/8 bytes to 20 bytes per occupied block. Block (not word)
    granularity quarters the compact-sort's row count — the sort is the
    op's whole cost — and occupied cells cluster, so the block count stays close to the word
    count. Host reconstruction is a trivial indexed store +
    ``np.unpackbits`` (:meth:`mapping.pipeline.MappingPipeline
    .process_sparse`).

    Returns ``(block_idx [capacity] i32, words [capacity, 4] i32 — u32
    bit patterns, count i32 clamped to capacity, true_count i32)``;
    ``true_count > capacity`` means blocks were dropped (observable
    overflow — consumers fall back to the dense bitmap).
    """
    from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import compact_multi
    packed = occupancy_bitmap(grid)                       # [B] u8
    b = packed.shape[0]
    nb = -(-b // 16) * 16
    by = jnp.pad(packed, (0, nb - b)).reshape(-1, 4, 4).astype(jnp.int32)
    words = (by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16)
             | (by[..., 3] << 24))                        # [NB, 4] i32
    nz = jnp.any(words != 0, axis=1)
    idx = jnp.arange(words.shape[0], dtype=jnp.int32)
    (oi, ow), cnt = compact_multi((idx, words), nz, capacity)
    return oi, ow, cnt, jnp.sum(nz.astype(jnp.int32))


def occupancy_layers(grid_u8: jnp.ndarray, grid_size) -> jnp.ndarray:
    """Reshape the flat x-fastest grid into ``[Z, Y, X]`` layer images,
    mirroring the reference's per-layer cv::Mat views
    (gpu_depthmap_fusion.cpp:1829-1838)."""
    w, h, z = grid_size
    return grid_u8.reshape(z, h, w)
