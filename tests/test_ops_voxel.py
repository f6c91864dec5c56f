"""Voxel op tests against the NumPy GLSL oracles."""

import numpy as np
import jax.numpy as jnp

from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu.core import transforms
from ros_gpu_depthmap_fusion_tpu.ops.voxel import (
    scatter_occupancy, update_historic_occupancy, occupancy_to_u8,
    occupancy_layers)
from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
    voxelize_average, voxelize_occupied, group_by_key, bincount_group)

import oracles


GRID = VoxelGrid(lower=(-1, -1, 0), upper=(1, 1, 1), cell_size=(0.25, 0.25, 0.5))


def _points(seed=0, n=500):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.3, 1.3, size=(n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.85
    return transforms.to_homogeneous(xyz), mask


def test_cell_index_matches_oracle():
    pts, _ = _points()
    got = np.asarray(GRID.cell_index_clamped(jnp.asarray(pts[:, :3])))
    want, gsize = oracles.voxel_coords_oracle(
        pts, GRID.lower, GRID.upper, GRID.cell_size)
    assert tuple(gsize) == GRID.grid_size
    np.testing.assert_array_equal(got, want)


def test_scatter_occupancy():
    pts, mask = _points(1)
    ids = GRID.cell_index_clamped(jnp.asarray(pts[:, :3]))
    occ = np.asarray(scatter_occupancy(ids, jnp.asarray(mask), GRID.num_cells))
    want = np.zeros(GRID.num_cells, np.int32)
    want[np.unique(np.asarray(ids)[mask])] = 1
    np.testing.assert_array_equal(occ, want)


def test_historic_update_matches_oracle():
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 12, size=64).astype(np.int32)
    fresh = (rng.random(64) < 0.3).astype(np.int32)
    got = np.asarray(update_historic_occupancy(
        jnp.asarray(hist), jnp.asarray(fresh), lifetime=10))
    want = oracles.occupancy_update_oracle(hist, fresh, 10)
    np.testing.assert_array_equal(got, want)


def test_historic_decay_to_zero():
    hist = jnp.asarray([3, 1, 0], dtype=jnp.int32)
    fresh = jnp.zeros(3, jnp.int32)
    for expect in ([2, 0, 0], [1, 0, 0], [0, 0, 0], [0, 0, 0]):
        hist = update_historic_occupancy(hist, fresh, lifetime=10)
        np.testing.assert_array_equal(np.asarray(hist), expect)


def test_occupancy_u8_and_layers():
    g = VoxelGrid(lower=(0, 0, 0), upper=(4, 3, 2), cell_size=(1, 1, 1))
    grid = jnp.arange(g.num_cells, dtype=jnp.int32) * 20
    u8 = occupancy_to_u8(grid)
    assert int(u8[13]) == min(260, 255)
    layers = occupancy_layers(u8, g.grid_size)
    assert layers.shape == (2, 3, 4)
    # x-fastest layout: cell (x=1,y=2,z=1) at linear 1 + 2*4 + 1*12 = 21
    assert int(layers[1, 2, 1]) == int(u8[21])


def test_voxelize_average_matches_oracle():
    pts, mask = _points(3, n=300)
    ids = GRID.cell_index_clamped(jnp.asarray(pts[:, :3]))
    out, count = voxelize_average(
        jnp.asarray(pts), ids, jnp.asarray(mask), GRID, capacity=300)
    want, cells = oracles.voxelize_average_oracle(
        pts, np.asarray(ids), mask)
    assert int(count) == want.shape[0]
    np.testing.assert_allclose(np.asarray(out)[: int(count)], want,
                               rtol=1e-5, atol=1e-5)


def test_voxelize_average_packed_error_bound():
    """Packed (quantized-frac) means must match the exact oracle within
    the documented half-step bound: cell/2048 in x/y, cell/8192 in z —
    same cells, same counts, same order."""
    from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
        voxelize_average_packed)
    rng = np.random.default_rng(7)
    # in-bounds points: out-of-bounds points are clamped onto border cells
    # and their quantized fractions clamp into the cell (documented caveat
    # of packed mode; the engine's deployment configs crop to the grid)
    xyz = rng.uniform(0, 1, size=(500, 3)).astype(np.float32)
    xyz[:, :2] = xyz[:, :2] * 2 - 1
    pts = transforms.to_homogeneous(xyz)
    mask = rng.random(500) < 0.85
    ids = GRID.cell_index_clamped(jnp.asarray(pts[:, :3]))
    outp, countp = voxelize_average_packed(
        jnp.asarray(pts), ids, jnp.asarray(mask), GRID, capacity=500)
    want, cells = oracles.voxelize_average_oracle(
        pts, np.asarray(ids), mask)
    assert int(countp) == want.shape[0]
    got = np.asarray(outp)[: int(countp)]
    cs = np.asarray(GRID.cell_size)
    bound = cs / np.array([2048.0, 2048.0, 8192.0]) + 1e-6
    err = np.abs(got[:, :3] - want[:, :3])
    assert (err <= bound).all(), err.max(axis=0)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


def test_voxelize_occupied_centers():
    g = VoxelGrid(lower=(0, 0, 0), upper=(2, 2, 1), cell_size=(1, 1, 1))
    occ = jnp.asarray([0, 1, 0, 1], jnp.int32)
    out, count = voxelize_occupied(occ, g, capacity=4)
    assert int(count) == 2
    # cells 1 (x=1,y=0) and 3 (x=1,y=1); worldCoord = lower corner
    np.testing.assert_allclose(np.asarray(out)[:2],
                               [[1, 0, 0, 1], [1, 1, 0, 1]])


def test_group_by_key():
    keys = np.array([5, 3, 5, 7, 3, 3, 9, 5], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 0, 1, 1], bool)
    g = group_by_key(jnp.asarray(keys), jnp.asarray(mask), group_capacity=8)
    assert int(g["num_groups"]) == 4
    np.testing.assert_array_equal(np.asarray(g["group_values"])[:4],
                                  [3, 5, 7, 9])
    np.testing.assert_array_equal(np.asarray(g["group_sizes"])[:4],
                                  [2, 3, 1, 1])
    # stable: indices of key 3 in order 1, 4; key 5 in order 0, 2, 7
    si = np.asarray(g["sorted_indices"])
    assert list(si[:2]) == [1, 4]
    assert list(si[2:5]) == [0, 2, 7]


def test_bincount_group():
    vals = np.array([2, 0, 2, 1, 0, 2], np.int32)
    mask = np.ones(6, bool)
    counts, starts, gidx = bincount_group(jnp.asarray(vals), jnp.asarray(mask), 3)
    np.testing.assert_array_equal(np.asarray(counts), [2, 1, 3])
    np.testing.assert_array_equal(np.asarray(starts), [0, 2, 3])
    np.testing.assert_array_equal(np.asarray(gidx), [1, 4, 3, 0, 2, 5])


def test_fused_historic_update_matches_two_pass():
    """Engine's fused decay+scatter (split path) == scatter_occupancy +
    update_historic_occupancy, for 0/1 fresh grids."""
    from ros_gpu_depthmap_fusion_tpu.ops.voxel import (
        scatter_occupancy, update_historic_occupancy)
    rng = np.random.default_rng(11)
    num_cells, n = 5000, 1200
    historic = jnp.asarray(rng.integers(0, 11, num_cells, dtype=np.int32))
    cells = jnp.asarray(rng.integers(0, num_cells, n, dtype=np.int32))
    live = jnp.asarray(rng.random(n) < 0.7)
    lifetime = 10
    fresh = scatter_occupancy(cells, live, num_cells)
    ref = update_historic_occupancy(historic, fresh, lifetime)
    aged = jnp.maximum(historic - 1, 0)
    target = jnp.where(live, cells, jnp.int32(num_cells))
    got = aged.at[target].max(jnp.int32(lifetime), mode="drop")
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_voxelize_dense_cell_exactness_bound():
    """Pin packed voxelize at DENSE cells against the oracle. Per-cell sums
    of the 10/10/12-bit quantized coordinates are exact f32 integers while
    the z-sum (<= 4095 * members) stays below 2^24, i.e. ~4096 members per
    cell: a 3000-member cell must agree with the oracle mean to the
    quantization bound (cell/2048 per axis); far beyond it (12000 members)
    the f32 sums round, and the mean may drift by a further ~1e-4 m."""
    import jax.numpy as jnp
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
    from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
        voxelize_average_packed)
    cfg = FusionConfig(voxel_min=(-2, -2, 0), voxel_max=(2, 2, 1),
                       voxel_size=(0.5, 0.5, 0.5))
    grid = VoxelGrid.from_config(cfg)
    rng = np.random.default_rng(3)

    def run(members):
        # every point inside ONE cell (plus background points around)
        pts_in = np.concatenate([
            rng.uniform(0.0, 0.5, (members, 2)),
            rng.uniform(0.5, 1.0, (members, 1)),
            np.ones((members, 1))], axis=1).astype(np.float32)
        pts_bg = np.concatenate([
            rng.uniform(-2, 0, (500, 2)),
            rng.uniform(0, 0.5, (500, 1)),
            np.ones((500, 1))], axis=1).astype(np.float32)
        pts = np.concatenate([pts_in, pts_bg])
        mask = np.ones(len(pts), bool)
        ids = np.asarray(grid.cell_index_clamped(jnp.asarray(pts[:, :3])))
        p = voxelize_average_packed(jnp.asarray(pts), jnp.asarray(ids),
                                    jnp.asarray(mask), grid, 256,
                                    return_occupancy=True)
        ref, cells = oracles.voxelize_average_oracle(pts, ids, mask)
        return p, ref, cells

    bound = np.asarray(grid.cell_size) / 2048 + 1e-6
    for members, slack in ((3000, 0.0), (12000, 1e-4)):
        p, ref, cells = run(members)
        count = int(p[1])
        assert count == len(cells)
        got = np.asarray(p[0])[:count]
        assert np.all(np.abs(got[:, :3] - ref[:, :3]) <= bound + slack)
        occ = np.zeros(grid.num_cells, np.int32)
        occ[cells] = 1
        np.testing.assert_array_equal(np.asarray(p[2]), occ)
