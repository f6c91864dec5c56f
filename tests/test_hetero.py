"""Heterogeneous streams: per-stream resolution + depth_scale.

Reference parity: ``addDepthmap`` takes per-map cols/rows/depthScale
(``gpu_depthmap_fusion.cpp:798-816``) and dispatches per-map shapes
(``:1612-1642``) — a mixed D435+D455 rig. Oracle: a smaller stream
embedded top-left in a zero-padded buffer of the larger shape produces
the SAME unprojected points (zero depth = hole; pixel coords are
absolute), so a padded homogeneous engine is an exact reference for the
heterogeneous engine (integer partial sums commute, so section ordering
cannot change voxelized results); packed voxelize over the sections is
also checked against the NumPy oracle.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu.pipeline.engine import FusionEngine
from ros_gpu_depthmap_fusion_tpu.utils import native

import oracles


H0, W0 = 48, 64
H1, W1 = 32, 40

BOX = dict(crop_min=(-3.0, -3.0, 0.0), crop_max=(3.0, 3.0, 2.5),
           voxel_min=(-3.0, -3.0, 0.0), voxel_max=(3.0, 3.0, 2.5),
           voxel_size=(0.1, 0.1, 0.1))


def _scene(rng):
    # smooth fields (uniform-random depth would trip the flying-pixel
    # filter everywhere) + holes
    u0, v0 = np.meshgrid(np.arange(W0), np.arange(H0))
    d0 = (1500 + 300 * np.sin(u0 / 9.0) + 200 * np.cos(v0 / 7.0)
          + rng.integers(0, 3, (H0, W0))).astype(np.uint16)
    d0[rng.random((H0, W0)) < 0.05] = 0
    u1, v1 = np.meshgrid(np.arange(W1), np.arange(H1))
    d1 = (2400 + 500 * np.cos(u1 / 8.0) + 300 * np.sin(v1 / 6.0)
          + rng.integers(0, 3, (H1, W1))).astype(np.uint16)
    d1[rng.random((H1, W1)) < 0.05] = 0
    tf0 = np.eye(4, dtype=np.float32)
    tf0[:3, 3] = [0.0, 0.0, 0.3]
    tf1 = np.eye(4, dtype=np.float32)
    tf1[:3, 3] = [0.5, -0.2, 0.4]
    return d0, d1, tf0, tf1


def _point_set(out):
    pts = np.asarray(out.fused_points)[: int(out.fused_count)]
    return set(map(tuple, np.round(pts, 5).tolist()))


def _run(eng, d0, d1, tf0, tf1, pad=False, frames=3):
    i0 = PinholeIntrinsics.default_for(W0, H0)
    i1 = PinholeIntrinsics.default_for(W1, H1)
    out = None
    for f in range(frames):
        if pad:
            d1p = np.zeros((H0, W0), np.uint16)
            d1p[:H1, :W1] = d1
            eng.add_depthmap(0, d0, i0, tf0, tf0)
            eng.add_depthmap(1, d1p, i1, tf1, tf1)
        else:
            eng.add_depthmap(0, d0, i0, tf0, tf0)
            eng.add_depthmap(1, d1, i1, tf1, tf1)
        out = eng.process(10.0 + f / 30.0)
    return out


def _cfg_hetero(**kw):
    return FusionConfig(
        num_depth_streams=2,
        stream_shapes=((H0, W0), (H1, W1)),
        depth_scales=(0.001, 0.0005),
        depth_height=H0, depth_width=W0,
        voxel_occupancy_lifetime=3, **BOX, **kw)


def _cfg_padded(**kw):
    return FusionConfig(
        num_depth_streams=2,
        depth_height=H0, depth_width=W0,
        depth_scales=(0.001, 0.0005),
        voxel_occupancy_lifetime=3, **BOX, **kw)


def test_config_groups():
    cfg = _cfg_hetero()
    assert cfg.is_heterogeneous
    assert cfg.stream_groups == (((0,), H0, W0), ((1,), H1, W1))
    assert cfg.depthmaps_total_elements == H0 * W0 + H1 * W1
    same = FusionConfig(num_depth_streams=3,
                        stream_shapes=((H0, W0),) * 3)
    assert not same.is_heterogeneous
    assert same.stream_groups == (((0, 1, 2), H0, W0),)


@pytest.mark.parametrize("codec", ["none", "dpcm"])
def test_hetero_engine_matches_padded_oracle(codec):
    if codec == "dpcm" and not native.available():
        pytest.skip("native lib missing")
    rng = np.random.default_rng(3)
    d0, d1, tf0, tf1 = _scene(rng)

    het = FusionEngine(_cfg_hetero(depth_link_codec=codec))
    ref = FusionEngine(_cfg_padded(depth_link_codec="none"))
    out_h = _run(het, d0, d1, tf0, tf1, pad=False)
    out_r = _run(ref, d0, d1, tf0, tf1, pad=True)

    assert int(out_h.raw_count) == int(out_r.raw_count)
    np.testing.assert_array_equal(np.asarray(out_h.occupancy_u8),
                                  np.asarray(out_r.occupancy_u8))
    assert _point_set(out_h) == _point_set(out_r)
    assert int(out_h.fused_count) > 0


def test_per_stream_depth_scale_homogeneous():
    """depth_scales on a homogeneous rig: stream 1 at half scale must land
    at half the depth of an identical stream 0."""
    rng = np.random.default_rng(5)
    d = np.full((H0, W0), 1000, np.uint16)
    i0 = PinholeIntrinsics.default_for(W0, H0)
    tf = np.eye(4, dtype=np.float32)
    cfg = FusionConfig(num_depth_streams=2, depth_height=H0, depth_width=W0,
                       depth_scales=(0.001, 0.0005), depth_link_codec="none",
                       enable_voxel_filter=False,
                       enable_flyingpixels_filter=False, **BOX)
    eng = FusionEngine(cfg)
    eng.add_depthmap(0, d, i0, tf, tf)
    eng.add_depthmap(1, d, i0, tf, tf)
    out = eng.process(10.0)
    pts = np.asarray(out.raw_points)[: int(out.raw_count)]
    zs = np.unique(np.round(pts[:, 2], 6))
    assert set(zs) == {0.5, 1.0}, zs


def _assert_matches_voxel_oracle(pts, ids, mask, out_pts, count, grid):
    """Packed means against ``voxelize_average_oracle`` on the same cell
    ids: identical cell set, means within the packed bound (cell/2048 per
    axis) plus f32 slack."""
    ref_means, ref_cells = oracles.voxelize_average_oracle(pts, ids, mask)
    assert count == len(ref_cells)
    got = np.asarray(out_pts)[:count]
    cs = np.asarray(grid.cell_size)
    u = np.floor((got[:, :3] - np.asarray(grid.lower)) / cs).astype(int)
    gs = grid.grid_size
    np.testing.assert_array_equal(
        u[:, 0] + u[:, 1] * gs[0] + u[:, 2] * gs[0] * gs[1], ref_cells)
    assert np.all(np.abs(got[:, :3] - ref_means[:, :3]) <= cs / 2048 + 1e-6)


@pytest.mark.parametrize("rig", ["lidar_tail", "heterogeneous"])
def test_voxelize_packed_matches_oracle(rig):
    """Packed voxelize over the engine's section layouts — a raster depth
    section with a raster-incoherent lidar tail, and a mixed-resolution
    rig's per-group sections — against the NumPy oracle."""
    from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
        voxelize_average_packed)
    rng = np.random.default_rng(11)
    if rig == "lidar_tail":
        cfg = FusionConfig(num_depth_streams=1, **BOX)
        grid = VoxelGrid.from_config(cfg)
        u, v = np.meshgrid(np.arange(W0), np.arange(H0))
        depth = np.stack([u * 0.04 - 1.2, v * 0.05 - 1.0,
                          1.0 + 0.2 * np.sin(u / 7.0)], -1).reshape(-1, 3)
        lidar = np.stack([rng.uniform(-3, 3, 700), rng.uniform(-3, 3, 700),
                          rng.uniform(0, 2.5, 700)], -1)
        xyz = np.concatenate([depth, lidar])
        mask = rng.random(len(xyz)) > 0.1
    else:
        cfg = _cfg_hetero(enable_flyingpixels_filter=False,
                          emit_raw_points=True, depth_link_codec="none")
        grid = VoxelGrid.from_config(cfg)
        d0, d1, tf0, tf1 = _scene(rng)
        out = _run(FusionEngine(cfg), d0, d1, tf0, tf1, frames=1)
        xyz = np.asarray(out.raw_points)[: int(out.raw_count), :3]
        assert len(xyz) > (H0 * W0 + H1 * W1) // 2
        mask = np.ones(len(xyz), bool)
    pts = np.concatenate([xyz, np.ones((len(xyz), 1))], 1).astype(np.float32)
    ids = np.asarray(grid.cell_index_clamped(jnp.asarray(pts[:, :3])))
    out_pts, count = voxelize_average_packed(
        jnp.asarray(pts), jnp.asarray(ids), jnp.asarray(mask), grid, 4096)
    _assert_matches_voxel_oracle(pts, ids, mask, out_pts, int(count), grid)


def test_hetero_pipelined_matches_sync():
    """Heterogeneous engine with pipeline_depth=1 (per-group encode on
    the worker thread, bits tuple through the packet) must match the
    synchronous hetero engine bit-for-bit."""
    rng = np.random.default_rng(9)
    d0, d1, tf0, tf1 = _scene(rng)
    sync = FusionEngine(_cfg_hetero(depth_link_codec="dpcm"))
    pipe = FusionEngine(_cfg_hetero(depth_link_codec="dpcm"),
                        pipeline_depth=1)
    out_s = _run(sync, d0, d1, tf0, tf1, frames=4)
    outs_p = []
    i0 = PinholeIntrinsics.default_for(W0, H0)
    i1 = PinholeIntrinsics.default_for(W1, H1)
    for f in range(4):
        pipe.add_depthmap(0, d0, i0, tf0, tf0)
        pipe.add_depthmap(1, d1, i1, tf1, tf1)
        o = pipe.process(10.0 + f / 30.0)
        if o is not None:
            outs_p.append(o)
    tail = pipe.flush()
    assert tail is not None
    outs_p.append(tail)
    out_p = outs_p[-1]
    np.testing.assert_array_equal(np.asarray(out_s.occupancy_u8),
                                  np.asarray(out_p.occupancy_u8))
    assert _point_set(out_s) == _point_set(out_p)
