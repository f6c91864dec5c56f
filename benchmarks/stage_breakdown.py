"""Per-stage timing breakdown in the reference's canonical schema
(``_component.cpp:471-514``; BASELINE.md): each pipeline stage jitted and
timed separately under block_until_ready, plus the fused end-to-end step
(which is what production runs — XLA fuses away the stage boundaries).

Run (from the repo root): PYTHONPATH=.:$PYTHONPATH python benchmarks/stage_breakdown.py
"""

import time

import numpy as np


def timeit(fn, *args, iters=20):
    from ros_gpu_depthmap_fusion_tpu.utils.profiling import hard_sync
    hard_sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    hard_sync(out)
    return (time.perf_counter() - t0) / iters


def main():
    import jax
    import jax.numpy as jnp
    from ros_gpu_depthmap_fusion_tpu.utils.profiling import hard_sync
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
    from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
    from ros_gpu_depthmap_fusion_tpu.ops.unproject import unproject_depthmaps
    from ros_gpu_depthmap_fusion_tpu.ops.flying_pixels import (
        filter_flying_pixels)
    from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import crop_points, compact
    from ros_gpu_depthmap_fusion_tpu.ops.voxel import (
        scatter_occupancy, update_historic_occupancy, occupancy_to_u8)
    from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
        voxelize_average_packed)
    from ros_gpu_depthmap_fusion_tpu.pipeline.engine import (
        build_fusion_step, initial_state)

    H, W, C = 480, 848, 8
    cfg = FusionConfig(
        num_depth_streams=C, depth_height=H, depth_width=W,
        crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
        voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
        voxel_size=(0.1, 0.1, 0.12), voxel_occupancy_lifetime=10,
        rollbuffer_point_capacity=131072)
    grid = VoxelGrid.from_config(cfg)
    n = C * H * W
    print(f"platform={jax.devices()[0].platform} cams={C} {W}x{H} "
          f"grid={grid.grid_size} ({grid.num_cells} cells)")

    rng = np.random.default_rng(0)
    depth = rng.integers(500, 9000, size=(C, H, W), dtype=np.uint16)
    intr = jnp.asarray(np.tile(PinholeIntrinsics.default_for(W, H)
                               .as_array(), (C, 1)))
    tfs = jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (C, 1, 1)))
    dj = jnp.asarray(depth)

    unproj = jax.jit(lambda d: unproject_depthmaps(d, intr, tfs, tfs, 0.001))
    pc, pw, pcr, m = unproj(dj)
    fly = jax.jit(lambda p, mm: filter_flying_pixels(
        p, mm, H, W, 1, 0.5, True, 10.0))
    m2 = fly(pc, m)
    crop = jax.jit(lambda p, mm: crop_points(
        p, mm, cfg.crop_min, cfg.crop_max))
    m3 = crop(pcr, m2)
    comp = jax.jit(lambda p, mm: compact(p.reshape(n, 4), mm.reshape(n), n))
    pts, cnt = comp(pw, m3)
    cell = jax.jit(lambda p: grid.cell_index_clamped(p[:, :3]))
    ids = cell(pts)
    live = jnp.arange(n) < cnt
    vox = jax.jit(lambda p, i, l: voxelize_average_packed(
        p, i, l, grid, min(grid.num_cells, n)))
    occ = jax.jit(lambda i, l: scatter_occupancy(i, l, grid.num_cells))
    fresh = occ(ids, live)
    hist0 = jnp.zeros((grid.num_cells,), jnp.int32)
    dec = jax.jit(lambda h, f: occupancy_to_u8(
        update_historic_occupancy(h, f, 10)))

    rows = [
        ("convert (unproject x2 tf)", timeit(unproj, dj)),
        ("flying_pixel", timeit(fly, pc, m)),
        ("crop", timeit(crop, pcr, m2)),
        ("mask (compact)", timeit(comp, pw, m3)),
        ("voxel_coords", timeit(cell, pts)),
        ("voxelize (packed average)", timeit(vox, pts, ids, live)),
        ("occupancy scatter", timeit(occ, ids, live)),
        ("occupancy decay+pack", timeit(dec, hist0, fresh)),
    ]
    for name, t in rows:
        print(f"{name:28s} {t*1e6:12.1f} us")
    print(f"{'sum of stages':28s} {sum(t for _, t in rows)*1e6:12.1f} us")

    # fused end-to-end step via the engine's staging helpers
    from ros_gpu_depthmap_fusion_tpu.pipeline.engine import FusionEngine
    eng = FusionEngine(cfg)
    for i in range(C):
        eng.add_depthmap(i, depth[i], PinholeIntrinsics.default_for(W, H),
                         np.eye(4, dtype=np.float32),
                         np.eye(4, dtype=np.float32))
    t0 = time.perf_counter()
    out = eng.process(1.0)
    hard_sync(out.fused_count)
    compile_t = time.perf_counter() - t0
    ts = []
    for f in range(10):
        for i in range(C):
            eng.add_depthmap(i, depth[i],
                             PinholeIntrinsics.default_for(W, H),
                             np.eye(4, dtype=np.float32),
                             np.eye(4, dtype=np.float32))
        t0 = time.perf_counter()
        out = eng.process(1.0 + f * 0.03)
        hard_sync(out.fused_count)
        ts.append(time.perf_counter() - t0)
    print(f"{'fused end-to-end step':28s} {np.mean(ts)*1e6:12.1f} us "
          f"(compile {compile_t:.1f}s) -> {1/np.mean(ts):.1f} fps")


if __name__ == "__main__":
    main()
