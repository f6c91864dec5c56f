"""Drive the public package API end-to-end on the default JAX device:
synthetic 640x480 depth -> unproject -> flying-pixel filter -> crop ->
compact -> voxel occupancy -> occupied cell centers."""
import time
import numpy as np
import jax
from ros_gpu_depthmap_fusion_tpu.utils.profiling import hard_sync
import jax.numpy as jnp

import ros_gpu_depthmap_fusion_tpu as rdf
from ros_gpu_depthmap_fusion_tpu.core import transforms
from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu.ops.unproject import unproject_depthmaps
from ros_gpu_depthmap_fusion_tpu.ops.stencil import filter_flying_pixels
from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import crop_points, compact
from ros_gpu_depthmap_fusion_tpu.ops.voxel import (
    scatter_occupancy, update_historic_occupancy, occupancy_to_u8)
from ros_gpu_depthmap_fusion_tpu.ops.voxelize import voxelize_occupied

print("devices:", jax.devices())
H, W = 480, 640
intr = PinholeIntrinsics.default_for(W, H)
grid = rdf.VoxelGrid(lower=(-4, -4, 0), upper=(4, 4, 2.5),
                     cell_size=(0.1, 0.1, 0.1))
print("grid:", grid.grid_size, grid.num_cells, "cells")

# synthetic scene: floor plane + a box, camera looking down +z
rng = np.random.default_rng(0)
u, v = np.meshgrid(np.arange(W), np.arange(H))
depth_m = np.full((H, W), 3.0)
box = (np.abs(u - 320) < 60) & (np.abs(v - 240) < 80)
depth_m[box] = 1.5
depth_u16 = (depth_m / 0.001).astype(np.uint16)
depth_u16[rng.random((H, W)) < 0.05] = 0  # dropouts

tf_world = transforms.make_se3(transforms.rot_x(-np.pi / 2), np.array([0, 0, 1.0]))
tf_crop = tf_world

def step(depth, hist):
    pc, pw, pcr, m = unproject_depthmaps(
        depth[None], jnp.asarray(intr.as_array())[None],
        jnp.asarray(tf_world)[None], jnp.asarray(tf_crop)[None], 0.001)
    m = filter_flying_pixels(pc, m, H, W, 1, 0.5, True, 10.0)
    m = crop_points(pcr, m, (-4, -4, 0), (4, 4, 2.5))
    pts, count = compact(pw.reshape(-1, 4), m.reshape(-1), H * W)
    ids = grid.cell_index_clamped(pts[:, :3])
    valid = jnp.arange(H * W) < count
    occ = scatter_occupancy(ids, valid, grid.num_cells)
    hist = update_historic_occupancy(hist, occ, lifetime=10)
    centers, ncells = voxelize_occupied(hist, grid, 20000)
    return count, hist, occupancy_to_u8(hist), centers, ncells

jstep = jax.jit(step)
hist = jnp.zeros((grid.num_cells,), jnp.int32)
t0 = time.time()
count, hist, occ8, centers, ncells = jax.block_until_ready(
    jstep(jnp.asarray(depth_u16), hist))
print(f"first call (compile): {time.time()-t0:.1f}s")
t0 = time.time()
iters = 20
for _ in range(iters):
    count, hist, occ8, centers, ncells = jstep(jnp.asarray(depth_u16), hist)
hard_sync(hist)
dt = (time.time() - t0) / iters
print(f"steady state: {dt*1e3:.2f} ms/frame -> {1/dt:.1f} fps (1 cam 640x480)")
print("valid points after filters:", int(count), "/", H * W)
print("occupied cells:", int(ncells))
c = np.asarray(centers[:int(ncells)])
print("center z range:", c[:, 2].min(), c[:, 2].max())
assert int(count) > 100000, "filters rejected almost everything"
assert 0 < int(ncells) < 20000
# the floor is at world z=0 (camera at z=1 looking down? rot_x(-90): cam +z -> world -y... )
print("sample centers:", c[:3])

# probe 1: all-zero depth -> zero points, zero fresh occupancy, history decays
count0, hist2, _, _, n2 = jax.block_until_ready(
    jstep(jnp.zeros((H, W), jnp.uint16), hist))
print("probe zero-depth: count =", int(count0), "cells:", int(n2))
assert int(count0) == 0
assert int(n2) == int(ncells)  # decayed by 1 but still >0 (lifetime 10)

# probe 2: decay to extinction after lifetime frames
h = hist2
for _ in range(12):
    _, h, _, _, nl = jstep(jnp.zeros((H, W), jnp.uint16), h)
print("probe decay: cells after 12 empty frames =", int(nl))
assert int(nl) == 0

# probe 3: compaction capacity overflow is explicit, not silent corruption
pts_over, cnt_over = compact(jnp.ones((100, 4)), jnp.ones(100, bool), 10)
assert int(cnt_over) == 10 and pts_over.shape == (10, 4)
print("probe overflow: capped at", int(cnt_over))
print("ALL CHECKS PASSED")
