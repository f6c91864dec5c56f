"""Flying-pixel Triton kernel: parity with the jnp reference in interpret
mode (the kernel has no CPU compile; ``chip_smoke.py`` compares the
compiled kernel with the reference on the GPU) and the platform dispatch
the fused step calls."""

import numpy as np
import jax
import jax.numpy as jnp

from ros_gpu_depthmap_fusion_tpu.ops.stencil import filter_flying_pixels
from ros_gpu_depthmap_fusion_tpu.ops import flying_pixels as FP
from ros_gpu_depthmap_fusion_tpu.ops.unproject import unproject_depthmaps


def _scene(h, w, seed=0, c=2):
    rng = np.random.default_rng(seed)
    depth = (1500 + 40 * np.sin(np.arange(w) / 5.0)[None, None, :]
             + 30 * np.cos(np.arange(h) / 4.0)[None, :, None]
             + 5 * rng.standard_normal((c, h, w))).astype(np.uint16)
    depth[rng.random((c, h, w)) < 0.05] = 0
    eye = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    pc, _, _, m = unproject_depthmaps(
        jnp.asarray(depth),
        jnp.array([[100.0, 100.0, (w - 1) / 2, (h - 1) / 2]] * c),
        jnp.asarray(eye), jnp.asarray(eye), 0.001)
    return pc, m


def test_flying_pixels_pallas_matches_jnp():
    # several row bands and column blocks, width not a multiple of 128
    h, w = 40, 150
    pc, m = _scene(h, w)
    for size, rot45 in [(1, False), (1, True), (2, True)]:
        ref = filter_flying_pixels(pc, m, h, w, size, 0.4, rot45, 10.0)
        got = FP.filter_flying_pixels_triton(pc, m, h, w, size, 0.4, rot45,
                                             10.0, interpret=True)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=f"size={size} rot45={rot45}")


def test_flying_pixels_pallas_band_boundaries():
    # band edges every 16 rows, block edges at column 128, a 3-ring halo
    h, w = 33, 130
    pc, m = _scene(h, w, seed=5)
    ref = filter_flying_pixels(pc, m, h, w, 3, 0.3, True, 10.0)
    got = FP.filter_flying_pixels_triton(pc, m, h, w, 3, 0.3, True, 10.0,
                                         interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_auto_dispatch_on_cpu():
    """Off CUDA the dispatch lowers the jnp reference (the kernel branch is
    traced but never compiled), with traced filter scalars."""
    h, w = 8, 16
    pc, m = _scene(h, w, seed=2, c=1)
    fn = jax.jit(FP.filter_flying_pixels, static_argnums=(2, 3, 4, 6))
    out = fn(pc, m, h, w, 1, 0.5, True, 10.0)
    assert out.shape == (1, h * w)
    np.testing.assert_array_equal(
        np.asarray(out),
        np.asarray(filter_flying_pixels(pc, m, h, w, 1, 0.5, True, 10.0)))
