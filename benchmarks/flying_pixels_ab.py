"""Flying-pixel filter: XLA's fusion of the jnp form against the Triton
kernel, alone and inside the fused step, at 6 x 480 x 848 on one GPU.

Run: python benchmarks/flying_pixels_ab.py
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def timed(fn, reps, sync):
    t = time.perf_counter()
    for _ in range(reps):
        r = fn()
    sync(r)
    return (time.perf_counter() - t) / reps * 1e3


def main():
    import jax
    import jax.numpy as jnp
    import chip_smoke as cs
    from ros_gpu_depthmap_fusion_tpu.ops.stencil import filter_flying_pixels
    from ros_gpu_depthmap_fusion_tpu.ops.flying_pixels import (
        filter_flying_pixels_triton)
    from ros_gpu_depthmap_fusion_tpu.ops.unproject import (
        unproject_depthmaps)
    from ros_gpu_depthmap_fusion_tpu.pipeline import engine as engine_mod
    dispatch = engine_mod.filter_flying_pixels
    assert jax.default_backend() == "gpu", jax.default_backend()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    scene = cs.make_scene()
    depth = scene["depths"][0]
    c, h, w = depth.shape
    tfs = jnp.asarray(np.stack(scene["cams"](0)))
    intr = jnp.asarray(np.tile(scene["intr"].as_array(), (c, 1)))
    pc, _, _, m = jax.jit(unproject_depthmaps, static_argnums=(4,))(
        jnp.asarray(depth), intr, tfs, tfs, 0.001)
    jnp_fn = jax.jit(filter_flying_pixels, static_argnums=(2, 3, 4, 6))
    for fs in (1, 2):
        a = jnp_fn(pc, m, h, w, fs, 0.5, True, 10.0)
        b = filter_flying_pixels_triton(pc, m, h, w, fs, 0.5, True, 10.0)
        diff = int((np.asarray(a) != np.asarray(b)).sum())
        ta, tb = [], []
        for order in ("ab", "ba", "ab", "ba"):
            for v in order:
                if v == "a":
                    ta.append(timed(lambda: jnp_fn(pc, m, h, w, fs, 0.5,
                                                   True, 10.0), 50,
                                    jax.block_until_ready))
                else:
                    tb.append(timed(lambda: filter_flying_pixels_triton(
                        pc, m, h, w, fs, 0.5, True, 10.0), 50,
                        jax.block_until_ready))
        print(f"filter alone size {fs}: jnp/XLA {np.median(ta):.4f} ms "
              f"{[round(x, 4) for x in ta]} | triton {np.median(tb):.4f} "
              f"ms {[round(x, 4) for x in tb]} | masks differ at {diff} px",
              flush=True)

    cfg = cs.engine_config("none", scene)
    engines = {}
    for name, fn in (("jnp", filter_flying_pixels), ("triton", dispatch)):
        engine_mod.filter_flying_pixels = fn   # read when the step traces
        eng = engine_mod.FusionEngine(cfg)
        for f in range(5):
            out = cs.feed_frame(eng, scene, f)
        jax.block_until_ready(out)
        engines[name] = eng
    engine_mod.filter_flying_pixels = dispatch
    a, b = engines["jnp"], engines["triton"]
    occ_a = np.asarray(cs.feed_frame(a, scene, 5).occupancy_u8)
    occ_b = np.asarray(cs.feed_frame(b, scene, 5).occupancy_u8)
    print(f"engines' occupancy differs at {int((occ_a != occ_b).sum())} "
          f"cells", flush=True)

    def step_ms(eng):
        d = scene["depths"][0]
        cams = scene["cams"](0)
        for i in range(c):
            eng.add_depthmap(i, d[i], scene["intr"], cams[i], cams[i])
        view, bits = eng._encode(eng._pkt, eng._depth_host, (
            11, 0, 10, 900000000, 0, 0, eng.fp_threshold,
            eng.fp_max_distance, eng.ps_threshold))
        dev = jax.device_put(np.array(view))
        st = eng.state
        st, o = eng.step(st, dev, depth_bits=bits)
        jax.block_until_ready(o)
        t = time.perf_counter()
        for _ in range(30):
            st, o = eng.step(st, dev, depth_bits=bits)
        jax.block_until_ready(o)
        eng.state = st
        return (time.perf_counter() - t) / 30 * 1e3

    # ten pairs, alternating which side runs first
    sa, sb = [], []
    for order in ("ab", "ba") * 5:
        for v in order:
            (sa if v == "a" else sb).append(step_ms(a if v == "a" else b))
    wins = sum(y < x for x, y in zip(sa, sb))
    print(f"fused step (raw link, 6x480x848 + lidar): jnp/XLA "
          f"{np.median(sa):.4f} ms {[round(x, 4) for x in sa]} | triton "
          f"{np.median(sb):.4f} ms {[round(x, 4) for x in sb]} | triton "
          f"faster in {wins}/10 pairs", flush=True)


if __name__ == "__main__":
    main()
