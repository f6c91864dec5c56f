"""Sort/group micro-benchmark — the analog of the reference's standalone
``src/gl_compute_test.cpp`` harness (1M u32 keys, per-stage microseconds):
native C++ OpenMP radix sort vs numpy stable argsort vs on-device
``jax.lax.sort``, plus grouping throughput.

Run (from the repo root): PYTHONPATH=.:$PYTHONPATH python benchmarks/sort_bench.py
"""

import time

import numpy as np


def bench(fn, *args, iters=5):
    fn(*args)  # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters, out


def main():
    from ros_gpu_depthmap_fusion_tpu.utils import native
    n = 1_000_000  # reference gl_compute_test.cpp:31
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)

    print(f"sort/group micro-benchmark, {n} u32 keys "
          f"(native={native.available()})")

    t, (sk, si) = bench(native.radix_sort_u32, keys)
    print(f"native radix sort:      {t*1e6:12.0f} us")

    t, _ = bench(lambda k: np.argsort(k, kind='stable'), keys)
    print(f"numpy stable argsort:   {t*1e6:12.0f} us")

    t, _ = bench(native.group_sorted_u32, sk)
    print(f"native group:           {t*1e6:12.0f} us")

    try:
        import jax
        from ros_gpu_depthmap_fusion_tpu.utils.profiling import hard_sync
        import jax.numpy as jnp
        from ros_gpu_depthmap_fusion_tpu.ops.voxelize import sort_by_key
        kj = jnp.asarray(keys.astype(np.int32))
        idx = jnp.arange(n, dtype=jnp.int32)
        f = jax.jit(lambda k, i: sort_by_key(k, i))
        hard_sync(f(kj, idx))
        t0 = time.perf_counter()
        for _ in range(5):
            out = f(kj, idx)
        hard_sync(out)
        t = (time.perf_counter() - t0) / 5
        print(f"device lax.sort ({jax.devices()[0].platform}): "
              f"{t*1e6:10.0f} us")
    except Exception as e:  # device may be unavailable in some envs
        print("device sort skipped:", e)

    # cell-id grouping at the fusion operating point (2.4M points)
    cell_ids = rng.integers(0, 3_400_000, size=2_400_000).astype(np.uint32)
    t, (sk, si) = bench(native.radix_sort_u32, cell_ids, iters=3)
    t2, (_, _, _, ng) = bench(native.group_sorted_u32, sk, iters=3)
    print(f"2.4M cell-id sort+group: {1e6*(t+t2):11.0f} us "
          f"({ng} groups) [reference's per-frame CPU voxelize path]")


if __name__ == "__main__":
    main()
