"""Multi-host (multi-process) sharded fusion runner.

Each process owns ``--devices-per-process`` devices (virtual CPU devices
here; one GPU per process in production) and joins a ``jax.distributed``
cluster; the ``(stream, space)`` mesh then spans every device of every
process, so the exact same :class:`ShardedFusionEngine` program runs with
collectives crossing processes (SURVEY.md §2.7/§5 "distributed communication
backend"; BASELINE.md multi-host scaling row). The reference has no
multi-machine story at all — its inter-process transport is ROS TCP
pub/sub of *inputs*, never distributed compute.

Run via ``scripts/run_multihost.sh`` (2 processes x 4 devices), or single
process as the equivalence baseline:

    python examples/run_multihost.py --digest-out /tmp/base.json

Writes (process 0 only) a JSON digest of the fused outputs — sorted-row
hashes, so it is invariant to the space-block output order — which the
multi-process run must reproduce EXACTLY (integer partial sums commute;
see ops/voxelize.voxelize_partial_sums).
"""

import argparse
import hashlib
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:12421")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--devices-per-process", type=int, default=4)
    ap.add_argument("--num-space", type=int, default=2)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--digest-out", default="")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count="
          f"{args.devices_per_process}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id)
    import numpy as np
    from jax.experimental import multihost_utils

    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
    from ros_gpu_depthmap_fusion_tpu.core import transforms
    from ros_gpu_depthmap_fusion_tpu.parallel.mesh import make_mesh
    from ros_gpu_depthmap_fusion_tpu.parallel.engine import (
        ShardedFusionEngine)

    n_dev = len(jax.devices())
    assert n_dev == args.num_processes * args.devices_per_process, (
        n_dev, args.num_processes, args.devices_per_process)
    mesh = make_mesh(num_space=args.num_space)
    log = (lambda m: print(f"[mh {args.process_id}] {m}", flush=True))
    log(f"processes={args.num_processes} devices={n_dev} "
        f"mesh={dict(mesh.shape)}")

    H, W, C = 48, 64, 4
    cfg = FusionConfig(
        num_depth_streams=C, depth_height=H, depth_width=W,
        num_point_sequences=1,
        crop_min=(-6, -6, 0), crop_max=(6, 6, 2.5),
        voxel_min=(-6, -6, 0), voxel_max=(6, 6, 2.5),
        voxel_size=(0.25, 0.25, 0.25), voxel_occupancy_lifetime=5,
        rollbuffer_point_capacity=512, rollbuffer_seq_capacity=16,
        max_points_per_sequence=256)
    eng = ShardedFusionEngine(cfg, mesh)
    intr = PinholeIntrinsics.default_for(W, H)

    cams = []
    for i in range(C):
        ang = i * 2 * np.pi / C
        pos = np.array([3 * np.cos(ang), 3 * np.sin(ang), 1.5])
        cams.append(transforms.make_se3(
            transforms.rot_z(ang + np.pi) @ transforms.rot_x(-np.pi / 2),
            pos))

    # deterministic synthetic frames — every process generates the same
    rng = np.random.default_rng(7)
    frames = []
    for f in range(args.frames):
        d = (2000 + 300 * rng.standard_normal((C, H, W))).astype(np.uint16)
        d[rng.random((C, H, W)) < 0.05] = 0
        t = np.linspace(0, np.pi, 64)
        arc = np.stack([2 * np.cos(t + f * 0.1), 2 * np.sin(t + f * 0.1),
                        1 + 0 * t], axis=-1).astype(np.float32)
        frames.append((d, arc))

    out = None
    for f, (d, arc) in enumerate(frames):
        for i in range(C):
            eng.add_depthmap(i, d[i], intr, cams[i], cams[i])
        eng.add_point_sequence(arc, sec=5, nsec=int(f * 33e6),
                               tf_move=np.eye(4, dtype=np.float32))
        out = eng.process(5.0 + f / 30.0)
    log(f"ran {len(frames)} frames")

    # global gather of the sharded outputs (DCN collective in the
    # multi-process case), then an order-invariant digest
    g = multihost_utils.process_allgather(
        (out.fused_points, out.fused_counts, out.occupancy_u8,
         out.raw_counts), tiled=True)
    fused_points, fused_counts, occupancy_u8, raw_counts = map(np.asarray, g)
    blocks = fused_points.reshape(len(fused_counts), -1, 4)
    rows = np.concatenate(
        [blocks[j, : int(fused_counts[j])] for j in range(len(fused_counts))])
    order = np.lexsort(rows.T)
    digest = {
        "devices": n_dev,
        "processes": args.num_processes,
        "fused_total": int(fused_counts.sum()),
        "raw_total": int(raw_counts.sum()),
        "occ_sum": int(occupancy_u8.astype(np.int64).sum()),
        "fused_rows_sha": hashlib.sha256(
            np.ascontiguousarray(rows[order]).tobytes()).hexdigest(),
        "occ_sha": hashlib.sha256(
            occupancy_u8.tobytes()).hexdigest(),
    }
    log(f"digest: {digest}")
    if args.digest_out and args.process_id == 0:
        with open(args.digest_out, "w") as fh:
            json.dump(digest, fh)
    # keep every process alive until the gather finished everywhere
    multihost_utils.sync_global_devices("run_multihost_done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
