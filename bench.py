"""Headline benchmark: fused depth frames/s per device.

Workload: 8 RGB-D streams at 848x480 on a MOVING scene with realistic
30 Hz inter-frame statistics:

- static background (walls/terrain wave field) seen by each camera,
- per-camera FIXED pattern noise, sigma 6 mm (stereo depth cameras'
  dominant noise component is spatially fixed speckle/pattern, not
  temporally white) + 1 mm fresh per-frame noise,
- per-camera PERSISTENT hole mask (1%, geometry/material-driven) with
  0.1%/frame churn,
- a moving object: 400 mm blob circling at ~2.3 px/frame (~70 px/s,
  fast-object-class at 30 fps) — voxel content, lidar arcs and the
  swaying rig all still move every frame.

2 lidar streams x 8192 points/frame ride alongside; everything fuses
into the reference's largest deployment grid (40m x 40m x 2.5m at
0.1/0.1/0.12 -> 400x400x21 ~ 3.4M cells,
launch/gpu_depthmap_fusion.launch:144-159), full pipeline per frame:
unproject -> flying-pixel filter -> crop -> voxelize(average) ->
occupancy + temporal decay, plus rollbuffer maintenance over the 0.1 s
aggregation window (capacity 98,304 points, under the reference's
~100k-point cap, gpu_depthmap_fusion.cpp:1271-1275).

Depth link: TEMPORAL codec (dpcm_temporal + p4 sparse P-frames) at
quant_shift=4 with 2 mm hysteresis — depth quantized to 16 mm, error
<= 8 mm fresh / <= 10 mm held. stderr records the per-window packet
bytes, P/I mix and spill diagnostics so the operating point is explicit.
Lidar points ride as 3 x u16 at 2 mm link quantization (error <= 1 mm).

Baseline: the reference's designed processing rate is 30 Hz on a desktop
GPU with up to 6 streams (launch:29-32; no published numbers exist —
BASELINE.md). ``vs_baseline`` is fps / 30.

HEADLINE = MEDIAN of 12 x 60-frame timed windows (max reported
alongside); stderr logs per-window fps + selected-lidar-count + process()
host time, and an isolated h2d/step measurement runs before AND after the
windows.

Prints JSON lines on stdout; the LAST line is the headline metric.
Everything needed to explain the number (device, native-lib availability,
codec width/bytes, XLA cache state, per-phase costs, per-window rates)
goes to stderr.

Run: ``python bench.py`` on the GPU (one process; it fails loudly).
"""

import json
import os
import sys
import time

import numpy as np


def log(msg):
    sys.stderr.write(f"[bench] {msg}\n")
    sys.stderr.flush()


def main():
    import jax
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
    from ros_gpu_depthmap_fusion_tpu.core import transforms
    from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine
    from ros_gpu_depthmap_fusion_tpu.utils import native

    from ros_gpu_depthmap_fusion_tpu.utils.compilation_cache import (
        enable_persistent_compilation_cache)

    t_start = time.time()
    cache_dir = enable_persistent_compilation_cache()
    cache_entries = (len(os.listdir(cache_dir))
                     if os.path.isdir(cache_dir) else 0)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{dev.platform!r}")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": jax.device_count()}
    log(f"platform={dev.platform} kind={dev.device_kind} "
        f"devices={jax.device_count()} "
        f"xla_cache_entries={cache_entries} ({cache_dir})")
    log(f"native_lib={'OK' if native.available() else 'MISSING (numpy '
        'fallback — expect large encode times)'}")

    H, W, C = 480, 848, 8
    N_LIDAR_STREAMS, LIDAR_PTS = 2, 8192
    cfg = FusionConfig(
        num_depth_streams=C, depth_height=H, depth_width=W,
        num_point_sequences=N_LIDAR_STREAMS,
        crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
        voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
        voxel_size=(0.1, 0.1, 0.12),
        voxel_occupancy_lifetime=10,
        # rollbuffer sized to the benched lidar load: 2 streams x 8192
        # pts/frame over the 0.1 s aggregation window @30 Hz = up to 4
        # staged frames ~ 65k selected points -> 96k capacity (1.5x; the
        # reference's GPU path hard-discards above 100k,
        # gpu_depthmap_fusion.cpp:1271-1275)
        rollbuffer_point_capacity=98304,
        max_points_per_sequence=N_LIDAR_STREAMS * LIDAR_PTS,
        # temporal p4 link: 16 mm quantization + 2 mm hysteresis (error
        # <= 10 mm) — P-frames ship 4-px-group flags + 48 budgeted
        # literal bytes/row of 4-bit codes (deltas to +-7 bins
        # in-stream); the exception budget absorbs revivals + spills
        # (stderr prints exc/spill diagnostics vs these caps every run)
        depth_link_codec="dpcm_temporal",
        depth_codec_p4_budget=48,
        depth_codec_hysteresis=2,
        # the hysteresis delta chain is lossless, so keyframes exist for
        # resync (joiners/packet loss), not quality — 4 s cadence
        depth_codec_keyframe_interval=120,
        depth_codec_quant_shift=4,
        # a spike beyond the exception budget falls back to one visible
        # I-frame (P/I per window in stderr)
        depth_codec_max_exceptions=8192,
        lidar_link_quant_step=0.002,
        # delta-code the lidar staging (4-bit zigzag deltas, one
        # u16/point): scan-adjacent points step millimetres, so the
        # 98 KB u16 section shrinks to ~49 KB incl. the exception
        # budget; bit-exact vs plain staging (tests/test_packet.py)
        lidar_link_delta=True,
        # emitted-cell cap sized to this scene's steady state (stderr
        # prints fused_count vs this every run) — the occupancy
        # scatter-max and output compaction scale with the CAP, not the
        # live count
        voxelize_output_capacity=16384,
        emit_raw_points=False,  # publish-parity: only the voxelized cloud
        # mapping consumes the packed/sparse occupancy; skip the dense u8
        # materialization
        emit_occupancy_u8=False,
        # mapping d2h payload: nonzero 128-bit bitmap blocks as
        # (idx, 4 words) rows (true count is logged vs this cap every
        # run — overflow falls back to dense)
        occupancy_sparse_capacity=4096,
    )
    # pipeline_depth=1: frame k is encoded and copied to the device while
    # step k-1 computes
    eng = FusionEngine(cfg, pipeline_depth=1)
    intr = PinholeIntrinsics.default_for(W, H)

    rng = np.random.default_rng(0)
    u, v = np.meshgrid(np.arange(W), np.arange(H))

    # MOVING scene with realistic 30 Hz inter-frame statistics (module
    # docstring): static background + per-camera fixed pattern noise +
    # persistent holes with churn + a small object circling at
    # ~2.3 px/frame. 8 staged frames per camera forming a CLOSED loop
    # (the blob circles, churn masks cycle), fresh noise per staged
    # frame. Pre-staged per camera: 8 x 8 x 814 KB = 52 MB host RAM.
    N_STAGED = 8
    base = (2500 + 200 * np.sin(u / 150.0)
            + 150 * np.cos(v / 120.0))
    depths = []  # [N_STAGED][C] u16 frames
    pattern = [rng.normal(0.0, 6.0, (H, W)) for _ in range(C)]
    holes_fix = [rng.random((H, W)) < 0.01 for _ in range(C)]
    churn = [[rng.random((H, W)) < 0.001 for _ in range(C)]
             for _ in range(N_STAGED)]
    for k in range(N_STAGED):
        ang = 2 * np.pi * k / N_STAGED
        cx = W * 0.5 + 6.0 * np.cos(ang)   # ~2.3 px/frame object motion
        cy = H * 0.5 + 6.0 * np.sin(ang)
        blob = 400 * np.exp(-(((u - cx) / 25.0) ** 2
                             + ((v - cy) / 20.0) ** 2))
        cams_k = []
        for i in range(C):
            d = (base - blob + pattern[i]
                 + rng.standard_normal((H, W))).astype(np.uint16)
            d[holes_fix[i] | churn[k][i]] = 0
            cams_k.append(d)
        depths.append(cams_k)

    def cams_at(f):
        yaw0 = 0.02 * np.sin(2 * np.pi * f / 60.0)  # rig sway
        out = []
        for i in range(C):
            ang = i * 2 * np.pi / C + yaw0
            pos = np.array([8 * np.cos(ang), 8 * np.sin(ang), 2.0])
            out.append(transforms.make_se3(
                transforms.rot_z(ang + np.pi)
                @ transforms.rot_x(-np.pi / 2 - 0.3), pos))
        return out

    # 2 lidar streams: rotating arcs at different radii (staged per frame)
    t_l = np.linspace(0, np.pi, LIDAR_PTS)
    arcs = []
    for k in range(N_STAGED):
        rot = 2 * np.pi * k / N_STAGED
        arcs.append([
            np.stack([6 * np.cos(t_l + rot), 6 * np.sin(t_l + rot),
                      1 + 0.3 * np.sin(5 * t_l)], axis=-1)
            .astype(np.float32),
            np.stack([12 * np.cos(-t_l * 0.7 + rot),
                      12 * np.sin(-t_l * 0.7 + rot),
                      1.5 + 0 * t_l], axis=-1).astype(np.float32),
        ])

    # UNCAPPED per-frame series. proc_ms is the HOST-side process() time
    # per frame: in pipelined mode that is dominated by waiting on the
    # in-flight put, so its per-window median tracks the transfer leg
    # while bytes tracks the codec.
    bytes_hist, proc_ms_hist = [], []

    # ONE monotone frame clock across warmup, timed windows and the
    # mapping loop: restarting the frame counter per window rewinds
    # timestamps, which pins the rollbuffer's monotone-insert clamp at the
    # high-water mark — select_timespan then returns ~0 lidar points and
    # expiry never fires, so the timed frames would exercise a degenerate
    # empty-selection lidar path.
    frame_clock = [0]

    p_frames = [0]
    i_frames = [0]

    def run_frame():
        f = frame_clock[0]
        frame_clock[0] += 1
        d = depths[f % N_STAGED]
        cams = cams_at(f)
        for i in range(C):
            eng.add_depthmap(i, d[i], intr, cams[i], cams[i])
        for s, arc in enumerate(arcs[f % N_STAGED]):
            eng.add_point_sequence(
                arc, sec=10 + (f // 30), nsec=int((f % 30) * 33e6),
                tf_move=np.eye(4, dtype=np.float32))
        t0 = time.perf_counter()
        out = eng.process(10.0 + f / 30.0)
        if out is not None:  # pipelined first call returns nothing yet
            bits = eng.last_frame_bits
            bytes_hist.append(4 * eng.layout.total_words(bits))
            proc_ms_hist.append((time.perf_counter() - t0) * 1e3)
            if bits == "p4":
                p_frames[0] += 1
            else:
                i_frames[0] += 1
        return out

    # warmup/compile over ALL pre-staged frames so every codec width (and
    # therefore every jit variant) the timed loop can hit is compiled
    # before timing starts.
    t0 = time.time()
    bits_seen = set()
    # warm until the rollbuffer's aggregation window is in steady state
    # (0.1 s @ 30 Hz = 4 staged frames) AND every codec variant the run
    # can hit is compiled (frame 0 = spatial I-keyframe, rest = p4)
    for _ in range(N_STAGED + 4):
        out = run_frame()
        if out is not None:  # pipelined: first call has nothing to return
            _ = int(np.asarray(out.fused_count))
            bits_seen.add(eng.last_frame_bits)
    log(f"warmup {time.time() - t0:.1f}s over {N_STAGED + 4} frames; "
        f"codec_bits={sorted(map(str, bits_seen))} quant_shift="
        f"{cfg.depth_codec_quant_shift} hysteresis="
        f"{cfg.depth_codec_hysteresis} "
        f"P/I so far {p_frames[0]}/{i_frames[0]} "
        f"(spilled groups last frame {eng.last_p4_spilled}) "
        f"packet={np.mean(bytes_hist) / 1e6:.2f} MB/frame "
        f"(raw depth {C * H * W * 2 / 1e6:.2f} MB) "
        f"host process() {np.median(proc_ms_hist):.1f} ms/frame")
    if "p4" not in map(str, bits_seen):
        log("WARNING: p4 P-frames did not engage during warmup — the "
            "codec is off its target regime; numbers will reflect "
            "I-frame bytes")
    fused_n = int(np.asarray(out.fused_count))
    log(f"fused cells: {fused_n} cap={cfg.voxelize_output_capacity} "
        f"({'OVERFLOW — raise voxelize_output_capacity' if fused_n >= cfg.voxelize_output_capacity else 'ok'})")

    # --- speed-of-light accounting: measure the two pipeline legs in
    # isolation so the fps number is explainable. The pipelined loop's
    # ceiling is 1/max(transfer, step, encode).
    def measure_light(reps=12):
        # typical packet size from the live series (with the temporal
        # codec the packets are P-frames most of the time); the h2d leg
        # is timed on a random buffer of exactly that size
        pkt_bytes = int(np.median(bytes_hist[-12:]))
        lrng = np.random.default_rng(1)
        psnaps = [lrng.integers(0, 2**32, max(pkt_bytes // 4, 1),
                                dtype=np.uint32) for _ in range(4)]
        # SUSTAINED transfer throughput: puts issued back-to-back with
        # ONE sync at the end — that is what the pipelined loop pays.
        put_ms, step_ms = [], []
        for _ in range(3):
            t = time.perf_counter()
            devs = [jax.device_put(psnaps[i % 4]) for i in range(reps)]
            # one sync on the LAST put (transfers complete in order)
            _ = np.asarray(devs[-1][:1])
            put_ms.append((time.perf_counter() - t) / reps * 1e3)
        # the step leg re-steps one I-KEYFRAME repeatedly: an I-frame's
        # decode is IDEMPOTENT on the P-frame prediction state and its
        # occupancy contribution is the true scene. (Re-stepping a
        # P-frame re-applies its deltas every rep — a corrupted
        # prediction state splatters the occupancy grid with speck
        # components for the decay lifetime.) Slightly overstates the
        # typical p4 step: the spatial decode is the heavier one.
        eng._frames_since_key = 10 ** 9  # force an I-frame encode
        view, bits = eng._encode(eng._pkt, eng._depth_host, (
            10, 0, 9, 900000000, 0, 0,
            eng.fp_threshold, eng.fp_max_distance, eng.ps_threshold))
        dev = jax.device_put(np.array(view))
        st = eng.state
        st, o = eng.step(st, dev, depth_bits=bits)
        _ = int(np.asarray(o.fused_count))  # settle queue before timing
        for _ in range(2):
            # steps CHAIN through the donated state, so one sync at the
            # end covers the whole run
            t = time.perf_counter()
            for _ in range(reps):
                st, o = eng.step(st, dev, depth_bits=bits)
            _ = int(np.asarray(o.fused_count))
            step_ms.append((time.perf_counter() - t) / reps * 1e3)
        eng.state = st
        return (pkt_bytes, float(np.median(put_ms)),
                float(np.min(step_ms)))

    pkt_bytes, put_ms, step_ms = measure_light()
    link_mbs = pkt_bytes / 1e3 / put_ms
    sol_ms = max(put_ms, step_ms)
    log(f"speed-of-light: packet {pkt_bytes / 1e6:.2f} MB -> h2d "
        f"{put_ms:.1f} ms ({link_mbs:.0f} MB/s) | device step+drain "
        f"{step_ms:.1f} ms | host process() "
        f"{np.median(proc_ms_hist):.1f} ms "
        f"-> pipelined ceiling {1e3 / sol_ms:.1f} fps "
        f"(puts back-to-back with one sync, steps chained through the "
        f"donated state)")

    # timed: async frames pipeline through the transfer; the drain at the
    # end is INSIDE the window so only fully completed work is counted.
    # Each window logs its own diagnostics (selected lidar points, encode
    # ms).
    windows, iters, gap_s = 12, 60, 12.0
    rates, sel_counts = [], []
    for wd in range(windows):
        h0 = len(proc_ms_hist)
        p0, i0 = p_frames[0], i_frames[0]
        t0 = time.time()
        for _ in range(iters):
            out = run_frame()
        sel = int(np.asarray(out.seq_selected_count))
        _ = int(np.asarray(out.fused_count))
        dt_w = time.time() - t0
        rates.append(iters / dt_w)
        sel_counts.append(sel)
        proc_w = np.asarray(proc_ms_hist[h0:])
        bytes_w = np.asarray(bytes_hist[h0:])
        log(f"window {wd}: {rates[-1]:.2f} fps | seq_selected={sel} "
            f"| host process() med {np.median(proc_w):.1f} "
            f"p90 {np.percentile(proc_w, 90):.1f} ms "
            f"| packet med {np.median(bytes_w) / 1e3:.0f} KB "
            f"| P/I {p_frames[0] - p0}/{i_frames[0] - i0} "
            f"| wall {dt_w:.2f}s")
        if wd < windows - 1:
            time.sleep(gap_s)
    fps_median = float(np.median(rates))
    fps_max = float(np.max(rates))
    log(f"windows fps={['%.2f' % r for r in rates]} -> "
        f"median {fps_median:.2f} (max {fps_max:.2f})")
    if min(sel_counts) == 0:
        log("WARNING: a timed window selected 0 lidar sequences — the "
            "rollbuffer path was degenerate; numbers not representative")
    # re-measure the isolated legs AFTER the windows: a moved step cost
    # explains a window spread
    _, put_ms2, step_ms2 = measure_light(reps=8)
    log(f"post-windows re-measure: h2d {put_ms2:.1f} ms "
        f"(was {put_ms:.1f}) | step {step_ms2:.1f} ms (was {step_ms:.1f})")

    # --- mapping-on: segmentation + tracking run concurrently over the
    # latest occupancy grid (reference's 17-stage loop through tracking,
    # _component.cpp:471-514, with its resample-decoupling semantics
    # applied between fusion and mapping) ---
    from ros_gpu_depthmap_fusion_tpu.mapping.pipeline import (
        AsyncMappingWorker, MappingPipeline)
    eng.enable_mapping = True
    # detail pruning ON for the measured loop (default 0.0 keeps full
    # reference-parity detail; the bench opts in because its consumer is
    # the tracker only — config.py mapping_detail_min_area)
    eng.mapping = MappingPipeline(cfg.replace(mapping_detail_min_area=-1.0),
                                  eng.grid)
    # warm the mapping path OUTSIDE the timed window (first cycle compiles
    # the segmentation programs)
    out = run_frame()
    t0 = time.time()

    def sparse_of(o):
        return (o.occupancy_sparse_idx, o.occupancy_sparse_words,
                o.occupancy_sparse_count, o.occupancy_sparse_true,
                o.occupancy_bits)
    res = eng.mapping.process_sparse(sparse_of(out))
    sp_true = int(np.asarray(out.occupancy_sparse_true))
    phase = getattr(eng.mapping, "last_phase_ms", None)
    log(f"mapping warm cycle {time.time() - t0:.2f}s "
        f"({len(res.objects)} objects) phase_ms="
        f"{tuple(round(p, 1) for p in phase) if phase else 'n/a'}"
        f" (d2h/segment/assemble+track); sparse occupancy blocks "
        f"true={sp_true} cap={cfg.occupancy_sparse_capacity} "
        f"({'OVERFLOW — dense fallback engaged' if sp_true > cfg.occupancy_sparse_capacity else 'ok'})")
    # the mapping-on loop runs at the reference's 30 Hz DESIGN rate (its
    # resample timer, launch:29-32): an unpaced loop grows the device
    # queue without bound and every mapping d2h then waits behind the
    # whole queue — which benchmarks queue depth, not mapping capacity.
    # Fused headline above stays the unpaced number.
    worker = AsyncMappingWorker(eng.mapping, packed=True)
    t0 = time.time()
    map_iters = 4 * iters
    period = 1.0 / 30.0
    # BOUNDED device queue + guaranteed-drained bitmaps: after dispatching
    # frame k, frame k-LAG is drained (its d2h result was prefetched with
    # copy_to_host_async) and ITS bitmap goes to the worker — the
    # worker's d2h is then a pure transfer instead of waiting behind
    # every queued step. If fusion can't hold 30 Hz the drain
    # backpressures the loop to the step rate and the queue stays at LAG
    # frames.
    from collections import deque
    LAG = 4
    lagq = deque()
    for f in range(1, map_iters + 1):
        out = run_frame()
        # mapping consumes 3 of every 5 frames (18 Hz ceiling): the cycle
        # is HOST work (native CC + assembly + tracking) that shares the
        # cores with the fusion loop's encode/stage threads
        want_map = (f % 5) < 3
        if hasattr(out.fused_count, "copy_to_host_async"):
            out.fused_count.copy_to_host_async()
            # prefetch the SPARSE occupancy at ENQUEUE: its d2h then
            # overlaps the next LAG frames' compute, so the worker's
            # np.asarray finds host-resident bytes instead of queueing
            # behind device work
            if want_map:
                for a in sparse_of(out)[:4]:
                    a.copy_to_host_async()
        lagq.append((out, want_map))
        if len(lagq) > LAG:
            drained, mapit = lagq.popleft()
            _ = int(np.asarray(drained.fused_count))
            if mapit:
                worker.submit(sparse_of(drained))
        lag = t0 + f * period - time.time()
        if lag > 0:
            time.sleep(lag)
    _ = int(np.asarray(out.fused_count))
    sel_map = int(np.asarray(out.seq_selected_count))
    dt_map = time.time() - t0
    map_fps = map_iters / dt_map
    cycles = worker.cycles
    worker.close()
    tracks = len(worker.latest().tracks) if worker.latest() else 0
    phase = getattr(eng.mapping, "last_phase_ms", None)
    log(f"mapping-on @30Hz pacing: {map_fps:.2f} fused fps, "
        f"{cycles / dt_map:.1f} mapping cycles/s "
        f"({cycles}/{map_iters} frames mapped, "
        f"{tracks} tracks, seq_selected={sel_map}, last cycle phase_ms="
        f"{tuple(round(p, 1) for p in phase) if phase else 'n/a'}); "
        f"total bench time {time.time() - t_start:.0f}s")
    # secondary metrics first; the HEADLINE metric is the last line.
    # ``vs_baseline`` is against the reference's DESIGN rate (30 Hz
    # resample timer, launch:29-32 — the reference publishes no measured
    # numbers, BASELINE.md).
    def emit(metric, value, unit, design_rate=30.0):
        print(json.dumps({
            "metric": metric, "value": round(value, 2), "unit": unit,
            "vs_baseline": round(value / design_rate, 2),
            "device": device,
        }))

    emit("fused_fps_with_segmentation_tracking_8cam", map_fps, "frames/s")
    # the isolated device-step cost (min of the pre/post measurements;
    # steps chained through the donated state with ONE sync per 12)
    print(json.dumps({
        "metric": "device_step_ms_isolated",
        "value": round(min(step_ms, step_ms2), 1),
        "unit": "ms (I-keyframe step)",
        "vs_baseline": round((1e3 / max(min(step_ms, step_ms2), 1e-6))
                             / 30.0, 2),
        "device": device,
    }))
    print(json.dumps({
        "metric": "mapping_cycles_per_s",
        "value": round(cycles / dt_map, 2),
        "unit": "cycles/s",
        "vs_baseline": round(cycles / dt_map / 30.0, 2),
        "device": device,
    }))
    emit("fused_frames_per_s_per_chip_8cam_848x480_max", fps_max,
         "frames/s")
    emit("fused_frames_per_s_per_chip_8cam_848x480", fps_median,
         "frames/s")


if __name__ == "__main__":
    main()
