"""Smoke test of the fusion + mapping path on an NVIDIA GPU.

Drives the system once through the entry points a user calls
(``FusionEngine.add_depthmap`` / ``add_point_sequence`` / ``process`` /
``segment_and_track``) at the deployment size of the reference's Hafen
launch preset (``core/config.py`` PRESET_HAFEN,
launch/gpu_depthmap_fusion.launch:144-159): 6 depth streams of 848x480 u16
into a 40 x 40 x 2.5 m grid at 0.1/0.1/0.12 m (400 x 400 x 21 = 3.36M
cells), occupancy lifetime 10. Two lidar streams of 8,192 points per frame
at 30 Hz stamps, a 0.1 s aggregation window and a 98,304-point rollbuffer
are assumed on top (the preset has no lidar; the reference caps its window
near 100k points, gpu_depthmap_fusion.cpp:1271-1275).

Phases (one progress line each; any failure exits non-zero):

1. device: a GPU is required, the native host library too;
2. kernel parity at the deployment's widths against the NumPy oracles in
   ``tests/oracles.py`` (unproject + flying-pixel filter, packed voxelize);
3. the p4 depth link decoded on the card, bit-identical to the host's
   quantised reconstruction (the TF32 check);
4. the engine: 30 p4 frames + 3 mapping cycles, then 3 raw-link frames
   against the composed oracles;
5. informational: compile time, steady-state step time, memory.

The last line of stdout is one JSON object naming the device.

Run: ``python chip_smoke.py`` (one GPU), or ``python chip_smoke.py
--four-cards`` (only the sharded path on four GPUs against one card).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# --- the deployment (PRESET_HAFEN) and the assumed lidar ------------------
C, H, W = 6, 480, 848
N_LIDAR, LIDAR_PTS = 2, 8192
ROLLBUFFER_CAP = 98304
SEED = 0
N_STAGED = 8            # staged scene frames, cycled

# --- tolerances, each with its reason -------------------------------------
# Unprojected points: the device computes x = (u - cx) / fx * z in f32 and
# transforms with an f32 HIGHEST matmul; the oracle rounds an f64 product
# to f32 and transforms with an f32 numpy matmul. They differ by a few ulp.
POINT_RTOL, POINT_ATOL = 1e-5, 1e-6
# Flying-pixel masks, the filter run on the oracle's own points, match
# exactly, except where a pixel's test value (its cos(view) against the
# threshold, or its range against max_distance) lies within FP_MARGIN
# relative of the threshold: f32 on the card against f64 in the oracle
# may then decide either way. At most FP_MAX_EXCEPTIONS of all pixels may
# be such exceptions.
FP_MARGIN = 1e-6
FP_MAX_EXCEPTIONS = 1e-5
# Chained after the device's own unprojection, whose points differ from
# the oracle's by an ulp, a decision may flip where the test sits within
# FP_CHAIN_MARGIN of its threshold: neighbours ~4 mm apart at 2.5 m see an
# ulp (2.4e-7 m) as ~6e-5 of their difference, and the cross product and
# normalisation multiply that a few times. At most FP_CHAIN_SHARE of all
# pixels may flip, in this phase and in each engine-phase frame.
FP_CHAIN_MARGIN = 1e-3
FP_CHAIN_SHARE = 1e-4
# Packed voxelize quantises each point to 10/10/12 bits of its cell, so a
# cell mean may be off by at most cell/2048 per axis (core/config.py);
# reconstructing ``corner + (q + 0.5) * step`` in f32 at coordinates up to
# 20 m adds a few ulp.
MEAN_F32_SLACK = 1e-5
# Engine against composed oracles: a point within FACE_BAND of a cell face
# may fall into either neighbour (f32 rounding and FMA order on the card).
# At most OCC_MAX_DIFF of occupied cells may differ, each adjacent to a
# matching cell and holding or bordering such a point.
FACE_BAND = 1e-4
OCC_MAX_DIFF = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def progress(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# Scene: static background, fixed pattern noise, persistent holes with
# churn, a moving blob; a swaying ring of cameras; two rotating lidar arcs
# ---------------------------------------------------------------------------

def make_scene(c=C, h=H, w=W, lidar_pts=LIDAR_PTS, seed=SEED,
               n_staged=N_STAGED):
    from ros_gpu_depthmap_fusion_tpu.core import transforms
    from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    sx, sy = w / 848.0, h / 480.0
    base = (2500 + 200 * np.sin(u / (150.0 * sx))
            + 150 * np.cos(v / (120.0 * sy)))
    pattern = rng.normal(0.0, 6.0, (c, h, w))
    holes = rng.random((c, h, w)) < 0.01
    depths = []
    for k in range(n_staged):
        ang = 2 * np.pi * k / n_staged
        cx = w * 0.5 + 6.0 * sx * np.cos(ang)
        cy = h * 0.5 + 6.0 * sy * np.sin(ang)
        blob = 400 * np.exp(-(((u - cx) / (25.0 * sx)) ** 2
                              + ((v - cy) / (20.0 * sy)) ** 2))
        d = (base - blob + pattern
             + rng.standard_normal((c, h, w))).astype(np.uint16)
        d[holes | (rng.random((c, h, w)) < 0.001)] = 0
        depths.append(d)

    def cams(f):
        yaw0 = 0.02 * np.sin(2 * np.pi * f / 60.0)
        out = []
        for i in range(c):
            a = i * 2 * np.pi / c + yaw0
            pos = np.array([8 * np.cos(a), 8 * np.sin(a), 2.0])
            out.append(transforms.make_se3(
                transforms.rot_z(a + np.pi)
                @ transforms.rot_x(-np.pi / 2 - 0.3), pos))
        return out

    t = np.linspace(0, np.pi, lidar_pts)
    arcs = []
    for k in range(n_staged):
        rot = 2 * np.pi * k / n_staged
        arcs.append([
            np.stack([6 * np.cos(t + rot), 6 * np.sin(t + rot),
                      1 + 0.3 * np.sin(5 * t)], -1).astype(np.float32),
            np.stack([12 * np.cos(-t * 0.7 + rot),
                      12 * np.sin(-t * 0.7 + rot),
                      1.5 + 0 * t], -1).astype(np.float32)])
    intr = PinholeIntrinsics.default_for(w, h)
    return dict(depths=depths, cams=cams, arcs=arcs, intr=intr)


def engine_config(link, scene):
    """PRESET_HAFEN with the assumed lidar, at the scene's shapes;
    ``link`` is "p4" (the bench's link settings) or "none" (raw depth,
    lossless lidar staging)."""
    from ros_gpu_depthmap_fusion_tpu.core.config import PRESET_HAFEN
    c, h, w = scene["depths"][0].shape
    lidar_pts = len(scene["arcs"][0][0])
    cfg = PRESET_HAFEN.replace(
        num_depth_streams=c, depth_height=h, depth_width=w,
        num_point_sequences=N_LIDAR,
        point_sequence_aggregation_timespan=0.1,
        rollbuffer_point_capacity=ROLLBUFFER_CAP,
        max_points_per_sequence=N_LIDAR * lidar_pts,
        voxelize_output_capacity=65536,
        emit_raw_points=False,
        occupancy_sparse_capacity=4096)
    if link == "p4":
        cfg = cfg.replace(
            depth_link_codec="dpcm_temporal", depth_codec_p4_budget=48,
            depth_codec_hysteresis=2, depth_codec_quant_shift=4,
            depth_codec_keyframe_interval=120,
            depth_codec_max_exceptions=8192,
            lidar_link_quant_step=0.002, lidar_link_delta=True)
    else:
        cfg = cfg.replace(depth_link_codec="none")
    return cfg


def lidar_stamp(f):
    """Lidar sequences are stamped 5 ms before their frame, so no stamp
    sits on the 0.1 s window boundary."""
    return 10.0 + f / 30.0 - 0.005


def feed_frame(eng, scene, f):
    from ros_gpu_depthmap_fusion_tpu.core import timeutil
    d = scene["depths"][f % len(scene["depths"])]
    cams = scene["cams"](f)
    for i in range(d.shape[0]):
        eng.add_depthmap(i, d[i], scene["intr"], cams[i], cams[i])
    sec, nsec = timeutil.decode(timeutil.from_seconds(lidar_stamp(f)))
    for arc in scene["arcs"][f % len(scene["arcs"])]:
        eng.add_point_sequence(arc, sec=sec, nsec=nsec,
                               tf_move=np.eye(4, dtype=np.float32))
    return eng.process(10.0 + f / 30.0)


# ---------------------------------------------------------------------------
# Oracle work, split into row bands so that a process pool can share it
# ---------------------------------------------------------------------------

def _oracles():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracles
    return oracles


def camera_band_oracle(depth, intr, tf_world, tf_crop, depth_scale,
                       fp_list, r0, r1, box):
    """Rows [r0, r1) of one camera through ``unproject_oracle`` and
    ``flying_pixels_oracle`` (one mask per entry of ``fp_list``), and,
    when ``box`` is given, ``crop_oracle`` + ``voxel_coords_oracle`` on
    the first mask. The band carries a halo of the largest filter size;
    shifting cy by the band's first row keeps pixel rows global, and the
    halo keeps the oracle's border test global for the kept rows."""
    o = _oracles()
    h, w = depth.shape
    halo = max([fp[0] for fp in fp_list] + [0])
    a, b = max(0, r0 - halo), min(h, r1 + halo)
    fx, fy, cx, cy = (float(x) for x in intr)
    pc, pw, pcr, m = o.unproject_oracle(depth[a:b], fx, fy, cx, cy - a,
                                        depth_scale, tf_world, tf_crop)
    keep = slice((r0 - a) * w, (r1 - a) * w)
    masks = [o.flying_pixels_oracle(pc, m, b - a, w, *fp)[keep]
             for fp in fp_list]
    out = dict(pc=pc[keep], pw=pw[keep], pcr=pcr[keep], m=m[keep],
               fp=masks)
    if box is not None:
        m2, ids = o.points_oracle(out["pw"], out["pcr"], masks[0], *box)
        out.update(m_final=m2, ids=ids)
    return out


def run_bands(jobs, pool):
    """``jobs``: list of argument tuples for :func:`camera_band_oracle`."""
    if pool is None:
        return [camera_band_oracle(*j) for j in jobs]
    return pool.starmap(camera_band_oracle, jobs)


def band_jobs(depths, intr, tfs, depth_scale, fp_list, bands, box=None):
    h = depths.shape[1]
    edges = np.linspace(0, h, bands + 1).astype(int)
    return [(depths[i], intr, tfs[i], tfs[i], depth_scale, fp_list,
             int(edges[k]), int(edges[k + 1]), box)
            for i in range(depths.shape[0]) for k in range(bands)]


def gather_bands(results, c, key, index=None):
    parts = [r[key] if index is None else r[key][index] for r in results]
    return np.concatenate(parts).reshape((c, -1) + parts[0].shape[1:])


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

def flying_pixel_margin(pc, m, h, w, y, x, fp):
    """Smallest relative distance of pixel (y, x)'s tests to their
    thresholds (the range test and every evaluated ring test), in f64 on
    the oracle's points."""
    filter_size, thr, rot45, max_dist = fp
    p = pc.reshape(h, w, 4)[..., :3].astype(np.float64)
    mm = m.reshape(h, w)
    margins = [abs(np.linalg.norm(p[y, x]) - max_dist) / max_dist]

    def unit(v):
        n = np.linalg.norm(v)
        return v / n if n > 0 else v * 0.0

    for i in range(filter_size):
        d = i + 1
        for rot in ((False, True) if rot45 else (False,)):
            if x - d < 0 or x + d > w - 1 or y - d < 0 or y + d > h - 1:
                continue
            if rot:
                up, down, left, right = ((y - d, x - d), (y + d, x + d),
                                         (y + d, x - d), (y - d, x + d))
            else:
                up, down, left, right = ((y - d, x), (y + d, x),
                                         (y, x - d), (y, x + d))
            if not all(mm[q] for q in (up, down, left, right)):
                continue
            n = unit(np.cross(p[down] - p[up], p[right] - p[left]))
            cosv = float(np.dot(n, unit(-p[y, x])))
            margins.append(abs(cosv - thr) / abs(thr))
    return min(margins)


def compare_flying_pixels(got, ref, pc, m, h, w, fp, margin_limit,
                          share_limit):
    """Masks ``[C, H*W]`` against the oracle's, whose points are ``pc``;
    every difference must sit within ``margin_limit`` of a threshold, and
    at most ``share_limit`` of the pixels may differ. Returns (number of
    differences, largest margin)."""
    bad = np.argwhere(got != ref)
    margins = [flying_pixel_margin(pc[ci], m[ci], h, w, *divmod(int(i), w),
                                   fp) for ci, i in bad]
    worst = max(margins, default=0.0)
    check(worst <= margin_limit,
          f"flying-pixel mask (size {fp[0]}) differs with test margin "
          f"{worst:.3g} > {margin_limit}")
    check(len(bad) <= share_limit * got.size,
          f"{len(bad)} near-threshold flying-pixel differences exceed "
          f"{share_limit} of {got.size} pixels")
    return len(bad), worst


def compare_means(got_pts, got_cells, ref_pts, ref_cells, cell_size,
                  extra_tol=None, flip_tol=None):
    """Fused means against oracle means for the same cells. ``extra_tol``
    (per reference cell) widens the bound where membership may differ by
    face-ambiguous points; a cell that needs ``flip_tol`` on top (one
    flying-pixel decision flipped) is counted. Returns (worst error,
    flipped cells)."""
    check(np.array_equal(got_cells, ref_cells),
          f"occupied cell sets differ: {len(got_cells)} vs "
          f"{len(ref_cells)} cells")
    tol = np.asarray(cell_size, np.float64) / 2048.0 + MEAN_F32_SLACK
    tol = np.broadcast_to(tol, (len(ref_cells), 3))
    if extra_tol is not None:
        tol = tol + extra_tol[:, None]
    err = np.abs(got_pts[:, :3].astype(np.float64)
                 - ref_pts[:, :3].astype(np.float64))
    over = np.any(err > tol, axis=1)
    if flip_tol is not None:
        tol = np.where(over[:, None], tol + flip_tol[:, None], tol)
    worst = int(np.argmax((err / tol).max(axis=1))) if len(err) else 0
    check(np.all(err <= tol),
          f"cell mean off by {err[worst]} m (bound {tol[worst]}) at cell "
          f"{ref_cells[worst]}")
    return (float(err.max()) if len(err) else 0.0), int(over.sum())


def cells_of_points(pts, grid):
    """Cell ids of fused means (each lies strictly inside its cell)."""
    lo = np.asarray(grid.lower, np.float64)
    cs = np.asarray(grid.cell_size, np.float64)
    gs = np.asarray(grid.grid_size, np.int64)
    u = np.clip(np.floor((pts[:, :3].astype(np.float64) - lo) / cs), 0,
                gs - 1).astype(np.int64)
    return u[:, 0] + u[:, 1] * gs[0] + u[:, 2] * gs[0] * gs[1]


def face_ambiguity(world, mask, grid):
    """Per cell, how many valid oracle points lie within FACE_BAND of its
    boundary (inside or outside): the points whose cell f32 rounding on
    the card may change."""
    lo = np.asarray(grid.lower, np.float64)
    cs = np.asarray(grid.cell_size, np.float64)
    gs = np.asarray(grid.grid_size, np.int64)
    f = (world[mask, :3].astype(np.float64) - lo) / cs
    u = np.clip(np.floor(f), 0, gs - 1).astype(np.int64)
    frac = f - np.floor(f)
    step = np.where(frac * cs < FACE_BAND, -1,
                    np.where((1 - frac) * cs < FACE_BAND, 1, 0))
    near = np.any(step != 0, axis=1)
    u, step = u[near], step[near]
    counts = np.zeros(grid.num_cells, np.int64)
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                o = np.array([ox, oy, oz])
                use = np.all((o == 0) | (step != 0), axis=1)
                v = np.clip(u[use] + o * step[use], 0, gs - 1)
                np.add.at(counts, v[:, 0] + v[:, 1] * gs[0]
                          + v[:, 2] * gs[0] * gs[1], 1)
    return counts


def neighbours(cells, grid):
    gs = np.asarray(grid.grid_size, np.int64)
    x, y, z = cells % gs[0], (cells // gs[0]) % gs[1], cells // (gs[0]
                                                                * gs[1])
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx or dy or dz:
                    nx, ny, nz = x + dx, y + dy, z + dz
                    ok = ((nx >= 0) & (nx < gs[0]) & (ny >= 0)
                          & (ny < gs[1]) & (nz >= 0) & (nz < gs[2]))
                    out.append(np.where(ok, nx + ny * gs[0]
                                        + nz * gs[0] * gs[1], -1))
    return np.stack(out, axis=1)


def compare_frame(got_fresh, got_pts, ref_cells, ref_means, world, ids,
                  mask, grid, flip_budget=0):
    """One frame of the engine against the composed oracle.

    ``got_fresh``: device cells refreshed this frame; ``got_pts``: device
    fused means; ``ref_cells``/``ref_means``: oracle cells and means;
    ``world``/``ids``/``mask``: the oracle's points of the frame with their
    cell ids and final mask. Differences that no point near a cell face
    explains count as flying-pixel flips, at most ``flip_budget``.
    Returns (differing cells, worst mean error, flips)."""
    amb = face_ambiguity(world, mask, grid)
    ref_set = np.asarray(ref_cells, np.int64)
    got_fresh = np.asarray(got_fresh, np.int64)
    diff = np.setxor1d(got_fresh, ref_set)
    check(len(diff) <= OCC_MAX_DIFF * max(len(ref_set), 1),
          f"{len(diff)} of {len(ref_set)} occupied cells differ "
          f"(> {OCC_MAX_DIFF})")
    both = np.intersect1d(got_fresh, ref_set)
    flips = int(np.sum(amb[diff] == 0))
    if len(diff):
        adj = np.isin(neighbours(diff, grid), both).any(axis=1)
        check(np.all(adj), f"differing cells {diff[~adj][:5]} have no "
              f"matching neighbour")
    got_cells = cells_of_points(got_pts, grid)
    check(np.array_equal(np.sort(got_cells), np.sort(got_fresh)),
          "fused points and refreshed occupancy name different cells")
    gi = np.isin(got_cells, both)
    ri = np.isin(ref_set, both)
    order = np.argsort(got_cells[gi])
    # a cell whose membership may differ by a points out of n moves its
    # mean by at most a * (cell diagonal + 2 band) / (n - a); a flipped
    # flying-pixel decision adds one more point
    a = amb[ref_set[ri]].astype(np.float64)
    n = np.bincount(ids[mask], minlength=grid.num_cells)[ref_set[ri]]
    diag = float(np.linalg.norm(grid.cell_size)) + 2 * FACE_BAND
    extra = np.where(a > 0, a * diag / np.maximum(n - a, 1), 0.0)
    worst, mean_flips = compare_means(
        got_pts[gi][order], got_cells[gi][order], ref_means[ri],
        ref_set[ri], grid.cell_size, extra,
        diag / np.maximum(n - a - 1, 1))
    flips += mean_flips
    check(flips <= flip_budget,
          f"{flips} cells differ in a way no cell face explains "
          f"(flying-pixel flip budget {flip_budget})")
    return len(diff), worst, flips


# ---------------------------------------------------------------------------
# Lidar oracle: the staged batch through the sequence filter, then the
# aggregation window, in NumPy
# ---------------------------------------------------------------------------

def lidar_oracle(scene, cfg, frame, box):
    """World points, mask and cell ids of the rollbuffer selection at
    ``frame`` (sequences stamped inside [now - timespan, now])."""
    o = _oracles()
    now = 10.0 + frame / 30.0
    pts, masks = [], []
    for f in range(frame + 1):
        if not (now - cfg.point_sequence_aggregation_timespan
                <= lidar_stamp(f) <= now):
            continue
        batch = np.concatenate(scene["arcs"][f % len(scene["arcs"])])
        hom = np.concatenate([batch, np.ones((len(batch), 1),
                                             np.float32)], axis=1)
        pts.append(hom)
        masks.append(o.sequence_filter_oracle(
            hom, np.ones(len(hom), bool), len(hom),
            cfg.point_sequence_filter_size,
            cfg.point_sequence_filter_threshold))
    world = np.concatenate(pts)     # move frame == world frame here
    m, ids = o.points_oracle(world, world, np.concatenate(masks), *box)
    return world, m, ids


def config_box(cfg):
    return (cfg.crop_min, cfg.crop_max, cfg.voxel_min, cfg.voxel_max,
            cfg.voxel_size)


def fp_params(cfg, filter_size=None):
    return (filter_size or cfg.flyingpixels_filter_size,
            cfg.flyingpixels_filter_threshold,
            cfg.flyingpixels_filter_enable_rot45,
            cfg.flyingpixels_max_distance)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(four_cards):
    import jax
    if jax.default_backend() != "gpu":
        raise SmokeFailure(f"no GPU: JAX's default backend is "
                           f"{jax.default_backend()!r}")
    devs = jax.devices()
    want = 4 if four_cards else 1
    check(len(devs) >= want, f"need {want} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    progress("device", f"platform={devs[0].platform} "
             f"kind={devs[0].device_kind} count={len(devs)}")
    print(smi, flush=True)
    from ros_gpu_depthmap_fusion_tpu.utils import native
    check(native.available(), "native host library did not build/load")
    return devs


def phase_kernels(scene, pool):
    """Unproject + flying pixels (sizes 1 and 2, rot45) and packed
    voxelize on the first frame, against the oracles."""
    import jax
    import jax.numpy as jnp
    from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
    from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import crop_points
    from ros_gpu_depthmap_fusion_tpu.ops import flying_pixels, stencil
    from ros_gpu_depthmap_fusion_tpu.ops.unproject import (
        unproject_depthmaps)
    from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
        voxelize_average_packed)
    cfg = engine_config("none", scene)
    grid = VoxelGrid.from_config(cfg)
    depth = scene["depths"][0]
    c, h, w = depth.shape
    tfs = np.stack(scene["cams"](0))
    intr = scene["intr"].as_array()
    fps = [fp_params(cfg, 1), fp_params(cfg, 2)]

    unproj = jax.jit(unproject_depthmaps, static_argnums=(4,))
    pc, pw, pcr, m = unproj(jnp.asarray(depth),
                            jnp.asarray(np.tile(intr, (c, 1))),
                            jnp.asarray(tfs), jnp.asarray(tfs),
                            cfg.depth_scale)
    # the engine's filter (the Triton kernel on the card) and the jnp
    # reference, same arithmetic: equal bit for bit on the same points
    fp_fn = jax.jit(flying_pixels.filter_flying_pixels,
                    static_argnums=(2, 3, 4, 6))
    ref_fn = jax.jit(stencil.filter_flying_pixels,
                     static_argnums=(2, 3, 4, 6))
    chain = [np.asarray(fp_fn(pc, m, h, w, fs, thr, rot, md))
             for fs, thr, rot, md in fps]
    for (fs, thr, rot, md), got in zip(fps, chain):
        n = int((got != np.asarray(ref_fn(pc, m, h, w, fs, thr, rot,
                                          md))).sum())
        check(n == 0, f"flying-pixel kernel (size {fs}) differs from the "
              f"jnp reference at {n} pixels")

    res = run_bands(band_jobs(depth, intr, tfs, cfg.depth_scale, fps,
                              bands=4), pool)
    o_pc = gather_bands(res, c, "pc")
    for key, dev in (("pc", pc), ("pw", pw), ("pcr", pcr)):
        ref = gather_bands(res, c, key)
        check(np.allclose(np.asarray(dev), ref, rtol=POINT_RTOL,
                          atol=POINT_ATOL),
              f"unprojected {key} points differ beyond rtol {POINT_RTOL}")
    o_m = gather_bands(res, c, "m")
    check(np.array_equal(np.asarray(m), o_m), "unproject mask differs")
    same, chained = [], []
    for i, (fs, thr, rot, md) in enumerate(fps):
        ref = gather_bands(res, c, "fp", i)
        got = np.asarray(fp_fn(jnp.asarray(o_pc), jnp.asarray(o_m), h, w,
                               fs, thr, rot, md))
        same.append(compare_flying_pixels(got, ref, o_pc, o_m, h, w, fps[i],
                                          FP_MARGIN, FP_MAX_EXCEPTIONS))
        chained.append(compare_flying_pixels(
            chain[i], ref, o_pc, o_m, h, w, fps[i], FP_CHAIN_MARGIN,
            FP_CHAIN_SHARE))
    progress("kernels", f"unproject + flying pixels on {c}x{h}x{w}: kernel "
             f"equal to the jnp reference; points "
             f"within rtol {POINT_RTOL}; on the oracle's points masks equal "
             f"except (count, worst margin) size1={same[0]} size2={same[1]}; "
             f"chained from the device's points size1={chained[0]} "
             f"size2={chained[1]} (limits {FP_MAX_EXCEPTIONS * m.size:.0f} / "
             f"{FP_CHAIN_SHARE * m.size:.0f} pixels)")

    # packed voxelize on the device's own points and cell ids
    mask = crop_points(pcr.reshape(-1, 4), jnp.asarray(chain[0]).reshape(-1),
                       cfg.crop_min, cfg.crop_max)
    pts = pw.reshape(-1, 4)
    ids = grid.cell_index_clamped(pts[:, :3])
    cap = cfg.voxelize_output_capacity
    vox = jax.jit(voxelize_average_packed, static_argnums=(3, 4))
    out, count = vox(pts, ids, mask, grid, cap)
    count = int(count)
    check(count < cap, f"voxelize output capacity {cap} overflowed")
    ref_means, ref_cells = _oracles().voxelize_average_oracle(
        np.asarray(pts), np.asarray(ids), np.asarray(mask))
    worst, _ = compare_means(np.asarray(out)[:count],
                             cells_of_points(np.asarray(out)[:count], grid),
                             ref_means, ref_cells, grid.cell_size)
    times = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(10):
            r = vox(pts, ids, mask, grid, cap)
        jax.block_until_ready(r)
        times.append((time.perf_counter() - t) / 10 * 1e3)
    progress("kernels", f"packed voxelize of {pts.shape[0]} rows: "
             f"{count} cells equal to the oracle's, worst mean error "
             f"{worst:.3g} m (bound cell/2048 + {MEAN_F32_SLACK}); "
             f"{min(times):.3f} ms per call")


def phase_link(scene):
    """One I-frame and 11 p4 P-frames decoded on the card against the host
    encoder's quantised series."""
    import jax
    from ros_gpu_depthmap_fusion_tpu.ops import depth_codec as DC
    from ros_gpu_depthmap_fusion_tpu.utils import native
    cfg = engine_config("p4", scene)
    qs, budget = cfg.depth_codec_quant_shift, cfg.depth_codec_p4_budget
    cap = cfg.depth_codec_max_exceptions
    c, h, w = scene["depths"][0].shape
    dec_i = jax.jit(DC.decode_depth, static_argnums=(1, 2, 3, 4, 5))
    dec_p = jax.jit(DC.decode_depth_p4, static_argnums=(2, 3, 4, 5))

    d0 = scene["depths"][0]
    enc, bits = native.depth_encode(d0, cap, quant_shift=qs)
    e = DC.EncodedDepth(enc["words"], enc["row_first"],
                        enc["exc_idx"].astype(np.int32),
                        enc["exc_zz"].astype(np.int32), enc["exc_count"])
    depth, prev_q = dec_i(e, h, w, bits, qs, True)
    host_q = DC.quantize_reference(d0, qs)
    check(np.array_equal(np.asarray(prev_q), host_q),
          "I-frame series differs from the host quantisation")
    check(np.array_equal(np.asarray(depth),
                         (host_q.astype(np.uint32) << qs).astype(np.uint16)),
          "I-frame depth differs from the host reconstruction")
    spilled = lits = 0
    for k in range(1, 12):
        d = scene["depths"][k % len(scene["depths"])]
        res = native.depth_encode_p4(d, host_q, budget, cap,
                                     quant_shift=qs,
                                     hysteresis=cfg.depth_codec_hysteresis)
        check(res is not None, f"p4 encode of frame {k} overflowed")
        enc, curr_q = res
        spilled += enc["spilled"]
        lits += enc["lit_total"]
        e = DC.EncodedDepthP4(
            enc["flags"].astype(np.int32),
            enc["lits"].reshape(c * h, budget).view("<u4").astype(np.int32),
            enc["exc_idx"].astype(np.int32), enc["exc_zz"].astype(np.int32),
            enc["exc_count"])
        depth, prev_q = dec_p(e, prev_q, h, w, budget, qs)
        check(np.array_equal(np.asarray(prev_q), curr_q),
              f"p4 P-frame {k} series differs from the host's")
        check(np.array_equal(
            np.asarray(depth),
            (curr_q.astype(np.uint32) << qs).astype(np.uint16)),
            f"p4 P-frame {k} depth differs from the host's")
        host_q = curr_q.copy()
    progress("link", f"I-frame (B={bits}) + 11 p4 P-frames decoded "
             f"bit-identical on the card (literal groups {lits}, spilled "
             f"groups {spilled})")


def phase_engine(scene, pool):
    """30 p4 frames + 3 mapping cycles, then 3 raw-link frames against the
    composed oracles."""
    import jax
    from ros_gpu_depthmap_fusion_tpu.pipeline.engine import FusionEngine
    cfg = engine_config("p4", scene)
    eng = FusionEngine(cfg, enable_mapping=True)
    cap = min(eng.grid.num_cells, cfg.total_point_capacity,
              cfg.voxelize_output_capacity)
    t0 = time.perf_counter()
    out = feed_frame(eng, scene, 0)
    jax.block_until_ready(out)
    compile_s = [time.perf_counter() - t0]
    kinds = [eng.last_frame_bits]
    for f in range(1, 30):
        t0 = time.perf_counter()
        out = feed_frame(eng, scene, f)
        jax.block_until_ready(out)
        if f == 1:
            compile_s.append(time.perf_counter() - t0)
        kinds.append(eng.last_frame_bits)
        fused = int(out.fused_count)
        sel = int(out.seq_selected_count)
        sparse = int(out.occupancy_sparse_true)
        check(fused < cap, f"frame {f}: fused_count {fused} hit cap {cap}")
        check(0 < sel < cfg.rollbuffer_point_capacity,
              f"frame {f}: rollbuffer selection {sel} outside (0, "
              f"{cfg.rollbuffer_point_capacity})")
        check(sparse <= cfg.occupancy_sparse_capacity,
              f"frame {f}: sparse occupancy {sparse} over its cap")
    n_p4 = sum(k == "p4" for k in kinds)
    check(n_p4 > 0, f"p4 P-frames never engaged: {kinds}")
    progress("engine", f"30 p4-link frames: {n_p4} P-frames, fused "
             f"{fused}/{cap} cells, selection {sel}/"
             f"{cfg.rollbuffer_point_capacity} points, sparse blocks "
             f"{sparse}/{cfg.occupancy_sparse_capacity}")
    for f in range(30, 33):
        out = feed_frame(eng, scene, f)
        jax.block_until_ready(out)
        res = eng.segment_and_track(out)
        check(len(res.objects) > 0, f"mapping cycle at frame {f} found no "
              f"objects")
    progress("engine", f"3 mapping cycles on backend "
             f"{eng.mapping.backend!r}: {len(res.objects)} objects, "
             f"{len(res.tracks)} tracks")
    diffs, worst, flips = raw_link_check(scene, pool)
    progress("engine", f"3 raw-link frames against the composed oracles: "
             f"{diffs} differing occupied cells (limit {OCC_MAX_DIFF} of "
             f"occupied), {flips} flying-pixel flips, worst mean error "
             f"{worst:.3g} m")
    return eng, compile_s


def raw_link_check(scene, pool, frames=3, cfg=None, perturb_cell=None):
    """The raw-link engine against unproject -> flying pixels -> crop ->
    voxel coords -> voxelize average -> occupancy update in NumPy, with
    the lidar selection transformed and windowed in NumPy.
    ``perturb_cell`` flips one cell of the device's first frame (a check
    of this check)."""
    from ros_gpu_depthmap_fusion_tpu.pipeline.engine import FusionEngine
    cfg = cfg or engine_config("none", scene)
    eng = FusionEngine(cfg)
    grid = eng.grid
    life = cfg.voxel_occupancy_lifetime
    c, h, w = scene["depths"][0].shape
    box = config_box(cfg)
    bands = 2
    jobs = []
    for f in range(frames):
        jobs += band_jobs(scene["depths"][f % len(scene["depths"])],
                          scene["intr"].as_array(), np.stack(scene["cams"](f)),
                          cfg.depth_scale, [fp_params(cfg)], bands, box)
    res = run_bands(jobs, pool)
    per = len(jobs) // frames
    historic = np.zeros(grid.num_cells, np.int64)
    diffs, worst, flips, touched = 0, 0.0, 0, np.zeros(0, np.int64)
    flip_budget = int(FP_CHAIN_SHARE * c * h * w)
    for f in range(frames):
        out = feed_frame(eng, scene, f)
        occ = np.asarray(out.occupancy_u8).astype(np.int64)
        pts = np.asarray(out.fused_points)[: int(out.fused_count)]
        check(int(out.fused_count) < out.fused_points.shape[0],
              f"frame {f}: fused output capacity overflowed")
        fresh = np.flatnonzero(occ == life)
        if perturb_cell is not None and f == 0:
            fresh = np.setxor1d(fresh, [perturb_cell])
            occ[perturb_cell] = life - occ[perturb_cell]
        r = res[f * per:(f + 1) * per]
        lw, lm, lids = lidar_oracle(scene, cfg, f, box)
        world = np.concatenate([x["pw"] for x in r] + [lw])
        mask = np.concatenate([x["m_final"] for x in r] + [lm])
        ids = np.concatenate([x["ids"] for x in r] + [lids])
        means, cells, historic = _oracles().fuse_cells_oracle(
            world, ids, mask, grid.num_cells, historic, life)
        d, wst, fl = compare_frame(fresh, pts, cells, means, world, ids,
                                   mask, grid, flip_budget)
        flips += fl
        touched = np.union1d(touched, np.setxor1d(fresh, cells))
        diffs, worst = diffs + d, max(worst, wst)
        bad = np.flatnonzero(occ != historic)
        check(np.all(np.isin(bad, touched)),
              f"frame {f}: historic occupancy differs at cells "
              f"{bad[~np.isin(bad, touched)][:5]} that no frame "
              f"explains")
    return diffs, worst, flips


def phase_info(eng, scene, compile_s):
    """Compile time, steady-state step time, memory (informational)."""
    import jax
    d = scene["depths"][0]
    cams = scene["cams"](0)
    for i in range(d.shape[0]):
        eng.add_depthmap(i, d[i], scene["intr"], cams[i], cams[i])
    eng._frames_since_key = 10 ** 9          # force an I-frame encode
    view, bits = eng._encode(eng._pkt, eng._depth_host, (
        11, 0, 10, 900000000, 0, 0, eng.fp_threshold, eng.fp_max_distance,
        eng.ps_threshold))
    dev = jax.device_put(np.array(view))
    st = eng.state
    compiled = eng.step.lower(st, dev, depth_bits=bits).compile()
    mem = compiled.memory_analysis()
    st, o = eng.step(st, dev, depth_bits=bits)
    jax.block_until_ready(o)
    reps, times = 20, []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(reps):
            st, o = eng.step(st, dev, depth_bits=bits)
        jax.block_until_ready(o)
        times.append((time.perf_counter() - t) / reps * 1e3)
    eng.state = st
    stats = jax.devices()[0].memory_stats() or {}
    progress("info", f"first frame (compile + run) {compile_s[0]:.1f} s, "
             f"first p4 frame {compile_s[1]:.1f} s")
    progress("info", f"steady-state step (I-frame, {reps} steps chained "
             f"through donated state, one sync): {min(times):.3f} ms")
    progress("info", f"memory_analysis: temp={mem.temp_size_in_bytes} "
             f"argument={mem.argument_size_in_bytes} "
             f"output={mem.output_size_in_bytes} bytes; peak_bytes_in_use="
             f"{stats.get('peak_bytes_in_use')}")


def phase_four_cards(h=H, w=W):
    """ShardedFusionEngine on meshes (stream 4, space 1) and (2, 2) against
    a single-card FusionEngine: 8 x 848x480 into 3.36M cells, exact."""
    import jax
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.parallel import make_mesh
    from ros_gpu_depthmap_fusion_tpu.parallel.engine import (
        ShardedFusionEngine)
    from ros_gpu_depthmap_fusion_tpu.pipeline.engine import FusionEngine
    cfg = FusionConfig(
        num_depth_streams=8, depth_height=h, depth_width=w,
        num_point_sequences=2,
        crop_min=(-20, -20, 0), crop_max=(20, 20, 2.5),
        voxel_min=(-20, -20, 0), voxel_max=(20, 20, 2.5),
        voxel_size=(0.1, 0.1, 0.12), voxel_occupancy_lifetime=10,
        rollbuffer_point_capacity=ROLLBUFFER_CAP,
        rollbuffer_seq_capacity=1024, max_points_per_sequence=16384,
        voxel_mean_mode="packed", emit_raw_points=False)
    scene = make_scene(c=8, h=h, w=w)
    frames = 2
    single = FusionEngine(cfg)
    ref = [feed_frame(single, scene, f) for f in range(frames)][-1]
    occ1 = np.asarray(ref.occupancy_u8)
    fused1 = np.asarray(ref.fused_points)[: int(ref.fused_count)]
    set1 = set(map(tuple, np.round(fused1, 5).tolist()))
    for ns, nsp in ((4, 1), (2, 2)):
        mesh = make_mesh(num_stream=ns, num_space=nsp,
                         devices=jax.devices()[:4])
        sh = ShardedFusionEngine(cfg, mesh)
        out = [feed_frame(sh, scene, f) for f in range(frames)][-1]
        occ = sh.occupancy_host(out)
        check(np.array_equal(occ, occ1),
              f"mesh {dict(mesh.shape)}: occupancy differs at "
              f"{int((occ != occ1).sum())} cells")
        fused = sh.fused_points_host(out)
        s = set(map(tuple, np.round(fused, 5).tolist()))
        check(fused.shape == fused1.shape and s == set1,
              f"mesh {dict(mesh.shape)}: fused sets differ "
              f"({len(s)} vs {len(set1)})")
        progress("four-cards", f"mesh {dict(mesh.shape)}: occupancy "
                 f"({int((occ > 0).sum())} cells) and fused set "
                 f"({len(s)} points) equal the single card exactly")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs against "
                         "one card")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    devs = phase_device(args.four_cards)
    if args.four_cards:
        phase_four_cards()
    else:
        progress("deployment", f"PRESET_HAFEN: {C} x {W}x{H} u16 depth, "
                 f"grid 400x400x21 at 0.1/0.1/0.12 m, lifetime 10; "
                 f"assumed (the preset has no lidar): {N_LIDAR} lidar "
                 f"streams x {LIDAR_PTS} points at 30 Hz, 0.1 s window, "
                 f"rollbuffer {ROLLBUFFER_CAP}")
        scene = make_scene()
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(os.cpu_count()) as pool:
            phase_kernels(scene, pool)
            phase_link(scene)
            eng, compile_s = phase_engine(scene, pool)
        phase_info(eng, scene, compile_s)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
