"""NumPy golden implementations of the reference GLSL kernel semantics.

These follow the shader code paths literally (scalar loops, same branch
structure) so the vectorized device ops can be validated against them. Each
function cites the shader it mirrors. They are test-only and intentionally
slow.
"""

from __future__ import annotations

import numpy as np


def unproject_oracle(depth_u16: np.ndarray, fx, fy, cx, cy, depth_scale,
                     tf_world: np.ndarray, tf_crop: np.ndarray):
    """shader/convert_depthmap_to_points.glsl:64-119 for one camera."""
    h, w = depth_u16.shape
    n = h * w
    pts_cam = np.zeros((n, 4), np.float32)
    pts_world = np.zeros((n, 4), np.float32)
    pts_crop = np.zeros((n, 4), np.float32)
    mask = np.zeros((n,), bool)
    for idx in range(n):
        u = idx % w
        v = idx // w
        depth = int(depth_u16[v, u])
        if depth == 0:
            continue
        z = depth * depth_scale
        x = (u - cx) / fx
        y = (v - cy) / fy
        p = np.array([x * z, y * z, z, 1.0], np.float32)
        mask[idx] = True
        pts_cam[idx] = p
        pts_world[idx] = tf_world @ p   # effective math of `point * mat`
        pts_crop[idx] = tf_crop @ p
    return pts_cam, pts_world, pts_crop, mask


def flying_pixels_oracle(points_cam: np.ndarray, mask: np.ndarray,
                         h: int, w: int, filter_size: int, threshold: float,
                         enable_rot45: bool, max_distance: float = 10.0):
    """shader/filter_flying_pixels.glsl with clean border semantics (pixels
    within the ring radius of any border are rejected — see ops/stencil.py
    border note)."""
    p = points_cam.reshape(h, w, 4)[..., :3].astype(np.float64)
    m = mask.reshape(h, w)
    out = m.copy()

    def normalize(v):
        n = np.linalg.norm(v)
        return v / n if n > 0 else v * 0.0

    def check(y, x, du, dv, rot45):
        if x - du < 0 or x + du > w - 1 or y - dv < 0 or y + dv > h - 1:
            return False
        if rot45:
            up = (y - dv, x - du)
            down = (y + dv, x + du)
            left = (y + dv, x - du)
            right = (y - dv, x + du)
        else:
            up = (y - dv, x)
            down = (y + dv, x)
            left = (y, x - du)
            right = (y, x + du)
        for (yy, xx) in (up, down, left, right):
            if not m[yy, xx]:
                return False
        dx = p[right] - p[left]
        dy = p[down] - p[up]
        normal = normalize(np.cross(dy, dx))
        cosv = float(np.dot(normal, normalize(-p[y, x])))
        return cosv >= threshold

    for y in range(h):
        for x in range(w):
            if not m[y, x]:
                out[y, x] = False
                continue
            if np.linalg.norm(p[y, x]) > max_distance:
                out[y, x] = False
                continue
            ok = True
            for i in range(filter_size):
                d = i + 1
                ok = ok and check(y, x, d, d, rot45=False)
                if enable_rot45:
                    ok = ok and check(y, x, d, d, rot45=True)
            out[y, x] = ok
    return out.reshape(-1)


def sequence_filter_oracle(points: np.ndarray, mask: np.ndarray,
                           valid_count: int, filter_size: int,
                           threshold: float):
    """shader/filter_point_sequence.glsl:86-121 (offset 0 self-compare is a
    NaN no-op there and skipped here)."""
    n = points.shape[0]
    out = np.zeros((n,), bool)
    offsets = sorted((set(range(-1, filter_size - 1)) |
                      set(range(1, filter_size + 1))) - {0})
    for i in range(n):
        if i >= valid_count or not mask[i]:
            continue
        pt = points[i, :3].astype(np.float64)
        if np.linalg.norm(pt) < 1e-3:
            continue
        view = -pt / max(np.linalg.norm(pt), 1e-30)
        invalid = False
        for d in offsets:
            j = i + d
            if j < 0 or j >= valid_count:
                continue
            direction = points[j, :3].astype(np.float64) - pt
            nd = np.linalg.norm(direction)
            if nd > 0:
                direction = direction / nd
            cosb = abs(float(np.dot(direction, view)))
            if 1.0 - cosb < threshold:
                invalid = True
        out[i] = not invalid
    return out


def crop_oracle(points: np.ndarray, mask: np.ndarray, lower, upper):
    """shader/crop_points.glsl:47-66."""
    out = mask.copy()
    for i in range(points.shape[0]):
        if not mask[i]:
            continue
        p = points[i]
        for k in range(3):
            if p[k] < lower[k] or p[k] > upper[k]:
                out[i] = False
    return out


def voxel_coords_oracle(points: np.ndarray, lower, upper, cell_size):
    """shader/compute_voxel_coords.glsl:43-54 (+ the grid-size derivation at
    gpu_depthmap_fusion.cpp:1693-1697)."""
    lower = np.asarray(lower, np.float32)
    upper = np.asarray(upper, np.float32)
    cell = np.asarray(cell_size, np.float32)
    gsize = np.ceil((upper - lower) / cell).astype(np.int64)
    gsize = np.maximum(gsize, 1)
    out = np.zeros((points.shape[0],), np.int64)
    for i in range(points.shape[0]):
        p = points[i, :3]
        f = np.clip((p - lower) / cell, 0, gsize - 1)
        u = np.floor(f).astype(np.int64)
        out[i] = u[0] + u[1] * gsize[0] + u[2] * gsize[0] * gsize[1]
    return out, gsize


def voxelize_average_oracle(points: np.ndarray, cell_ids: np.ndarray,
                            mask: np.ndarray):
    """voxelize.h averageGridCells: per occupied cell (ascending cell id),
    the mean of member points."""
    order = {}
    for i in range(points.shape[0]):
        if not mask[i]:
            continue
        order.setdefault(int(cell_ids[i]), []).append(i)
    cells = sorted(order)
    out = np.zeros((len(cells), 4), np.float32)
    for k, c in enumerate(cells):
        out[k] = np.mean(points[order[c]].astype(np.float64), axis=0)
    return out, np.array(cells, np.int64)


def occupancy_update_oracle(historic: np.ndarray, fresh: np.ndarray,
                            lifetime: int):
    """decrement_uints (saturating -1 at 0) then max with fresh*lifetime
    (gpu_depthmap_fusion.cpp:1796-1812)."""
    aged = np.maximum(historic.astype(np.int64) - 1, 0)
    return np.maximum(aged, fresh.astype(np.int64) * lifetime)


# ---------------------------------------------------------------------------
# Composed frame oracle: unproject -> flying pixels -> crop -> voxel coords
# -> voxelize average -> occupancy update, built only from the functions
# above (per-camera unproject/filter calls stay with the caller, which may
# run cameras in parallel processes).
# ---------------------------------------------------------------------------

def points_oracle(world, crop, mask, crop_min, crop_max, voxel_min,
                  voxel_max, voxel_size):
    """Crop + voxel coords for points already in the world and crop
    frames. Returns (mask, cell ids)."""
    m = crop_oracle(crop, mask, crop_min, crop_max)
    ids, _ = voxel_coords_oracle(world, voxel_min, voxel_max, voxel_size)
    return m, ids


def fuse_cells_oracle(world, cell_ids, mask, num_cells, historic, lifetime):
    """Voxelize average over all sections, then the occupancy update.
    Returns (means ``[K, 4]``, cells ``[K]`` ascending, new historic)."""
    means, cells = voxelize_average_oracle(world, cell_ids, mask)
    fresh = np.zeros(num_cells, np.int64)
    fresh[cells] = 1
    return means, cells, occupancy_update_oracle(historic, fresh, lifetime)
