"""Validity-mask stencil filters.

Device equivalents of the two neighborhood filters:

- :func:`filter_flying_pixels` — ``shader/filter_flying_pixels.glsl``: per
  depth pixel, estimate the local surface normal from ring neighbors and
  reject grazing-angle ("flying") pixels.
- :func:`filter_point_sequence` — ``shader/filter_point_sequence.glsl``:
  along a 1-D lidar scan, reject points whose neighbor direction is nearly
  parallel to the view ray.

Both are expressed as dense vectorized stencils over the full image / scan
(static shapes, shifts via ``jnp.roll`` + explicit border masks) so XLA fuses
them with the surrounding pipeline; there is no per-point control flow.

Border semantics note: the reference indexes a flat buffer with unsigned
arithmetic, so its left/top border checks silently wrap to the previous row
(``filter_flying_pixels.glsl:60`` — ``pixel.x-du < 0`` is always false for
uints). Here pixels within the ring radius of *any* image border are
rejected, which matches the reference's right/bottom behavior and replaces
the wraparound artifact on the left/top with the obviously intended check.
"""

from __future__ import annotations

import jax.numpy as jnp


def _shift2d(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift ``[..., H, W]`` or ``[..., H, W, F]`` content by (dy, dx); the
    values rolled across the border are unused because border pixels are
    masked off separately."""
    h_axis = 1
    w_axis = 2
    return jnp.roll(a, shift=(-dy, -dx), axis=(h_axis, w_axis))


def filter_flying_pixels(points_cam: jnp.ndarray,
                         mask: jnp.ndarray,
                         height: int,
                         width: int,
                         filter_size: int,
                         threshold: float,
                         enable_rot45: bool,
                         max_distance: float = 10.0) -> jnp.ndarray:
    """Flying-pixel rejection on camera-frame points.

    Args:
        points_cam: ``[C, H*W, 4]`` camera-frame points.
        mask:       ``[C, H*W]`` bool input validity.
        filter_size: number of rings (neighbor offsets 1..filter_size).
        threshold:  minimum cos(view angle) (glsl:86).
        enable_rot45: also test the 45-degree-rotated neighborhood
            (glsl:91-125).
        max_distance: range gate on |p| (glsl:143).

    Returns:
        ``[C, H*W]`` bool output mask.
    """
    c = points_cam.shape[0]
    p = points_cam.reshape(c, height, width, 4)[..., :3]
    m = mask.reshape(c, height, width)

    # range gate
    dist2 = jnp.sum(p * p, axis=-1)
    out = m & (dist2 <= max_distance * max_distance)

    yy = jnp.arange(height, dtype=jnp.int32)[None, :, None]
    xx = jnp.arange(width, dtype=jnp.int32)[None, None, :]

    view = -p  # vector from point to camera at origin
    view_n = view / jnp.maximum(
        jnp.linalg.norm(view, axis=-1, keepdims=True), 1e-30)

    def ring_check(du: int, dv: int, rot45: bool) -> jnp.ndarray:
        """True where the pixel survives this ring's test."""
        if not rot45:
            offs = {
                "up": (-dv, 0), "down": (dv, 0),
                "left": (0, -du), "right": (0, du),
            }
            in_b = ((xx - du >= 0) & (xx + du <= width - 1) &
                    (yy - dv >= 0) & (yy + dv <= height - 1))
        else:
            # rotated neighborhood (glsl:105-109): up/down on the main
            # diagonal, left/right on the anti-diagonal
            offs = {
                "up": (-dv, -du), "down": (dv, du),
                "left": (dv, -du), "right": (-dv, du),
            }
            in_b = ((xx - du >= 0) & (xx + du <= width - 1) &
                    (yy - dv >= 0) & (yy + dv <= height - 1))

        neigh_ok = in_b
        shifted = {}
        for name, (dy, dx) in offs.items():
            neigh_ok = neigh_ok & _shift2d(m, dy, dx)
            shifted[name] = _shift2d(p, dy, dx)
        neigh_ok = neigh_ok & m  # center must be valid too (glsl:63)

        dx_vec = shifted["right"] - shifted["left"]
        dy_vec = shifted["down"] - shifted["up"]
        normal = jnp.cross(dy_vec, dx_vec)
        normal = normal / jnp.maximum(
            jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-30)
        cos_view = jnp.sum(normal * view_n, axis=-1)
        return neigh_ok & (cos_view >= threshold)

    for i in range(filter_size):
        d = i + 1
        out = out & ring_check(d, d, rot45=False)
        if enable_rot45:
            out = out & ring_check(d, d, rot45=True)

    return out.reshape(c, height * width)


def filter_point_sequence(points: jnp.ndarray,
                          mask: jnp.ndarray,
                          valid_count: jnp.ndarray,
                          filter_size: int,
                          threshold: float) -> jnp.ndarray:
    """1-D scan-order flying-point filter.

    Semantics of ``filter_point_sequence.glsl:96-116``: for point i, test
    neighbor offsets ``{-1, .., filter_size-2} U {1, .., filter_size}``
    (the self-offset 0 appearing for filter_size > 1 is a NaN-compare no-op
    in the reference and is skipped here); a point is rejected when
    ``1 - |cos(dir_to_neighbor, view_ray)| < threshold`` for any in-range
    neighbor, or when ``|p| < 1e-3`` (glsl:92).

    Args:
        points:      ``[N, 4]`` points in the sensor frame (sensor at origin).
        mask:        ``[N]`` bool input validity.
        valid_count: scalar int — number of live items (ring padding beyond
            this never counts as a neighbor; matches ``num_items`` bounds).
        filter_size: neighbor span.
        threshold:   rejection threshold on ``1 - |cos|``.

    Returns:
        ``[N]`` bool output mask.
    """
    n = points.shape[0]
    p = points[:, :3]
    idx = jnp.arange(n, dtype=jnp.int32)
    in_range = idx < valid_count

    norm_p = jnp.linalg.norm(p, axis=-1)
    out = mask & in_range & (norm_p >= 1e-3)
    view_n = -p / jnp.maximum(norm_p[:, None], 1e-30)

    offsets = sorted(set(range(-1, filter_size - 1)) |
                     set(range(1, filter_size + 1)))
    for d in offsets:
        if d == 0:
            continue  # reference self-compare is a NaN no-op
        neigh = jnp.roll(p, -d, axis=0)
        neigh_valid = (idx + d >= 0) & (idx + d < valid_count)
        direction = neigh - p
        dir_n = direction / jnp.maximum(
            jnp.linalg.norm(direction, axis=-1, keepdims=True), 1e-30)
        cos_between = jnp.abs(jnp.sum(dir_n * view_n, axis=-1))
        reject = neigh_valid & (1.0 - cos_between < threshold)
        out = out & ~reject

    return out
