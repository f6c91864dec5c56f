"""ORB-style feature detection, description and matching on device.

No reference analog (the reference fuses with externally-supplied poses);
this implements the north-star SLAM frontend: FAST corners with
non-maximum suppression and fixed-K top-k selection (static shapes),
intensity-centroid orientation, steered-BRIEF 256-bit descriptors, and
Hamming matching via ``lax.population_count`` — everything vectorized jnp
inside one jit, no data-dependent shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# 16-point Bresenham circle of radius 3 (FAST), clockwise from 12 o'clock
FAST_RING = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

BRIEF_PATCH = 15  # half size of the 31x31 descriptor patch


def _brief_pairs(n_bits: int = 256, seed: int = 7) -> np.ndarray:
    """[n_bits, 4] (x1, y1, x2, y2) gaussian test pairs in the patch."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0.0, BRIEF_PATCH / 2.5, size=(n_bits, 4)),
                  -BRIEF_PATCH, BRIEF_PATCH)
    return pts.astype(np.float32)


BRIEF = _brief_pairs()


class Keypoints(NamedTuple):
    xy: jnp.ndarray       # [K, 2] float (x, y)
    score: jnp.ndarray    # [K]
    angle: jnp.ndarray    # [K] radians
    valid: jnp.ndarray    # [K] bool
    desc: jnp.ndarray     # [K, 8] uint32 (256-bit BRIEF)


def _ring_values(img: jnp.ndarray) -> jnp.ndarray:
    """[16, H, W] ring samples around each pixel (border wraps; masked by
    the caller's border margin)."""
    return jnp.stack([
        jnp.roll(img, shift=(-int(dy), -int(dx)), axis=(0, 1))
        for dx, dy in FAST_RING], axis=0)


def fast_scores(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9 corner response per pixel: 0 where not a corner, else the
    sum-of-absolute-differences score (vectorized over the image)."""
    ring = _ring_values(img.astype(jnp.float32))         # [16, H, W]
    center = img.astype(jnp.float32)[None]
    brighter = ring > center + threshold
    darker = ring < center - threshold

    def max_run(b):
        # longest circular run of True >= 9? test all 16 start positions
        doubled = jnp.concatenate([b, b], axis=0)        # [32, H, W]
        ok = jnp.zeros(img.shape, bool)
        for s in range(16):
            window = doubled[s:s + 9]
            ok = ok | jnp.all(window, axis=0)
        return ok

    is_corner = max_run(brighter) | max_run(darker)
    sad = jnp.sum(jnp.maximum(jnp.abs(ring - center) - threshold, 0.0),
                  axis=0)
    h, w = img.shape
    yy = jnp.arange(h)[:, None]
    xx = jnp.arange(w)[None, :]
    margin = BRIEF_PATCH + 1
    interior = ((yy >= margin) & (yy < h - margin) &
                (xx >= margin) & (xx < w - margin))
    return jnp.where(is_corner & interior, sad, 0.0)


def _nms3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression."""
    neigh = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = jnp.maximum(neigh,
                                jnp.roll(score, (-dy, -dx), axis=(0, 1)))
    return jnp.where(score >= neigh, score, 0.0)


def _orientation(img: jnp.ndarray, xy: jnp.ndarray, radius: int = 7
                 ) -> jnp.ndarray:
    """Intensity-centroid orientation per keypoint (ORB): angle of the
    patch moment vector (m01, m10)."""
    offs = [(dx, dy) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)
            if dx * dx + dy * dy <= radius * radius]
    offs = jnp.asarray(np.array(offs, np.float32))       # [P, 2]
    coords = xy[:, None, :] + offs[None]                 # [K, P, 2]
    vals = _bilinear(img, coords)                        # [K, P]
    m10 = jnp.sum(vals * offs[None, :, 0], axis=1)
    m01 = jnp.sum(vals * offs[None, :, 1], axis=1)
    return jnp.arctan2(m01, m10)


def _bilinear(img: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img at [..., 2] (x, y) float coords (clamped)."""
    h, w = img.shape
    x = jnp.clip(coords[..., 0], 0.0, w - 1.001)
    y = jnp.clip(coords[..., 1], 0.0, h - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _brief_descriptors(img: jnp.ndarray, xy: jnp.ndarray,
                       angle: jnp.ndarray) -> jnp.ndarray:
    """[K, 8] uint32 steered-BRIEF descriptors."""
    pairs = jnp.asarray(BRIEF)                            # [256, 4]
    c = jnp.cos(angle)[:, None]
    s = jnp.sin(angle)[:, None]

    def rot(px, py):
        return (c * px[None] - s * py[None],
                s * px[None] + c * py[None])

    x1, y1 = rot(pairs[:, 0], pairs[:, 1])               # [K, 256]
    x2, y2 = rot(pairs[:, 2], pairs[:, 3])
    p1 = jnp.stack([xy[:, None, 0] + x1, xy[:, None, 1] + y1], axis=-1)
    p2 = jnp.stack([xy[:, None, 0] + x2, xy[:, None, 1] + y2], axis=-1)
    bits = (_bilinear(img, p1) < _bilinear(img, p2)).astype(jnp.uint32)
    bits = bits.reshape(-1, 8, 32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(bits * weights[None, None, :], axis=-1,
                   dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("max_keypoints",))
def detect_and_describe(img: jnp.ndarray,
                        max_keypoints: int = 256,
                        threshold: float = 12.0) -> Keypoints:
    """Full frontend feature pass on a [H, W] intensity (or depth) image."""
    img = img.astype(jnp.float32)
    score = _nms3(fast_scores(img, threshold))
    h, w = img.shape
    flat = score.ravel()
    topv, topi = jax.lax.top_k(flat, max_keypoints)
    xy = jnp.stack([(topi % w).astype(jnp.float32),
                    (topi // w).astype(jnp.float32)], axis=-1)
    valid = topv > 0
    angle = _orientation(img, xy)
    desc = _brief_descriptors(img, xy, angle)
    return Keypoints(xy=xy, score=topv, angle=angle, valid=valid, desc=desc)


def hamming_matrix(da: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """[KA, KB] Hamming distances between uint32x8 descriptor sets."""
    x = jnp.bitwise_xor(da[:, None, :], db[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


class Matches(NamedTuple):
    idx_a: jnp.ndarray    # [K] index into A
    idx_b: jnp.ndarray    # [K] best match in B
    dist: jnp.ndarray     # [K] hamming distance
    valid: jnp.ndarray    # [K] mutual + ratio + validity gate


@jax.jit
def match(a: Keypoints, b: Keypoints,
          max_distance: int = 64,
          ratio: float = 0.9) -> Matches:
    """Mutual nearest-neighbor matching with Lowe ratio test (static K)."""
    big = jnp.int32(10_000)
    d = hamming_matrix(a.desc, b.desc)
    d = jnp.where(a.valid[:, None] & b.valid[None, :], d, big)
    best_b = jnp.argmin(d, axis=1)
    ka = a.xy.shape[0]
    rows = jnp.arange(ka)
    best_d = d[rows, best_b]
    # second best for ratio test
    d2 = d.at[rows, best_b].set(big)
    second_d = jnp.min(d2, axis=1)
    # mutual check
    best_a_of_b = jnp.argmin(d, axis=0)
    mutual = best_a_of_b[best_b] == rows
    valid = (a.valid & mutual & (best_d <= max_distance)
             & (best_d.astype(jnp.float32)
                <= ratio * second_d.astype(jnp.float32)))
    return Matches(idx_a=rows.astype(jnp.int32),
                   idx_b=best_b.astype(jnp.int32),
                   dist=best_d, valid=valid)
