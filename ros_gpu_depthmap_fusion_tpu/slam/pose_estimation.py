"""Frame-to-frame pose estimation from 3-D correspondences.

RGB-D gives metric 3-D points per feature, so relative pose is a 3D-3D
alignment problem: Kabsch/Umeyama closed-form SVD alignment wrapped in a
fixed-iteration, fully vectorized RANSAC (vmapped hypotheses — no
data-dependent control flow), followed by an all-inlier
refinement.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


def kabsch(src: jnp.ndarray, dst: jnp.ndarray,
           weights: jnp.ndarray) -> jnp.ndarray:
    """Weighted rigid alignment: returns T (4x4) with dst ~= T @ src.

    Traced under float32 matmul precision: reduced-precision matmuls
    (bf16, or TF32 on an H100) put ~0.4% relative error into the 3x3
    covariance and the residual projections — per-frame-pair pose errors
    at the mm-cm level that poison every BA window the frontend builds
    (landmark anchors and observations disagree at the decimetre level
    and BA "corrects" by 0.1-0.8 m).

    Standard Kabsch/Umeyama via 3x3 SVD with reflection fix.
    """
    with jax.default_matmul_precision("float32"):
        w = weights.astype(jnp.float32)
        wsum = jnp.maximum(jnp.sum(w), 1e-9)
        mu_s = jnp.sum(src * w[:, None], axis=0) / wsum
        mu_d = jnp.sum(dst * w[:, None], axis=0) / wsum
        sc = src - mu_s
        dc = dst - mu_d
        h = (sc * w[:, None]).T @ dc                     # [3, 3]
        u, s, vt = jnp.linalg.svd(h)
        d = jnp.sign(jnp.linalg.det(vt.T @ u.T))
        diag = jnp.diag(jnp.array([1.0, 1.0, 1.0]))
        diag = diag.at[2, 2].set(d)
        r = vt.T @ diag @ u.T
        t = mu_d - r @ mu_s
        tf = jnp.eye(4, dtype=jnp.float32)
        tf = tf.at[:3, :3].set(r)
        tf = tf.at[:3, 3].set(t)
        return tf


class RansacResult(NamedTuple):
    transform: jnp.ndarray   # [4, 4] dst <- src
    inliers: jnp.ndarray     # [N] bool
    num_inliers: jnp.ndarray
    rmse: jnp.ndarray        # inlier RMSE


@functools.partial(jax.jit, static_argnames=("iterations",))
def ransac_pose(src: jnp.ndarray, dst: jnp.ndarray, valid: jnp.ndarray,
                key: jax.Array,
                iterations: int = 64,
                inlier_threshold: float = 0.05) -> RansacResult:
    """Robust rigid alignment of correspondences ``dst[i] ~ T @ src[i]``.

    Args:
        src, dst: [N, 3] matched points (invalid rows arbitrary).
        valid:    [N] bool correspondence validity.
        key:      PRNG key (hypothesis sampling).
        iterations: static hypothesis count, evaluated via vmap.
    """
    # float32 matmul precision for the residual projections (see
    # kabsch docstring — bf16 residuals shift the inlier sets too)
    n = src.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1e-9)

    def hypothesis(k):
        idx = jax.random.choice(k, n, shape=(3,), replace=False, p=probs)
        tf = kabsch(src[idx], dst[idx], jnp.ones(3))
        res = dst - (src @ tf[:3, :3].T + tf[:3, 3])
        err2 = jnp.sum(res * res, axis=-1)
        inl = valid & (err2 < inlier_threshold ** 2)
        return tf, jnp.sum(inl.astype(jnp.int32))

    keys = jax.random.split(key, iterations)
    with jax.default_matmul_precision("float32"):
        tfs, counts = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(counts)
    tf0 = tfs[best]

    # refine on the best hypothesis' inliers (two Kabsch refits)
    def refit(tf, _):
        res = dst - (src @ tf[:3, :3].T + tf[:3, 3])
        err2 = jnp.sum(res * res, axis=-1)
        inl = valid & (err2 < inlier_threshold ** 2)
        tf = kabsch(src, dst, inl.astype(jnp.float32))
        return tf, inl

    with jax.default_matmul_precision("float32"):
        tf1, _ = refit(tf0, None)
        tf2, inl = refit(tf1, None)
        res = dst - (src @ tf2[:3, :3].T + tf2[:3, 3])
    err2 = jnp.sum(res * res, axis=-1)
    num = jnp.sum(inl.astype(jnp.int32))
    rmse = jnp.sqrt(jnp.sum(jnp.where(inl, err2, 0.0))
                    / jnp.maximum(num, 1))
    return RansacResult(transform=tf2, inliers=inl, num_inliers=num,
                        rmse=rmse)


def unproject_keypoints(xy: jnp.ndarray, depth_m: jnp.ndarray,
                        fx: float, fy: float, cx: float, cy: float
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Camera-frame 3-D points for keypoint pixels from a [H, W] metric
    depth image (nearest-pixel lookup); returns (points [K, 3], has_depth)."""
    h, w = depth_m.shape
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    z = depth_m[yi, xi]
    x = (xy[:, 0] - cx) / fx * z
    y = (xy[:, 1] - cy) / fy * z
    return jnp.stack([x, y, z], axis=-1), z > 0
