"""SE(3) transforms on homogeneous point arrays.

Convention note (load-bearing for parity with the reference): the reference
uploads row-major ``cv::Matx44f`` non-transposed into GLSL column-major mat4
(``program_uniform.h:197-209``), so its kernels compute ``point * mat`` which
equals the standard ``M @ p`` with the *row-major* host matrix
(``shader/transform_points_indirect.glsl:67``). Here transforms are plain
``[4, 4]`` row-major matrices applied as ``points @ T.T`` — numerically the
standard column-vector convention, identical to the reference's effective
math.

Points are ``[..., 4]`` homogeneous float arrays with w = 1 for valid points
and all-zero rows for invalid ones (reference zeroes masked-out points,
``shader/convert_depthmap_to_points.glsl:104-106``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def transform_points(points: jnp.ndarray, tf: jnp.ndarray) -> jnp.ndarray:
    """Apply one 4x4 transform to ``[..., 4]`` homogeneous points.

    Full fp32 precision (HIGHEST, never TF32): geometric transforms are
    parity-critical and a K=4 matmul is bandwidth-bound, so the precision
    is free.
    """
    return jnp.matmul(points, tf.T, precision=jax.lax.Precision.HIGHEST)


def transform_points_indirect(points: jnp.ndarray,
                              tfs: jnp.ndarray,
                              tf_indices: jnp.ndarray,
                              mask: jnp.ndarray) -> jnp.ndarray:
    """Per-point transform gathered by per-point transform index.

    Semantics of ``shader/transform_points_indirect.glsl:60-68``: for each
    point i, ``out[i] = tfs[tf_indices[i]] @ p[i]`` where masked-out points
    pass through unchanged (the reference skips the write; functionally the
    input value is preserved).

    Args:
        points:     ``[N, 4]`` homogeneous points.
        tfs:        ``[S, 4, 4]`` transform table.
        tf_indices: ``[N]`` int indices into ``tfs``.
        mask:       ``[N]`` bool validity.
    """
    per_point_tf = tfs[tf_indices]                       # [N, 4, 4] gather
    moved = jnp.einsum("nij,nj->ni", per_point_tf, points,
                       precision=jax.lax.Precision.HIGHEST)
    return jnp.where(mask[:, None], moved, points)


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Standard composition: ``compose(a, b) @ p == a @ (b @ p)``."""
    return a @ b


def compose_seq_transforms(tf_frame_move: jnp.ndarray,
                           tf_move_seq: jnp.ndarray) -> jnp.ndarray:
    """Per-sequence transform composition used by the rollbuffer: a sequence's
    points (recorded in their capture frame, with ``transform_move`` mapping
    capture -> move frame) are brought to world/crop via
    ``T_frame<-move @ T_move<-seq`` — the effective math of
    ``shader/rollbuffer_transfer_selected_transforms.glsl:57-66`` after
    unfolding the reference's GL row/col-major convention.

    Args:
        tf_frame_move: ``[4, 4]`` target frame <- move frame.
        tf_move_seq:   ``[S, 4, 4]`` move frame <- sequence capture frame.
    Returns:
        ``[S, 4, 4]`` target frame <- sequence capture frame.
    """
    return jnp.einsum("ij,sjk->sik", tf_frame_move, tf_move_seq,
                      precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# Host-side (numpy) constructors
# ---------------------------------------------------------------------------

def make_se3(rotation: np.ndarray = None,
             translation: np.ndarray = None) -> np.ndarray:
    t = np.eye(4, dtype=np.float32)
    if rotation is not None:
        t[:3, :3] = rotation
    if translation is not None:
        t[:3, 3] = translation
    return t


def rot_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float32)


def rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


def look_at(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """world <- camera pose for a pinhole camera at ``eye`` looking at
    ``target`` (CV convention: +x right, +y down, +z forward)."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
    up = np.asarray(up, np.float64)
    x = np.cross(fwd, up)
    n = np.linalg.norm(x)
    if n < 1e-9:  # looking straight along up: pick an arbitrary right
        x = np.cross(fwd, np.array([1.0, 0.0, 0.0]))
        n = np.linalg.norm(x)
    x = x / n
    y = np.cross(fwd, x)  # completes right-handed (x, y, z=forward), y down
    r = np.stack([x, y, fwd], axis=1).astype(np.float32)
    return make_se3(r, eye.astype(np.float32))


def invert_se3(tf: np.ndarray) -> np.ndarray:
    """Closed-form inverse of a rigid transform."""
    r = tf[:3, :3]
    t = tf[:3, 3]
    out = np.eye(4, dtype=tf.dtype)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def to_homogeneous(xyz: np.ndarray) -> np.ndarray:
    """``[..., 3]`` -> ``[..., 4]`` with w=1."""
    shape = xyz.shape[:-1] + (4,)
    out = np.ones(shape, dtype=xyz.dtype)
    out[..., :3] = xyz
    return out
