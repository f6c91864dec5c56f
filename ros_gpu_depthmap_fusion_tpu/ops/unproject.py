"""Depth-map unprojection.

Device equivalent of ``shader/convert_depthmap_to_points.glsl`` (the
``compute_convert_depthmap_to_points`` kernel): unproject u16 depth through
pinhole intrinsics to camera-frame points and simultaneously produce
world-frame and crop-frame copies plus the validity mask (zero depth ->
masked out with zeroed points, glsl:102-107).

Differences from the reference, by design:
- Depth arrives as a ``[C, H, W]`` u16 image batch instead of a flat buffer
  of u32-packed depth pairs (the u32 packing was an SSBO-layout artifact;
  pack/unpack parity ops live in :mod:`ops.pack`).
- The three outputs (camera/world/crop) are produced by one fused expression;
  the two 4x4 transforms are ``[C*H*W, 4] @ [4, 4]`` matmuls at HIGHEST
  precision (no TF32 rounding of coordinates).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unproject_depthmaps(depth_u16: jnp.ndarray,
                        intrinsics: jnp.ndarray,
                        tf_world: jnp.ndarray,
                        tf_crop: jnp.ndarray,
                        depth_scale: float,
                        rectify_map: jnp.ndarray | None = None):
    """Unproject a batch of depth maps.

    Args:
        depth_u16:  ``[C, H, W]`` uint16 (or uint32-valued) depth images.
        intrinsics: ``[C, 4]`` float (fx, fy, cx, cy) per camera.
        tf_world:   ``[C, 4, 4]`` world <- camera transforms.
        tf_crop:    ``[C, 4, 4]`` crop  <- camera transforms.
        depth_scale: depth unit -> meters — a python float shared by all
            streams, or a per-camera ``[C]`` array (the reference's
            per-map ``depthScale``, gpu_depthmap_fusion.cpp:798-816).
        rectify_map: optional ``[C, H*W, 2]`` (or broadcastable) float map
            of rectified (u, v) pixel coordinates per linear pixel index —
            the reference reserves ``m_bufRectifyMap`` for this and
            currently passes identity through
            (``shader/convert_depthmap_to_points.glsl:75-81``). ``None``
            (default) is the identity map, matching the reference's
            effective behavior.

    Returns:
        points_cam, points_world, points_crop: ``[C, H*W, 4]`` float32
        homogeneous points (zeros where invalid), and mask ``[C, H*W]`` bool.
    """
    c, h, w = depth_u16.shape
    depth = depth_u16.reshape(c, h * w).astype(jnp.float32)
    mask = depth > 0

    # pixel coordinates from the linear index (glsl:75-81 rectify is identity
    # unless a map is supplied: u = idx % width, v = idx // width)
    if rectify_map is not None:
        rm = jnp.asarray(rectify_map, jnp.float32)
        u = rm[..., 0].reshape(-1, h * w)
        v = rm[..., 1].reshape(-1, h * w)
    else:
        lin = jnp.arange(h * w, dtype=jnp.int32)
        u = (lin % w).astype(jnp.float32)[None, :]      # [1, HW]
        v = (lin // w).astype(jnp.float32)[None, :]

    fx = intrinsics[:, 0:1]
    fy = intrinsics[:, 1:2]
    cx = intrinsics[:, 2:3]
    cy = intrinsics[:, 3:4]

    scale = jnp.asarray(depth_scale, jnp.float32)
    if scale.ndim == 1:
        scale = scale[:, None]          # per-camera [C, 1] broadcast
    z = depth * scale
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    ones = jnp.ones_like(z)

    points_cam = jnp.stack([x, y, z, ones], axis=-1)    # [C, HW, 4]
    points_cam = jnp.where(mask[..., None], points_cam, 0.0)

    # one batched matmul per output frame; masked rows stay zero because
    # a zero homogeneous point maps to zero under  points @ T^T
    points_world = jnp.einsum("chw,cvw->chv", points_cam, tf_world,
                              precision=jax.lax.Precision.HIGHEST)
    points_world = jnp.where(mask[..., None], points_world, 0.0)
    points_crop = jnp.einsum("chw,cvw->chv", points_cam, tf_crop,
                             precision=jax.lax.Precision.HIGHEST)
    points_crop = jnp.where(mask[..., None], points_crop, 0.0)

    return points_cam, points_world, points_crop, mask
