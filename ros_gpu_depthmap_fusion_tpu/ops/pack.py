"""Bit-packing layout conversions.

Parity ops for the reference's SSBO layout converters (§2.3 of SURVEY.md):

- depth pairs: two u16 depths per u32 word, little-end first
  (``shader/convert_depthmap_to_points.glsl:100-101`` ``bitfieldExtract``).
- ``uints_to_chars`` / ``chars_to_uints``: u32 <-> 4 x u8.
- ``uints_to_words`` / ``words_to_uints``: u32 <-> 2 x u16 (CC label upload,
  gpu_depthmap_fusion.cpp:2041-2046).
- ``vec3_to_vec4`` / ``vec4_to_vec3`` layout converters (unused by the
  reference engine) are the trivial reshapes :func:`xyz_to_homogeneous` /
  ``points[..., :3]`` and are not given dedicated ops.

These only matter at host I/O boundaries; inside the fused pipeline
data stays unpacked.
"""

from __future__ import annotations

import jax.numpy as jnp


def unpack_depth_pairs(pairs_u32: jnp.ndarray) -> jnp.ndarray:
    """``[N]`` u32 -> ``[2N]`` u16 depths; element i of the output comes from
    bits ``16*(i%2) .. 16*(i%2)+15`` of word ``i//2``."""
    lo = (pairs_u32 & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    hi = (pairs_u32 >> jnp.uint32(16)).astype(jnp.uint16)
    return jnp.stack([lo, hi], axis=-1).reshape(-1)


def pack_depth_pairs(depth_u16: jnp.ndarray) -> jnp.ndarray:
    """``[2N]`` u16 depths -> ``[N]`` u32 pair words (inverse of
    :func:`unpack_depth_pairs`)."""
    d = depth_u16.reshape(-1, 2).astype(jnp.uint32)
    return d[:, 0] | (d[:, 1] << jnp.uint32(16))


def uints_to_chars(values_u32: jnp.ndarray) -> jnp.ndarray:
    """``[N]`` u32 -> ``[4N]`` u8, little-endian byte order (truncating cast
    per byte, as the reference kernel)."""
    v = values_u32.astype(jnp.uint32)
    bytes_ = [(v >> jnp.uint32(8 * i)) & jnp.uint32(0xFF) for i in range(4)]
    return jnp.stack(bytes_, axis=-1).reshape(-1).astype(jnp.uint8)


def chars_to_uints(values_u8: jnp.ndarray) -> jnp.ndarray:
    b = values_u8.reshape(-1, 4).astype(jnp.uint32)
    return (b[:, 0] | (b[:, 1] << jnp.uint32(8)) |
            (b[:, 2] << jnp.uint32(16)) | (b[:, 3] << jnp.uint32(24)))


def uints_to_words(values_u32: jnp.ndarray) -> jnp.ndarray:
    """``[N]`` u32 -> ``[2N]`` u16."""
    v = values_u32.astype(jnp.uint32)
    lo = (v & jnp.uint32(0xFFFF)).astype(jnp.uint16)
    hi = (v >> jnp.uint32(16)).astype(jnp.uint16)
    return jnp.stack([lo, hi], axis=-1).reshape(-1)


def words_to_uints(values_u16: jnp.ndarray) -> jnp.ndarray:
    w = values_u16.reshape(-1, 2).astype(jnp.uint32)
    return w[:, 0] | (w[:, 1] << jnp.uint32(16))
