"""No f32 matmul in the per-frame path may run at reduced precision.

On an H100 a float32 ``dot_general`` without an explicit precision may run
in TF32 (10-bit mantissa), which would round 16-bit depth literals and
world coordinates. Every f32 ``dot_general`` that the fused step or the p4
decoder traces must therefore carry ``Precision.HIGHEST``; this checks the
traced programs, which is what a CPU test can see of the GPU's choice.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu.ops import depth_codec as DC
from ros_gpu_depthmap_fusion_tpu.pipeline.engine import (
    build_packet_step, initial_state)
from ros_gpu_depthmap_fusion_tpu.pipeline.packet import PacketLayout


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        vals = v if isinstance(v, (list, tuple)) else (v,)
        for x in vals:
            if isinstance(x, ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, Jaxpr):
                yield x


def low_precision_f32_dots(jaxpr):
    """f32 ``dot_general`` equations whose precision is not HIGHEST."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            if any(v.aval.dtype == jnp.float32 for v in eqn.invars):
                prec = eqn.params.get("precision")
                precs = prec if isinstance(prec, tuple) else (prec,)
                if not all(p == jax.lax.Precision.HIGHEST for p in precs):
                    bad.append(str(eqn))
        for sub in _sub_jaxprs(eqn):
            bad += low_precision_f32_dots(sub)
    return bad


def test_detector_flags_default_precision():
    a = jnp.ones((4, 4), jnp.float32)
    assert low_precision_f32_dots(jax.make_jaxpr(jnp.dot)(a, a).jaxpr)
    hi = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    assert not low_precision_f32_dots(jax.make_jaxpr(hi)(a, a).jaxpr)


def test_decode_depth_p4_has_no_low_precision_dot():
    rows, w, budget = 6, 40, 8
    gw = -(-w // 4)
    enc = DC.EncodedDepthP4(
        jnp.zeros((rows, -(-gw // 32)), jnp.int32),
        jnp.zeros((rows, budget // 4), jnp.int32),
        jnp.zeros((16,), jnp.int32), jnp.zeros((16,), jnp.int32),
        jnp.int32(0))
    fn = functools.partial(DC.decode_depth_p4, height=3, width=w,
                           budget=budget, quant_shift=4)
    jaxpr = jax.make_jaxpr(fn)(enc, jnp.zeros((2, 3, w), jnp.uint16))
    assert not low_precision_f32_dots(jaxpr.jaxpr)


@pytest.mark.parametrize("bits", [None, "p4"])
def test_fusion_step_has_no_low_precision_dot(bits):
    """The whole packet step (unpack, lidar delta decode with its one-hot
    rebase, depth decode, unproject, filters, voxelize, occupancy)."""
    temporal = bits == "p4"
    cfg = FusionConfig(
        num_depth_streams=2, depth_height=8, depth_width=12,
        num_point_sequences=1,
        crop_min=(-3, -3, -3), crop_max=(3, 3, 3),
        voxel_min=(-3, -3, -3), voxel_max=(3, 3, 3),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=64, rollbuffer_seq_capacity=8,
        max_points_per_sequence=32,
        depth_link_codec="dpcm_temporal" if temporal else "none",
        depth_codec_p4_budget=8 if temporal else 0,
        lidar_link_quant_step=0.002, lidar_link_delta=True)
    grid = VoxelGrid.from_config(cfg)
    layout = PacketLayout.for_config(cfg, seq_cap=4, stage_cap=32)
    step = build_packet_step(cfg, grid, layout, donate=False)
    packet = jnp.zeros((layout.total_words(bits),), jnp.uint32)
    jaxpr = jax.make_jaxpr(lambda s, p: step(s, p, depth_bits=bits))(
        initial_state(cfg, grid), packet)
    bad = low_precision_f32_dots(jaxpr.jaxpr)
    assert not bad, bad[:3]
