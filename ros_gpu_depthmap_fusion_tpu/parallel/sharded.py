"""Multi-device fusion step.

``shard_map`` re-expression of the fused frame step over a
``(stream, space)`` mesh (see :mod:`.mesh`):

- Depth streams are sharded over ``stream``: each device unprojects/filters
  its own cameras (pure data parallelism — no communication).
- The fresh occupancy grid is combined with one ``lax.pmax`` over ``stream``
  (occupancy is idempotent, so a max-reduce is exact), after which every
  device holds the full fresh grid and updates only its own ``space`` block
  of the historic grid — the historic occupancy is block-partitioned over
  ``space`` and never materialized on one device.
- Average-mode voxelization needs per-cell sums/counts across all cameras:
  one ``lax.psum`` over ``stream``, then each device compacts the occupied
  cells of its own space block (outputs concatenate over ``space``).
- The lidar rollbuffer is SHARDED over ``stream``: staged sequences are
  assigned round-robin (rotated per frame) to stream rows; each shard
  compacts its own sequences out of the replicated staging batch and
  maintains an independent rollbuffer of 1/n_stream capacity. Shard
  selections are disjoint by construction, so their contributions join
  exactly at the existing voxel partial-sum ``psum`` / occupancy ``pmax``
  — and the aggregation window's MEMORY now scales with the stream axis
  (the north-star "scale the aggregation window" item, SURVEY §5).
  Per-shard capacity overflow drops that shard's overflowing sequences
  only (explicit policy, mirroring the single-chip engine's).

The reference has no distribution story at all (single GPU, SURVEY.md
§2.7); this module is the north-star "shard point streams by camera,
block-partition the voxel map spatially" design. No pipeline/expert
parallelism exists or is needed for this workload (documented N/A).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu.ops.depth_codec import (
    EncodedDepth, decode_depth)
from ros_gpu_depthmap_fusion_tpu.ops.unproject import unproject_depthmaps
from ros_gpu_depthmap_fusion_tpu.ops.flying_pixels import (
    filter_flying_pixels)
from ros_gpu_depthmap_fusion_tpu.ops.stencil import filter_point_sequence
from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import crop_points, compact
from ros_gpu_depthmap_fusion_tpu.ops.voxel import (
    occupancy_bitmap, scatter_occupancy, update_historic_occupancy,
    occupancy_to_u8)
from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
    voxelize_partial_sums, dequantize_cell_means)
from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import compact_multi
from ros_gpu_depthmap_fusion_tpu.state import rollbuffer as rbmod
from ros_gpu_depthmap_fusion_tpu.pipeline.engine import (
    EngineState, FrameInputs, SequenceBatch)
from ros_gpu_depthmap_fusion_tpu.parallel.mesh import (
    SPACE_AXIS, STREAM_AXIS)


class ShardedFrameOutputs(NamedTuple):
    # average mode: [n_space * n_stream * sub_cap, 4] — the voxelize
    # partial sums reduce-scatter over ``stream`` (each stream member
    # dequantizes + compacts its own 1/n_stream sub-slab of the space
    # block), so fused blocks are (space-major, stream-minor).
    # occupied mode: [n_space * block_out_cap, 4] (by space block).
    # Consumers should reshape by len(fused_counts) blocks.
    fused_points: jnp.ndarray
    fused_counts: jnp.ndarray   # [num blocks] emitted per block
    raw_points: jnp.ndarray     # [n_stream * local_cap, 4] (by stream shard)
    raw_counts: jnp.ndarray     # [n_stream]
    occupancy_u8: jnp.ndarray   # [padded_cells] uint8 (space-concatenated)
    # binarized occupancy packed 8 cells/byte PER SPACE BLOCK
    # ([n_space * ceil(block/8)] u8) — the sharded mapping consumer's
    # cheap d2h payload (each block padded to a byte boundary; host
    # assembly in ShardedFusionEngine.segment_and_track)
    occupancy_bits: jnp.ndarray


def padded_num_cells(grid: VoxelGrid, n_space: int,
                     n_stream: int = 1) -> int:
    """Grid cells padded so each space block splits evenly over the
    stream axis too (the average-voxelize reduce-scatter hands each
    stream member a ``block / n_stream`` sub-slab)."""
    mult = n_space * n_stream
    return ((grid.num_cells + mult - 1) // mult) * mult


def _rb_caps(cfg: FusionConfig, n_stream: int):
    """Per-shard rollbuffer capacities (the global capacity splits over
    the stream axis — aggregation-window memory scales with it)."""
    p_cap, s_cap = (cfg.rollbuffer_point_capacity,
                    cfg.rollbuffer_seq_capacity)
    assert p_cap % n_stream == 0 and s_cap % n_stream == 0, (
        p_cap, s_cap, n_stream)
    return p_cap // n_stream, s_cap // n_stream


def sharded_initial_state(cfg: FusionConfig, grid: VoxelGrid,
                          mesh: Mesh) -> EngineState:
    """EngineState whose historic grid is padded to a multiple of the space
    axis and sharded over it; rollbuffer stream-sharded (each stream row
    owns 1/n_stream of the point/sequence capacity; the scalar extents
    become per-shard [n_stream] vectors)."""
    n_space = mesh.shape[SPACE_AXIS]
    n_stream = mesh.shape[STREAM_AXIS]
    padded = padded_num_cells(grid, n_space, n_stream)
    rb = rbmod.make_rollbuffer(
        cfg.rollbuffer_point_capacity, cfg.rollbuffer_seq_capacity)
    rb = rb._replace(num_points=jnp.zeros((n_stream,), jnp.int32),
                     num_seqs=jnp.zeros((n_stream,), jnp.int32))
    state = EngineState(
        rollbuffer=rb,
        historic_occupancy=jnp.zeros((padded,), jnp.int32),
        frame_index=jnp.int32(0),
        prev_depth_q=jnp.zeros((1, 1, 1), jnp.uint16),
    )
    return jax.device_put(state, state_shardings(mesh))


def _rb_specs():
    """PartitionSpecs for the stream-sharded RollBuffer pytree (leading
    dim of every array — point rows, sequence rows, per-shard extents —
    splits over the stream axis)."""
    return rbmod.RollBuffer(
        points=P(STREAM_AXIS), mask=P(STREAM_AXIS), seq_idx=P(STREAM_AXIS),
        seq_sec=P(STREAM_AXIS), seq_nsec=P(STREAM_AXIS),
        seq_start=P(STREAM_AXIS), seq_count=P(STREAM_AXIS),
        seq_tf_move=P(STREAM_AXIS),
        num_points=P(STREAM_AXIS), num_seqs=P(STREAM_AXIS))


def state_shardings(mesh: Mesh):
    rep = NamedSharding(mesh, P())
    return EngineState(
        rollbuffer=jax.tree.map(
            lambda spec: NamedSharding(mesh, spec), _rb_specs(),
            is_leaf=lambda x: isinstance(x, P)),
        historic_occupancy=NamedSharding(mesh, P(SPACE_AXIS)),
        frame_index=rep,
        prev_depth_q=rep,
    )


def input_shardings(mesh: Mesh, depth_bits=None):
    """Shardings for FrameInputs. With ``depth_bits`` set, ``depth`` is an
    :class:`EncodedDepth` whose words/row_first shard over ``stream`` (each
    host transfers only its cameras' compressed rows) and whose small
    exception arrays stay replicated."""
    rep = NamedSharding(mesh, P())
    stream0 = NamedSharding(mesh, P(STREAM_AXIS))
    depth_sh = stream0 if depth_bits is None else EncodedDepth(
        words=stream0, row_first=stream0, exc_idx=rep, exc_zz=rep,
        exc_count=rep)
    return FrameInputs(
        depth=depth_sh, intrinsics=stream0, tf_world=stream0,
        tf_crop=stream0,
        seq_batch=SequenceBatch(*([rep] * 8)),
        tf_world_move=rep, tf_crop_move=rep,
        now_sec=rep, now_nsec=rep,
        roll_min_sec=rep, roll_min_nsec=rep,
        fp_threshold=rep, fp_max_distance=rep, ps_threshold=rep,
    )


def build_sharded_fusion_step(cfg: FusionConfig, grid: VoxelGrid,
                              mesh: Mesh,
                              block_output_capacity: Optional[int] = None,
                              depth_bits: Optional[int] = None):
    """Compile the multi-device frame step.

    Inputs follow :func:`input_shardings` (depth batch sharded over
    ``stream``); state follows :func:`state_shardings`. Returns a jitted
    ``(state, inputs) -> (state, ShardedFrameOutputs)``.

    ``depth_bits``: static DPCM code width — ``inp.depth`` is then an
    :class:`EncodedDepth` and each shard decodes its own cameras inside
    the step (the compressed link codec of the single-chip engine,
    ops/depth_codec.py, applied per stream shard).
    """
    n_stream = mesh.shape[STREAM_AXIS]
    n_space = mesh.shape[SPACE_AXIS]
    c = cfg.num_depth_streams
    assert c % n_stream == 0, (c, n_stream)
    # LOUD capability gates (round-5 verdict item 3): the single-chip
    # engine supports these; the sharded step does not yet — refusing is
    # better than silently computing wrong results (heterogeneous shapes
    # would previously fail only incidentally at staging, and
    # dpcm_temporal silently fell back to a raw link in the engine).
    assert not cfg.is_heterogeneous, (
        "heterogeneous stream_shapes are not supported on the sharded "
        "step yet — use the single-chip engine (pipeline/engine.py) for "
        "mixed-resolution rigs")
    assert cfg.depth_link_codec != "dpcm_temporal", (
        "dpcm_temporal is not supported on the sharded step yet (per-"
        "shard P-frame state is not plumbed) — use 'dpcm' or 'none'")
    c_local = c // n_stream
    h, w = cfg.depth_height, cfg.depth_width
    n_depth_local = c_local * h * w
    sel_cap, seq_cap_local = _rb_caps(cfg, n_stream)
    local_cap = n_depth_local + sel_cap
    padded = padded_num_cells(grid, n_space, n_stream)
    block = padded // n_space
    if block_output_capacity is None:
        block_output_capacity = min(block, local_cap)
    # average mode compacts per (space, stream) sub-slab
    sub_output_capacity = -(-block_output_capacity // n_stream)

    def local_step(state: EngineState, inp: FrameInputs):
        # local rollbuffer: per-shard extents arrive as [1] slices
        rb = state.rollbuffer._replace(
            num_points=state.rollbuffer.num_points[0],
            num_seqs=state.rollbuffer.num_seqs[0])
        sb = inp.seq_batch
        stream_id = jax.lax.axis_index(STREAM_AXIS)
        space_id = jax.lax.axis_index(SPACE_AXIS)

        # ---- rollbuffer maintenance: STREAM-SHARDED. The staging batch
        # is replicated; ownership is round-robin over staged sequences,
        # rotated by frame so sparse frames still spread over shards.
        # Each shard compacts its own sequences to the front of a local
        # batch and inserts only those; selections are therefore disjoint
        # across shards and join exactly at the voxel partial-sum psum.
        stage_idx = jnp.arange(sb.points.shape[0], dtype=jnp.int32)
        staged_mask = stage_idx < sb.num_points
        seq_mask = filter_point_sequence(
            sb.points, staged_mask, sb.num_points,
            cfg.point_sequence_filter_size, inp.ps_threshold)
        s_stage = jnp.arange(sb.seq_sec.shape[0], dtype=jnp.int32)
        own_seq = (((s_stage + state.frame_index) % n_stream == stream_id)
                   & (s_stage < sb.num_seqs))
        # compact owned sequence records to the front
        (o_sec, o_nsec, o_cnt, o_tf), n_own = compact_multi(
            (sb.seq_sec, sb.seq_nsec, sb.seq_count,
             sb.seq_tf_move.reshape(-1, 16)), own_seq,
            sb.seq_sec.shape[0])
        # compact owned points (order within/across sequences preserved —
        # the stable compaction keeps staging order, so points stay
        # contiguous per sequence)
        own_rank = jnp.cumsum(own_seq.astype(jnp.int32)) - 1
        own_pt = own_seq[sb.seq_idx] & staged_mask
        (o_pts, o_mask_f, o_idx_f), n_pts = compact_multi(
            (sb.points, seq_mask.astype(jnp.float32),
             own_rank[sb.seq_idx].astype(jnp.float32)), own_pt,
            sb.points.shape[0])
        rb, _ = rbmod.insert_sequences(
            rb, o_pts, o_mask_f > 0.5, o_idx_f.astype(jnp.int32),
            o_sec, o_nsec, o_cnt, o_tf.reshape(-1, 4, 4), n_pts, n_own)
        rb = rbmod.roll(rb, inp.roll_min_sec, inp.roll_min_nsec)
        sel = rbmod.select_timespan(
            rb, inp.roll_min_sec, inp.roll_min_nsec,
            inp.now_sec, inp.now_nsec)
        seq_world, seq_crop, seq_valid, _ = rbmod.gather_selection(
            rb, sel, inp.tf_world_move, inp.tf_crop_move, sel_cap)
        seq_valid_local = seq_valid

        # ---- local depth pipeline (own cameras only) ----
        if depth_bits is None:
            depth_u16 = inp.depth
        else:
            # exceptions carry GLOBAL flat pixel indices (replicated);
            # rebase into this shard's window and drop the rest (indices
            # mapped to n_depth_local scatter with mode="drop")
            enc = inp.depth
            offset = stream_id * jnp.int32(n_depth_local)
            li = enc.exc_idx.astype(jnp.int32) - offset
            li = jnp.where((li >= 0) & (li < n_depth_local), li,
                           jnp.int32(n_depth_local))
            depth_u16 = decode_depth(
                enc._replace(exc_idx=li), h, w, depth_bits,
                cfg.depth_codec_quant_shift)
        # per-stream depth scales (reference per-map depthScale,
        # gpu_depthmap_fusion.cpp:798-816): slice this shard's window of
        # the global [C] scale vector — parity with the single-chip
        # engine's hetero scales (round-5 verdict item 3)
        if cfg.depth_scales is not None:
            scale = jax.lax.dynamic_slice(
                jnp.asarray(cfg.resolved_depth_scales, jnp.float32),
                (stream_id * jnp.int32(c_local),), (c_local,))
        else:
            scale = cfg.depth_scale
        pts_cam, pts_world, pts_crop, dmask = unproject_depthmaps(
            depth_u16, inp.intrinsics, inp.tf_world, inp.tf_crop,
            scale)
        if cfg.enable_flyingpixels_filter:
            dmask = filter_flying_pixels(
                pts_cam, dmask, h, w,
                cfg.flyingpixels_filter_size,
                inp.fp_threshold,
                cfg.flyingpixels_filter_enable_rot45,
                inp.fp_max_distance)

        all_world = jnp.concatenate(
            [pts_world.reshape(n_depth_local, 4), seq_world], axis=0)
        all_crop = jnp.concatenate(
            [pts_crop.reshape(n_depth_local, 4), seq_crop], axis=0)
        all_mask = jnp.concatenate(
            [dmask.reshape(n_depth_local), seq_valid_local], axis=0)
        all_mask = crop_points(all_crop, all_mask, cfg.crop_min, cfg.crop_max)

        raw_points, raw_count = compact(all_world, all_mask, local_cap)

        # ---- fresh occupancy: local scatter, slice own space block, then
        #      pmax over streams — the collective moves one [block] slab
        #      per device (n_space x less ICI traffic than reducing the
        #      full grid and slicing afterwards) ----
        cell_ids = grid.cell_index_clamped(raw_points[:, :3])
        live = jnp.arange(local_cap, dtype=jnp.int32) < raw_count
        fresh_local = scatter_occupancy(cell_ids, live, padded)
        my_block = jax.lax.pmax(
            jax.lax.dynamic_slice(fresh_local, (space_id * block,),
                                  (block,)),
            STREAM_AXIS)

        # ---- historic update on own space block only ----
        historic = update_historic_occupancy(
            state.historic_occupancy, my_block,
            cfg.voxel_occupancy_lifetime)
        occupancy_u8 = occupancy_to_u8(historic)

        # ---- fused output points per space block ----
        blk_ids = jnp.arange(block, dtype=jnp.int32) + space_id * block
        if cfg.voxel_enable_average:
            # sort-based per-shard partial sums (the packed 10/10/12
            # quantized path); instead of a full-grid colliding at[].add,
            # one unique-index scatter of <= partials_cap compacted rows
            # (deterministic: no float atomics). Integer partial
            # sums commute, so psum over streams reproduces the
            # single-device packed means bit-for-bit.
            partials_cap = min(local_cap, padded)
            p_cells, p_qsums, p_cnts, _ = voxelize_partial_sums(
                raw_points, cell_ids, live, grid, partials_cap)
            rows = jnp.concatenate([p_qsums, p_cnts[:, None]], axis=-1)
            tgt = jnp.where(p_cnts > 0, p_cells, padded)
            dense = jnp.zeros((padded, 4), jnp.float32).at[tgt].set(
                rows, mode="drop")
            # REDUCE-SCATTER over stream (round-5, DESIGN §9): each
            # stream member receives only the summed [block/n_stream, 4]
            # sub-slab it owns — (n-1)/n of the slab's bytes over ICI vs
            # the psum all-reduce's 2(n-1)/n, and 1/n_stream of the
            # dequantize + compact work (which scaled with the full
            # block). Exact: the partial sums are integer-valued f32
            # < 2^24, so any reduction order is bit-identical.
            sub = block // n_stream
            part = jax.lax.psum_scatter(
                jax.lax.dynamic_slice(dense, (space_id * block, 0),
                                      (block, 4)),
                STREAM_AXIS, scatter_dimension=0, tiled=True)
            sub_ids = (jnp.arange(sub, dtype=jnp.int32)
                       + space_id * block + stream_id * sub)
            blk_cnts = jnp.where(sub_ids < grid.num_cells,
                                 part[:, 3], 0.0)
            pts = dequantize_cell_means(sub_ids, part[:, :3], blk_cnts,
                                        grid)
            (fused_points,), fused_count = compact_multi(
                (pts,), blk_cnts > 0, sub_output_capacity)
        else:
            xyz = grid.world_coord_of_index(jnp.minimum(
                blk_ids, grid.num_cells - 1))
            pts = jnp.concatenate(
                [xyz, jnp.ones_like(xyz[:, :1])], axis=-1)
            occ_blk = my_block > 0
            occ_blk = occ_blk & (blk_ids < grid.num_cells)
            (fused_points,), fused_count = compact_multi(
                (pts,), occ_blk, block_output_capacity)

        new_state = EngineState(
            rollbuffer=rb._replace(num_points=rb.num_points[None],
                                   num_seqs=rb.num_seqs[None]),
            historic_occupancy=historic,
            frame_index=state.frame_index + 1,
            prev_depth_q=state.prev_depth_q)
        out = ShardedFrameOutputs(
            fused_points=fused_points,
            fused_counts=fused_count[None],
            raw_points=raw_points,
            raw_counts=raw_count[None],
            occupancy_u8=occupancy_u8,
            occupancy_bits=occupancy_bitmap(historic),
        )
        return new_state, out

    state_specs = EngineState(
        rollbuffer=_rb_specs(),
        historic_occupancy=P(SPACE_AXIS),
        frame_index=P(),
        prev_depth_q=P(),
    )
    depth_spec = P(STREAM_AXIS) if depth_bits is None else EncodedDepth(
        words=P(STREAM_AXIS), row_first=P(STREAM_AXIS), exc_idx=P(),
        exc_zz=P(), exc_count=P())
    in_specs = FrameInputs(
        depth=depth_spec, intrinsics=P(STREAM_AXIS),
        tf_world=P(STREAM_AXIS), tf_crop=P(STREAM_AXIS),
        seq_batch=SequenceBatch(*([P()] * 8)),
        tf_world_move=P(), tf_crop_move=P(),
        now_sec=P(), now_nsec=P(), roll_min_sec=P(), roll_min_nsec=P(),
        fp_threshold=P(), fp_max_distance=P(), ps_threshold=P(),
    )
    # average mode: fused sub-blocks partition over (space, stream) —
    # space-major, stream-minor along dim 0
    fused_spec = (P((SPACE_AXIS, STREAM_AXIS))
                  if cfg.voxel_enable_average else P(SPACE_AXIS))
    out_specs = (state_specs, ShardedFrameOutputs(
        fused_points=fused_spec,
        fused_counts=fused_spec,
        raw_points=P(STREAM_AXIS),
        raw_counts=P(STREAM_AXIS),
        occupancy_u8=P(SPACE_AXIS),
        occupancy_bits=P(SPACE_AXIS),
    ))

    mapped = shard_map(local_step, mesh=mesh,
                       in_specs=(state_specs, in_specs),
                       out_specs=out_specs, check_vma=False)
    return jax.jit(mapped, donate_argnums=(0,))
