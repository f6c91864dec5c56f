"""The fusion engine: per-frame device step + host orchestrator.

Re-design of the reference engine ``GPUDepthmapFusion`` + the per-frame
driver ``GPUDepthmapFusionComponent::processDepthmaps``
(``src/gpu_depthmap_fusion_component.cpp:92-515``; SURVEY.md §3.2). The
reference dispatches ~20 GPU kernels with 4+ full GPU<->CPU round-trips per
frame (voxel coords down, voxelized points up, occupancy down, CC labels
up/down). Here the whole numeric pipeline — rollbuffer maintenance, depth
unprojection, filtering, cropping, compaction, voxelization, occupancy
decay — is ONE jitted XLA program; the only per-frame host traffic is input
staging in and the (small) fused outputs back.

Stage order inside :func:`build_fusion_step` mirrors processDepthmaps:

    1. filter new point sequences        (cpp:166  filterNewPointSequences)
    2. insert into rollbuffer            (cpp:168  insertNewPointSequences…)
    3. expire old sequences              (cpp:185  rollPointSequenceRollbufferCPU)
    4. select aggregation timespan       (cpp:194  selectPointSequenceTimespanCPU)
    5. gather + transform selection      (cpp:199-203 insertSelected…/transform…)
    6. unproject depth maps              (cpp:226  convertDepthmaps)
    7. flying-pixel filter               (cpp:234  filterFlyingPixels)
    8. crop                              (cpp:241  cropPoints)
    9. compact                           (cpp:249  applyPointMask)
    10. voxel coords + voxelize          (cpp:259-288 computeVoxelCoords/voxelize)
    11. occupancy + temporal decay       (cpp:297  voxelOccupancyGrid)

Object segmentation + tracking live in :mod:`mapping` (a second device
program over the occupancy grid + small-N host assembly), driven by
:class:`FusionEngine`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu.core import timeutil
from ros_gpu_depthmap_fusion_tpu.ops.depth_codec import (
    B_BUCKETS, decode_depth, decode_depth_temporal)
from ros_gpu_depthmap_fusion_tpu.ops.unproject import unproject_depthmaps
from ros_gpu_depthmap_fusion_tpu.ops.flying_pixels import (
    filter_flying_pixels)
from ros_gpu_depthmap_fusion_tpu.ops.stencil import filter_point_sequence
from ros_gpu_depthmap_fusion_tpu.ops.mask_ops import crop_points, compact
from ros_gpu_depthmap_fusion_tpu.ops.voxel import (
    occupancy_bitmap, scatter_occupancy, update_historic_occupancy,
    occupancy_to_u8)
from ros_gpu_depthmap_fusion_tpu.ops.voxelize import (
    voxelize_average, voxelize_average_packed, voxelize_occupied)
from ros_gpu_depthmap_fusion_tpu.state import rollbuffer as rbmod
from ros_gpu_depthmap_fusion_tpu.state.rollbuffer import RollBuffer
from ros_gpu_depthmap_fusion_tpu.utils import native


class EngineState(NamedTuple):
    """Carried device state (the reference's persistent SSBOs)."""
    rollbuffer: RollBuffer
    historic_occupancy: jnp.ndarray   # [num_cells] int32
    frame_index: jnp.ndarray          # scalar int32
    # previous frame's quantized depth series (holes = 0) — the P-frame
    # prediction state of the temporal link codec. [C, H, W] u16 when
    # cfg.depth_link_codec == "dpcm_temporal", else a [1, 1, 1] stub.
    prev_depth_q: jnp.ndarray = jnp.zeros((1, 1, 1), jnp.uint16)


class SequenceBatch(NamedTuple):
    """Staged new point sequences for one frame (host -> device)."""
    points: jnp.ndarray      # [STAGE_CAP, 4]
    seq_idx: jnp.ndarray     # [STAGE_CAP] int32, 0-based within batch
    seq_sec: jnp.ndarray     # [SEQ_STAGE_CAP] int32
    seq_nsec: jnp.ndarray    # [SEQ_STAGE_CAP] int32
    seq_count: jnp.ndarray   # [SEQ_STAGE_CAP] int32
    seq_tf_move: jnp.ndarray  # [SEQ_STAGE_CAP, 4, 4]
    num_points: jnp.ndarray  # scalar int32
    num_seqs: jnp.ndarray    # scalar int32


class FrameInputs(NamedTuple):
    depth: jnp.ndarray        # [C, H, W] uint16
    intrinsics: jnp.ndarray   # [C, 4] (fx, fy, cx, cy)
    tf_world: jnp.ndarray     # [C, 4, 4] world <- camera
    tf_crop: jnp.ndarray      # [C, 4, 4] crop <- camera
    seq_batch: SequenceBatch
    tf_world_move: jnp.ndarray  # [4, 4] world <- move
    tf_crop_move: jnp.ndarray   # [4, 4] crop <- move
    now_sec: jnp.ndarray
    now_nsec: jnp.ndarray
    roll_min_sec: jnp.ndarray   # expiry threshold (now - timespan)
    roll_min_nsec: jnp.ndarray
    # runtime-reconfigurable filter scalars (the reference adjusts these
    # live via config topics, _component.cpp:970-990; shipping them as
    # frame inputs makes reconfig free — no re-jit). Defaults match the
    # FusionConfig defaults for constructors that build FrameInputs
    # directly.
    fp_threshold: jnp.ndarray = 0.5    # flying-pixel cos(view) threshold
    fp_max_distance: jnp.ndarray = 10.0
    ps_threshold: jnp.ndarray = 0.5    # point-sequence filter threshold


class FrameOutputs(NamedTuple):
    fused_points: jnp.ndarray   # [out_cap, 4] voxelized (or raw) world points
    fused_count: jnp.ndarray
    raw_points: jnp.ndarray     # [total_cap, 4] compacted world points
    raw_count: jnp.ndarray
    occupancy_u8: jnp.ndarray   # [num_cells] uint8 (historic, decayed)
    # binarized occupancy packed 8 cells/byte — the mapping consumer's
    # cheap d2h payload (ops.voxel.occupancy_bitmap)
    occupancy_bits: jnp.ndarray
    seq_selected_count: jnp.ndarray
    # sparse occupancy (cfg.occupancy_sparse_capacity > 0): the nonzero
    # 128-bit BLOCKS of occupancy_bits as (block index, 4 words) rows +
    # clamped count + true count (ops.voxel.occupancy_bitmap_sparse) —
    # the mapping consumer's d2h payload shrinks to 20 B per occupied
    # block. [1]-stubs when disabled.
    occupancy_sparse_idx: jnp.ndarray = jnp.zeros((1,), jnp.int32)
    occupancy_sparse_words: jnp.ndarray = jnp.zeros((1, 4), jnp.int32)
    occupancy_sparse_count: jnp.ndarray = jnp.int32(0)
    occupancy_sparse_true: jnp.ndarray = jnp.int32(0)


def initial_state(cfg: FusionConfig, grid: VoxelGrid) -> EngineState:
    prev_q_shape = ((cfg.num_depth_streams, cfg.depth_height,
                     cfg.depth_width)
                    if cfg.depth_link_codec == "dpcm_temporal"
                    else (1, 1, 1))
    return EngineState(
        rollbuffer=rbmod.make_rollbuffer(
            cfg.rollbuffer_point_capacity, cfg.rollbuffer_seq_capacity),
        historic_occupancy=jnp.zeros((grid.num_cells,), jnp.int32),
        frame_index=jnp.int32(0),
        prev_depth_q=jnp.zeros(prev_q_shape, jnp.uint16),
    )


def fusion_step(state: EngineState,
                inp: FrameInputs,
                depth_bits: Optional[int] = None,
                *,
                cfg: FusionConfig,
                grid: VoxelGrid,
                output_capacity: int):
    """One fused frame step (pure; jit over the static cfg/grid closure).

    ``depth_bits`` selects the static depth-link variant: ``None`` = raw
    ``[C, H, W]`` u16; ``B > 0`` = spatial I-frame at width B (``inp.depth``
    is an :class:`EncodedDepth`); ``-B`` = classic fixed-width P-frame;
    ``"p4"`` = sparse p4 P-frame (:class:`EncodedDepthP4`); a tuple =
    per-group widths of a heterogeneous rig."""
    c = cfg.num_depth_streams
    h, w = cfg.depth_height, cfg.depth_width
    n_depth = cfg.depthmaps_total_elements
    sel_cap = cfg.rollbuffer_point_capacity
    rb = state.rollbuffer
    sb = inp.seq_batch

    # -- 1. filter new point sequences (sensor frame; mask starts all-set
    #       over the staged extent, cpp:944-960) --
    stage_idx = jnp.arange(sb.points.shape[0], dtype=jnp.int32)
    staged_mask = stage_idx < sb.num_points
    seq_mask = filter_point_sequence(
        sb.points, staged_mask, sb.num_points,
        cfg.point_sequence_filter_size, inp.ps_threshold)

    # -- 2. insert into rollbuffer --
    rb, _overflow = rbmod.insert_sequences(
        rb, sb.points, seq_mask, sb.seq_idx, sb.seq_sec, sb.seq_nsec,
        sb.seq_count, sb.seq_tf_move, sb.num_points, sb.num_seqs)

    # -- 3. expire sequences older than (now - aggregation timespan) --
    rb = rbmod.roll(rb, inp.roll_min_sec, inp.roll_min_nsec)

    # -- 4. select the aggregation window [roll_min, now] --
    sel = rbmod.select_timespan(
        rb, inp.roll_min_sec, inp.roll_min_nsec, inp.now_sec, inp.now_nsec)

    # -- 5. gather + transform selection to world/crop --
    seq_world, seq_crop, seq_valid, _ = rbmod.gather_selection(
        rb, sel, inp.tf_world_move, inp.tf_crop_move, sel_cap)

    # -- 6/7. decode the depth link + unproject + flying-pixel filter,
    #    per resolution GROUP (one group for homogeneous rigs; a mixed
    #    D435+D455 rig processes each shape as its own batched chain —
    #    reference per-map cols/rows/depthScale dispatch,
    #    gpu_depthmap_fusion.cpp:798-816, :1612-1642).
    #    depth_bits > 0: spatial I-frame; depth_bits < 0: temporal P-frame
    #    at |bits| against state.prev_depth_q (dpcm_temporal only) --
    prev_depth_q = state.prev_depth_q
    groups = cfg.stream_groups
    hetero = len(groups) > 1
    if hetero:
        assert cfg.depth_link_codec != "dpcm_temporal", (
            "dpcm_temporal is not supported with heterogeneous stream "
            "shapes (per-group P-frame state is not plumbed)")
        scales = cfg.resolved_depth_scales
        bits_t = (depth_bits if depth_bits is not None
                  else (None,) * len(groups))
        g_world, g_crop, g_mask = [], [], []
        for gi, (ix, gh, gw) in enumerate(groups):
            ixa = np.asarray(ix, np.int32)   # static gather indices
            bits_g = bits_t[gi]
            if bits_g is None:
                depth_u16 = inp.depth[gi]
            else:
                depth_u16 = decode_depth(inp.depth[gi], gh, gw, bits_g,
                                         cfg.depth_codec_quant_shift)
            scale_g = jnp.asarray([scales[i] for i in ix], jnp.float32)
            pc_g, pw_g, pcr_g, dm_g = unproject_depthmaps(
                depth_u16, inp.intrinsics[ixa], inp.tf_world[ixa],
                inp.tf_crop[ixa], scale_g)
            if cfg.enable_flyingpixels_filter:
                dm_g = filter_flying_pixels(
                    pc_g, dm_g, gh, gw,
                    cfg.flyingpixels_filter_size, inp.fp_threshold,
                    cfg.flyingpixels_filter_enable_rot45,
                    inp.fp_max_distance)
            ng = len(ixa) * gh * gw
            g_world.append(pw_g.reshape(ng, 4))
            g_crop.append(pcr_g.reshape(ng, 4))
            g_mask.append(dm_g.reshape(ng))
    else:
        if depth_bits is None:
            depth_u16 = inp.depth
        elif depth_bits == "p4":
            # sparse P-frame (4-px-group flags + budgeted literals)
            from ros_gpu_depthmap_fusion_tpu.ops.depth_codec import (
                decode_depth_p4)
            depth_u16, prev_depth_q = decode_depth_p4(
                inp.depth, state.prev_depth_q, h, w,
                cfg.depth_codec_p4_budget, cfg.depth_codec_quant_shift)
        elif depth_bits > 0:
            if cfg.depth_link_codec == "dpcm_temporal":
                depth_u16, prev_depth_q = decode_depth(
                    inp.depth, h, w, depth_bits,
                    cfg.depth_codec_quant_shift, return_series=True)
            else:
                depth_u16 = decode_depth(inp.depth, h, w, depth_bits,
                                         cfg.depth_codec_quant_shift)
        else:
            depth_u16, prev_depth_q = decode_depth_temporal(
                inp.depth, state.prev_depth_q, h, w, -depth_bits,
                cfg.depth_codec_quant_shift)
        scale = (jnp.asarray(cfg.resolved_depth_scales, jnp.float32)
                 if cfg.depth_scales is not None else cfg.depth_scale)
        pts_cam, pts_world, pts_crop, dmask = unproject_depthmaps(
            depth_u16, inp.intrinsics, inp.tf_world, inp.tf_crop, scale)

        # -- 7. flying-pixel filter (camera frame) --
        if cfg.enable_flyingpixels_filter:
            dmask = filter_flying_pixels(
                pts_cam, dmask, h, w,
                cfg.flyingpixels_filter_size,
                inp.fp_threshold,
                cfg.flyingpixels_filter_enable_rot45,
                inp.fp_max_distance)
        g_world = [pts_world.reshape(n_depth, 4)]
        g_crop = [pts_crop.reshape(n_depth, 4)]
        g_mask = [dmask.reshape(n_depth)]

    emit_raw = cfg.emit_raw_points or not cfg.enable_voxel_filter
    total_cap = n_depth + sel_cap
    fresh = None
    # -- concatenate depth section(s) + rollbuffer selection section
    #    (the reference appends lidar after depth,
    #    m_depthmapsTotalElements)
    all_world = jnp.concatenate(g_world + [seq_world], axis=0)
    all_crop = jnp.concatenate(g_crop + [seq_crop], axis=0)
    all_mask = jnp.concatenate(g_mask + [seq_valid], axis=0)

    # -- 8. crop (crop-frame AABB) --
    all_mask = crop_points(all_crop, all_mask, cfg.crop_min, cfg.crop_max)

    # -- 8b. radius outlier filter (capability the reference stubs
    #        out; disabled by default to match its behavior) --
    if cfg.enable_radius_filter:
        from ros_gpu_depthmap_fusion_tpu.ops.radius import (
            filter_radius_outliers)
        all_mask = filter_radius_outliers(
            all_world, all_mask, cfg.radius_min, cfg.radius_max,
            cfg.radius_filter_radius)

    # -- 9. deterministic compaction of world points. The reference
    #       only materializes the cloud it publishes (voxelized when
    #       the voxel filter is on), so the raw compaction is
    #       skippable (cfg.emit_raw_points); voxelize sorts by cell
    #       id itself and is happy with the uncompacted masked array
    if emit_raw:
        raw_points, raw_count = compact(all_world, all_mask, total_cap)
        vox_points, vox_mask = raw_points, (
            jnp.arange(total_cap, dtype=jnp.int32) < raw_count)
    else:
        raw_count = jnp.minimum(jnp.sum(all_mask.astype(jnp.int32)),
                                jnp.int32(total_cap))
        raw_points = jnp.zeros((1, 4), all_world.dtype)
        vox_points, vox_mask = all_world, all_mask

    # -- 10. voxel coords + voxelize --
    cell_ids = grid.cell_index_clamped(vox_points[:, :3])
    live = vox_mask
    if cfg.enable_voxel_filter:
        if cfg.voxel_enable_average:
            vox_fn = (voxelize_average if cfg.voxel_mean_mode == "exact"
                      else voxelize_average_packed)
            fused_points, fused_count, fresh = vox_fn(
                vox_points, cell_ids, live, grid, output_capacity,
                return_occupancy=True)
        else:
            fresh = scatter_occupancy(cell_ids, live, grid.num_cells)
            fused_points, fused_count = voxelize_occupied(
                fresh, grid, output_capacity)
    else:
        fused_points, fused_count = raw_points, raw_count

    # -- 11. occupancy + temporal decay --
    if fresh is None:
        fresh = scatter_occupancy(cell_ids, live, grid.num_cells)
    historic = update_historic_occupancy(
        state.historic_occupancy, fresh, cfg.voxel_occupancy_lifetime)
    occupancy_u8 = (occupancy_to_u8(historic) if cfg.emit_occupancy_u8
                    else jnp.zeros((1,), jnp.uint8))

    new_state = EngineState(
        rollbuffer=rb,
        historic_occupancy=historic,
        frame_index=state.frame_index + 1,
        prev_depth_q=prev_depth_q,
    )
    sparse = {}
    if cfg.occupancy_sparse_capacity > 0:
        from ros_gpu_depthmap_fusion_tpu.ops.voxel import (
            occupancy_bitmap_sparse)
        si, sw, sc, st = occupancy_bitmap_sparse(
            historic, cfg.occupancy_sparse_capacity)
        sparse = dict(occupancy_sparse_idx=si, occupancy_sparse_words=sw,
                      occupancy_sparse_count=sc, occupancy_sparse_true=st)
    out = FrameOutputs(
        fused_points=fused_points, fused_count=fused_count,
        raw_points=raw_points, raw_count=raw_count,
        occupancy_u8=occupancy_u8,
        occupancy_bits=occupancy_bitmap(historic),
        seq_selected_count=sel.point_count,
        **sparse,
    )
    return new_state, out


def build_fusion_step(cfg: FusionConfig, grid: VoxelGrid,
                      output_capacity: Optional[int] = None,
                      donate: bool = True):
    """Jit-compile the per-frame step for a static config/grid."""
    if output_capacity is None:
        output_capacity = min(grid.num_cells, cfg.total_point_capacity,
                              cfg.voxelize_output_capacity)
    step = functools.partial(fusion_step, cfg=cfg, grid=grid,
                             output_capacity=output_capacity)
    return jax.jit(step, donate_argnums=(0,) if donate else (),
                   static_argnames=("depth_bits",))


def build_packet_step(cfg: FusionConfig, grid: VoxelGrid, layout,
                      output_capacity: Optional[int] = None,
                      donate: bool = True):
    """Jit the fused step over a single packed u32 frame buffer (one
    host->device transfer per frame; see :mod:`pipeline.packet`)."""
    from ros_gpu_depthmap_fusion_tpu.pipeline.packet import unpack_packet
    if output_capacity is None:
        output_capacity = min(grid.num_cells, cfg.total_point_capacity,
                              cfg.voxelize_output_capacity)

    def step(state, packet, depth_bits: Optional[int]):
        inp = unpack_packet(packet, layout, depth_bits)
        return fusion_step(state, inp, depth_bits, cfg=cfg, grid=grid,
                           output_capacity=output_capacity)

    return jax.jit(step, donate_argnums=(0,) if donate else (),
                   static_argnames=("depth_bits",))


def _quantize_into(depth: np.ndarray, quant_shift: int,
                   out: np.ndarray) -> None:
    """Encoder-side quantization into ``out`` (holes stay 0) — the
    P-frame prediction state after an I-frame."""
    if not quant_shift:
        np.copyto(out, depth)
        return
    qmax = 65535 >> quant_shift
    q = (depth.astype(np.int32) + (1 << (quant_shift - 1))) >> quant_shift
    np.clip(q, 1, qmax, out=q)
    np.copyto(out, np.where(depth == 0, 0, q).astype(np.uint16))


# ---------------------------------------------------------------------------
# Host orchestrator
# ---------------------------------------------------------------------------

class FusionEngine:
    """Host-side engine with the reference component's ingestion API:
    :meth:`add_depthmap` / :meth:`add_point_sequence` stage inputs (CPU),
    :meth:`process` runs the fused device step, and (optionally)
    segmentation + tracking.

    Mirrors GPUDepthmapFusion's clear/add/process lifecycle
    (gpu_depthmap_fusion.h:223-307) with functional device state.
    """

    def __init__(self, cfg: FusionConfig, grid: Optional[VoxelGrid] = None,
                 enable_mapping: bool = False, pipeline_depth: int = 0):
        from ros_gpu_depthmap_fusion_tpu.utils.compilation_cache import (
            enable_persistent_compilation_cache)
        from ros_gpu_depthmap_fusion_tpu.pipeline.packet import (
            HostPacket, PacketLayout)
        enable_persistent_compilation_cache()
        self.cfg = cfg
        self.grid = grid or VoxelGrid.from_config(cfg)
        self.state = initial_state(cfg, self.grid)
        self.enable_mapping = enable_mapping
        if enable_mapping:
            from ros_gpu_depthmap_fusion_tpu.mapping.pipeline import (
                MappingPipeline)
            self.mapping = MappingPipeline(cfg, self.grid)
        else:
            self.mapping = None
        self._stage_cap = cfg.max_points_per_sequence
        self._seq_stage_cap = max(1, cfg.num_point_sequences * 4)
        self.layout = PacketLayout.for_config(
            cfg, seq_cap=self._seq_stage_cap, stage_cap=self._stage_cap)
        self.step = build_packet_step(cfg, self.grid, self.layout)
        # two host packets alternate so frame k+1 stages while frame k's
        # transfer may still be in flight
        self._packets = (HostPacket(self.layout), HostPacket(self.layout))
        self._pkt_flip = 0
        c, h, w = cfg.num_depth_streams, cfg.depth_height, cfg.depth_width
        # double-buffered like the packets: the transfer worker encodes
        # frame k's depth while the main thread stages frame k+1
        self._hetero = cfg.is_heterogeneous
        if self._hetero:
            assert cfg.depth_link_codec != "dpcm_temporal", (
                "dpcm_temporal is not supported with heterogeneous "
                "stream shapes")
            # per-group staging buffers; slot -> (group, position)
            self._slot_map = {}
            for gi, (ix, gh, gw) in enumerate(cfg.stream_groups):
                for pos, slot in enumerate(ix):
                    self._slot_map[slot] = (gi, pos)
            self._depth_hosts = tuple(
                [np.zeros((len(ix), gh, gw), np.uint16)
                 for ix, gh, gw in cfg.stream_groups]
                for _ in range(2))
            # per-group spatial width guesses
            self._last_bits_g = [-1] * len(cfg.stream_groups)
            self._last_bits = None
        else:
            self._depth_hosts = (np.zeros((c, h, w), np.uint16),
                                 np.zeros((c, h, w), np.uint16))
            self._last_bits = -1  # spatial codec width guess (stable)
        self._depth_host = self._depth_hosts[0]
        self._last_p_bits = -1      # temporal width guess
        self.last_p4_spilled = 0    # p4 diagnostic: spilled groups
        self._last_frame_bits = None  # signed bits of the latest ENCODED frame
        # signed codec bits of the frame whose outputs the latest
        # process()/flush() call RETURNED (public; in pipelined mode the
        # encode worker's _last_frame_bits is one frame ahead and racy)
        self.last_frame_bits = None
        self._host_prev_q = None    # encoder-side P-frame prediction
        self._host_prev_q_spare = None
        self._frames_since_key = 0
        # live-reconfigurable filter scalars (shipped per frame in the
        # packet header; changing them costs nothing — parity with the
        # reference's config topics, _component.cpp:970-990)
        self.fp_threshold = cfg.flyingpixels_filter_threshold
        self.fp_max_distance = cfg.flyingpixels_max_distance
        self.ps_threshold = cfg.point_sequence_filter_threshold
        # Ingest pipelining (pipeline_depth=1): process(k) returns the
        # outputs of frame k-1 while frame k is encoded and copied to the
        # device on worker threads — one frame of latency so that host
        # encode and transfer overlap the device step (the reference pays
        # the same latency shape via its resample timer,
        # _component.cpp:74-90).
        self.pipeline_depth = int(pipeline_depth)
        self._xfer = None
        self._pending = None  # (future, depth_bits) of the frame in flight
        if self.pipeline_depth:
            import concurrent.futures
            # TWO pipeline stages: the encode of frame k+1 runs while
            # frame k's packet is copied to the device
            self._xfer = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="fusion-enc")
            self._put_pool = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="fusion-put")
        self.clear()

    def set_runtime_filters(self, fp_threshold=None, fp_max_distance=None,
                            ps_threshold=None):
        """Adjust filter scalars live — takes effect next frame with zero
        recompilation (filter size/rot45 stay trace-time static)."""
        if fp_threshold is not None:
            self.fp_threshold = float(fp_threshold)
        if fp_max_distance is not None:
            self.fp_max_distance = float(fp_max_distance)
        if ps_threshold is not None:
            self.ps_threshold = float(ps_threshold)

    # --- ingestion (reference addDepthmap / addPointSequence) ---
    def clear(self):
        # flip to the other host packet + depth buffer and reset per-frame
        # staging (reference clear(), gpu_depthmap_fusion.cpp:725-732 —
        # keeps the rollbuffer, drops per-frame inputs)
        self._pkt_flip ^= 1
        self._pkt = self._packets[self._pkt_flip]
        self._depth_host = self._depth_hosts[self._pkt_flip]
        self._depth_filled = [False] * self.cfg.num_depth_streams
        self._num_seqs = 0
        self._seq_fill = 0
        if self.layout.lidar_delta:
            self._pkt.lidar_exc_count = 0
            self._pkt.lidar_dropped = 0

    def add_depthmap(self, slot: int, depth_u16: np.ndarray,
                     intrinsics, tf_world: np.ndarray,
                     tf_crop: np.ndarray):
        if self._hetero:
            gi, pos = self._slot_map[slot]
            np.copyto(self._depth_host[gi][pos], depth_u16,
                      casting="same_kind")
        else:
            np.copyto(self._depth_host[slot], depth_u16,
                      casting="same_kind")
        self._depth_filled[slot] = True
        self._pkt.intr[slot] = np.asarray(
            intrinsics.as_array() if hasattr(intrinsics, "as_array")
            else intrinsics, np.float32)
        self._pkt.tf_world[slot] = tf_world
        self._pkt.tf_crop[slot] = tf_crop

    def add_point_sequence(self, points_xyz: np.ndarray, sec: int, nsec: int,
                           tf_move: np.ndarray):
        """Stage one lidar packet (reference addPointSequence,
        gpu_depthmap_fusion.cpp:747-796: copy xyz with w=1 into staging +
        append a PointSequence record). Overflowing points are dropped."""
        n = min(len(points_xyz), self._stage_cap - self._seq_fill)
        if n <= 0 or self._num_seqs >= self._seq_stage_cap:
            return
        pkt = self._pkt
        qs = self.layout.seq_quant_step
        if self.layout.lidar_delta:
            # delta-coded staging (core/config.py lidar_link_delta):
            # 3x4-bit zigzag deltas in one u16/point, raw first point per
            # sequence, wide deltas on the exception list; sequences are
            # TRUNCATED at the first point whose exceptions no longer fit
            # the budget (explicit drop policy, counted)
            q = np.clip(np.rint(
                np.asarray(points_xyz[:n], np.float32)[:, :3] / qs
                + 32768.0), 0, 65535).astype(np.int32)
            d = np.zeros((n, 3), np.int32)
            if n > 1:
                d[1:] = np.diff(q, axis=0)
            wide = np.abs(d) > 7
            fill = pkt.lidar_exc_count
            cap = self.layout.lidar_exc_cap
            cum = np.cumsum(wide.sum(axis=1))
            over = fill + cum > cap
            if over.any():
                n_new = int(np.argmax(over))
                pkt.lidar_dropped += n - n_new
                if n_new <= 0:
                    return
                n, q, d, wide = n_new, q[:n_new], d[:n_new], wide[:n_new]
            sl = slice(self._seq_fill, self._seq_fill + n)
            zz = np.where(d >= 0, d << 1, ((-d) << 1) - 1)
            codes = np.where(wide, 0, zz).astype(np.uint16)
            pkt.seq_points_d[sl] = (codes[:, 0] | (codes[:, 1] << 4)
                                    | (codes[:, 2] << 8))
            pkt.seq_first[self._num_seqs] = q[0].astype(np.uint16)
            ri, ci = np.nonzero(wide)
            ne = len(ri)
            if ne:
                gi = (self._seq_fill + ri) * 3 + ci
                pkt.lidar_exc_idx[fill:fill + ne] = gi.astype(np.uint32)
                pkt.lidar_exc_zz[fill:fill + ne] = \
                    zz[ri, ci].astype(np.uint32)
                pkt.lidar_exc_count = fill + ne
            i = self._num_seqs
            pkt.seq_sec[i], pkt.seq_nsec[i], pkt.seq_count[i] = \
                sec, nsec, n
            pkt.seq_tf[i] = np.asarray(tf_move, np.float32)
            self._num_seqs += 1
            self._seq_fill += n
            return
        sl = slice(self._seq_fill, self._seq_fill + n)
        if qs:
            # 3 x u16 link quantization (error <= qs/2, span +-32768*qs)
            q = np.asarray(points_xyz[:n], np.float32)[:, :3] / qs + 32768.0
            np.clip(np.rint(q), 0, 65535, out=q)
            pkt.seq_points_q[sl] = q.astype(np.uint16)
        else:
            native.stage_points_xyz(np.asarray(points_xyz[:n], np.float32),
                                    pkt.seq_points[sl])
        i = self._num_seqs
        pkt.seq_sec[i], pkt.seq_nsec[i], pkt.seq_count[i] = sec, nsec, n
        pkt.seq_tf[i] = np.asarray(tf_move, np.float32)
        self._num_seqs += 1
        self._seq_fill += n

    # --- the frame step ---
    def process(self, now_seconds: float,
                tf_world_move: Optional[np.ndarray] = None,
                tf_crop_move: Optional[np.ndarray] = None) -> FrameOutputs:
        now_ns = timeutil.from_seconds(now_seconds)
        now_sec, now_nsec = timeutil.decode(now_ns)
        min_ns = now_ns - timeutil.from_seconds(
            self.cfg.point_sequence_aggregation_timespan)
        min_sec, min_nsec = timeutil.decode(max(min_ns, 0))
        eye = np.eye(4, dtype=np.float32)
        pkt = self._pkt
        for slot, filled in enumerate(self._depth_filled):
            if not filled:
                if self._hetero:
                    gi, pos = self._slot_map[slot]
                    self._depth_host[gi][pos] = 0
                else:
                    self._depth_host[slot] = 0
        pkt.tf_world_move[:] = (eye if tf_world_move is None
                                else tf_world_move)
        pkt.tf_crop_move[:] = eye if tf_crop_move is None else tf_crop_move
        scalars = (now_sec, now_nsec, min_sec, min_nsec,
                   self._seq_fill, self._num_seqs,
                   self.fp_threshold, self.fp_max_distance,
                   self.ps_threshold)
        if self.pipeline_depth:
            # resolve the in-flight transfer of frame k-1, hand frame k's
            # encode + transfer to the workers (off the main thread they
            # overlap the step dispatch), then dispatch step k-1. The
            # staging buffers are double-buffered (packet AND depth host
            # array), so the worker reads stable frame-k bytes while the
            # main thread stages frame k+1; the future completes before
            # frame k+2's staging can touch frame k's buffers.
            prev = self._pending
            enc_fut = self._xfer.submit(
                self._encode, pkt, self._depth_host, scalars)
            self._pending = self._put_pool.submit(self._put, enc_fut)
            self.clear()
            if prev is None:
                return None
            inp, prev_bits = prev.result()
            self.last_frame_bits = prev_bits
            self.state, out = self.step(self.state, inp,
                                        depth_bits=prev_bits)
            return out
        inp, depth_bits = self._encode_and_put(pkt, self._depth_host,
                                               scalars)
        self.last_frame_bits = depth_bits
        self.state, out = self.step(self.state, inp, depth_bits=depth_bits)
        self.clear()
        return out

    def _put(self, enc_fut):
        """Stage 2: snapshot + device_put of an encoded packet (runs on
        the put worker; blocks on its frame's encode, while the NEXT
        frame's encode proceeds on the encode worker)."""
        view, depth_bits = enc_fut.result()
        self._last_frame_bits = depth_bits
        return jax.device_put(np.array(view)), depth_bits

    def _encode_and_put(self, pkt, depth_host, scalars):
        """Synchronous encode + put (the non-pipelined path).

        The np.array snapshot before device_put is required for
        correctness, not just pipelining: device_put may zero-copy a numpy
        buffer (CPU backend) or read it during an in-flight DMA, while
        this packet is restaged two frames later — without the copy the
        step can observe frame k+2 bytes (real flake caught by
        test_engine_pipelined_matches_sync)."""
        view, depth_bits = self._encode(pkt, depth_host, scalars)
        self._last_frame_bits = depth_bits
        return jax.device_put(np.array(view)), depth_bits

    def _encode_hetero(self, pkt, depth_hosts, scalars):
        """Per-group depth-link encode (heterogeneous rigs): each
        resolution group codes its own DPCM section at its own width;
        the packet's tail is the concatenation of the group segments and
        ``depth_bits`` becomes a per-group tuple (static per jit
        variant)."""
        cfg = self.cfg
        lo = self.layout
        bits_list = []
        tail_off = exc_off = row_off = 0
        for gi, (cg, gh, gw) in enumerate(lo.groups):
            d_g = depth_hosts[gi]
            cap_g = lo.group_exc_caps[gi]
            exc_count_g = 0
            bits_g = None
            if cfg.depth_link_codec == "dpcm":
                out_g = dict(
                    words=pkt.tail[tail_off:],
                    row_first=pkt.row_first[row_off:row_off + cg * gh],
                    exc_idx=pkt.exc_idx[exc_off:exc_off + cap_g],
                    exc_zz=pkt.exc_zz[exc_off:exc_off + cap_g])
                encoded = native.depth_encode(
                    d_g, cap_g, allowed_bits=B_BUCKETS, out=out_g,
                    guess_bits=self._last_bits_g[gi],
                    quant_shift=cfg.depth_codec_quant_shift)
                if encoded is not None:
                    enc, bits_g = encoded
                    exc_count_g = int(enc["exc_count"])
                    self._last_bits_g[gi] = bits_g
            if bits_g is None:  # raw u16 pairs for this group
                flat = d_g.reshape(-1)
                n_pairs = flat.size // 2
                seg = pkt.tail[tail_off:]
                seg[:n_pairs] = flat[: n_pairs * 2].view(np.uint32)
                if flat.size % 2:
                    seg[n_pairs] = np.uint32(flat[-1])
            pkt.buf[lo.off_gmeta + gi] = np.uint32(exc_count_g)
            bits_list.append(bits_g)
            tail_off += lo.group_tail_words(gi, bits_g)
            exc_off += cap_g
            row_off += cg * gh
        bits = tuple(bits_list)
        pkt.set_scalars(0, *scalars)
        return pkt.view(bits), bits

    def _encode(self, pkt, depth_host, scalars):
        """Stage 1: depth-link encode into the packet tail; returns the
        packet view + signed bit width."""
        if self._hetero:
            return self._encode_hetero(pkt, depth_host, scalars)
        depth_bits, exc_count = None, 0
        cfg = self.cfg
        pkt_out = dict(words=pkt.tail, row_first=pkt.row_first,
                       exc_idx=pkt.exc_idx, exc_zz=pkt.exc_zz)
        if cfg.depth_link_codec == "dpcm_temporal":
            # P-frame against the previous quantized series, with I-frame
            # keyframes every depth_codec_keyframe_interval frames and
            # automatic I fallback when the P-encoder rejects (residuals
            # or hole churn blow the exception budget) or codes wider
            # than the scene's spatial width.
            keyframe = (self._host_prev_q is None
                        or self._frames_since_key
                        >= cfg.depth_codec_keyframe_interval)
            res = None
            res4 = None
            if not keyframe and cfg.depth_codec_p4_budget > 0:
                # sparse p4 P-frame (always smaller than any I-frame —
                # no width comparison; exception overflow -> I fallback)
                res4 = native.depth_encode_p4(
                    depth_host, self._host_prev_q,
                    cfg.depth_codec_p4_budget,
                    cfg.depth_codec_max_exceptions,
                    out=dict(flags=pkt.p4_flags, lits=pkt.p4_lits,
                             exc_idx=pkt.exc_idx, exc_zz=pkt.exc_zz),
                    quant_shift=cfg.depth_codec_quant_shift,
                    hysteresis=cfg.depth_codec_hysteresis,
                    curr_q_out=self._host_prev_q_spare)
            elif not keyframe:
                res = native.depth_encode_temporal(
                    depth_host, self._host_prev_q,
                    cfg.depth_codec_max_exceptions, allowed_bits=B_BUCKETS,
                    out=pkt_out, guess_bits=self._last_p_bits,
                    quant_shift=cfg.depth_codec_quant_shift,
                    curr_q_out=self._host_prev_q_spare)
                if res is not None and self._last_bits > 0 \
                        and res[1] >= self._last_bits:
                    # not STRICTLY narrower than the last spatial width:
                    # a P-frame buys nothing (same bucket = same bytes)
                    # and risks staying wide when the scene's spatial
                    # width would have adapted down — fall back
                    res = None
            if res4 is not None:
                enc4, curr_q = res4
                exc_count = int(enc4["exc_count"])
                self.last_p4_spilled = enc4["spilled"]
                depth_bits = "p4"
                self._frames_since_key += 1
                self._host_prev_q_spare = self._host_prev_q
                self._host_prev_q = curr_q
            elif res is not None:
                enc, p_bits, curr_q = res
                exc_count = int(enc["exc_count"])
                self._last_p_bits = p_bits
                depth_bits = -p_bits
                self._frames_since_key += 1
                self._host_prev_q_spare = self._host_prev_q
                self._host_prev_q = curr_q
            else:
                encoded = native.depth_encode(
                    depth_host, cfg.depth_codec_max_exceptions,
                    allowed_bits=B_BUCKETS, out=pkt_out,
                    guess_bits=max(self._last_bits, -1),
                    quant_shift=cfg.depth_codec_quant_shift)
                if encoded is not None:
                    enc, depth_bits = encoded
                    exc_count = int(enc["exc_count"])
                    self._last_bits = depth_bits
                    self._frames_since_key = 0
                    # prediction state = the encoder's quantized series
                    if self._host_prev_q is None:
                        c2, h2, w2 = depth_host.shape
                        self._host_prev_q = np.empty((c2, h2, w2),
                                                     np.uint16)
                        self._host_prev_q_spare = np.empty(
                            (c2, h2, w2), np.uint16)
                    _quantize_into(depth_host,
                                   cfg.depth_codec_quant_shift,
                                   self._host_prev_q)
        elif cfg.depth_link_codec == "dpcm":
            encoded = native.depth_encode(
                depth_host, cfg.depth_codec_max_exceptions,
                allowed_bits=B_BUCKETS, out=pkt_out,
                guess_bits=self._last_bits,
                quant_shift=cfg.depth_codec_quant_shift)
            if encoded is not None:
                enc, depth_bits = encoded
                exc_count = int(enc["exc_count"])
                self._last_bits = depth_bits
        if depth_bits is None:  # raw u16 pairs in the tail
            flat = depth_host.reshape(-1)
            n_pairs = flat.size // 2
            pkt.tail[:n_pairs] = flat[: n_pairs * 2].view(np.uint32)
            if flat.size % 2:
                pkt.tail[n_pairs] = np.uint32(flat[-1])
        pkt.set_scalars(exc_count, *scalars)
        return pkt.view(depth_bits), depth_bits

    def flush(self) -> Optional[FrameOutputs]:
        """Drain the in-flight frame (pipelined mode): dispatch and return
        the last submitted frame's outputs, or None if nothing pending."""
        if self._pending is None:
            return None
        fut = self._pending
        self._pending = None
        inp, bits = fut.result()
        self.last_frame_bits = bits
        self.state, out = self.step(self.state, inp, depth_bits=bits)
        return out

    def segment_and_track(self, out: FrameOutputs):
        """Run object segmentation + tracking on the latest occupancy grid
        (reference objectSegmentation + objectTracking)."""
        if self.mapping is None:
            raise RuntimeError("engine constructed with enable_mapping=False")
        return self.mapping.process(out.occupancy_u8, self.cfg.tracking_dt)
