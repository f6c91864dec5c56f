"""Engine configuration.

One dataclass with the same semantic fields (and defaults) as the reference's
ROS parameter set (``src/gpu_depthmap_fusion_component.cpp:1115-1187``) plus
the launch-file operating points (``launch/gpu_depthmap_fusion.launch``), and
the capacity/sharding knobs that replace the reference's dynamically grown
SSBOs (static XLA shapes require explicit capacities).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


VOXEL_MEAN_MODES = ("auto", "packed", "exact")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """All engine parameters.

    Field names follow the reference ROS params where a direct analog exists;
    reference defaults are kept so a reference launch file maps 1:1.
    """

    # --- input streams (reference: num_maps / num_seqs) ---
    num_depth_streams: int = 1          # up to 6 in the reference sync policy
    num_point_sequences: int = 0        # lidar "point sequence" streams
    depth_height: int = 480
    depth_width: int = 848              # RealSense D4xx default shape
    depth_scale: float = 0.001          # u16 depth unit -> meters

    # --- heterogeneous streams (reference addDepthmap takes per-map
    # cols/rows/depthScale, gpu_depthmap_fusion.cpp:798-816, and dispatches
    # per-map shapes, :1612-1642 — a mixed D435+D455 rig) ---
    # per-stream (height, width); None = all streams share
    # (depth_height, depth_width). Streams with equal shapes are processed
    # as one batched group; distinct shapes become separate static groups
    # whose points are concatenated before voxelize (exact — integer
    # partial sums commute, so section order cannot change results).
    stream_shapes: "Tuple[Tuple[int, int], ...] | None" = None
    # per-stream depth unit -> meters; None = all streams use depth_scale
    depth_scales: "Tuple[float, ...] | None" = None

    # --- frames (kept for dataset/TF bookkeeping on host) ---
    world_frame: str = "world"
    crop_frame: str = "crop"
    move_frame: str = "move"
    obj_export_frame: str = "world"

    # --- processing rate ---
    resample_rate: float = 30.0         # Hz; launch default 30 (launch:29-32)
    tracking_dt: float = 1.0 / 30.0     # fixed dt (gpu_depthmap_fusion.cpp:2730)

    # --- crop AABB (crop-frame axis aligned box; crop_points.glsl:56-58) ---
    crop_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    crop_max: Tuple[float, float, float] = (+1.0, +1.0, +1.0)

    # --- flying-pixel filter (filter_flying_pixels.glsl) ---
    enable_flyingpixels_filter: bool = True
    flyingpixels_filter_threshold: float = 0.5   # cos(view angle) threshold
    flyingpixels_filter_size: int = 1            # rings i=1..size
    flyingpixels_filter_enable_rot45: bool = True
    flyingpixels_max_distance: float = 10.0      # glsl:41 uniform default

    # --- point-sequence (lidar) filter (filter_point_sequence.glsl) ---
    point_sequence_filter_threshold: float = 0.5
    point_sequence_filter_size: int = 1
    point_sequence_aggregation_timespan: float = 0.1  # seconds

    # --- voxel filter / grid (compute_voxel_coords.glsl + GridMeta) ---
    enable_voxel_filter: bool = True
    voxel_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    voxel_max: Tuple[float, float, float] = (+1.0, +1.0, +1.0)
    voxel_size: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    voxel_enable_average: bool = True   # average-mode vs occupied-cell-centers
    # Average-mode implementation:
    # - "packed": per-cell means via a 2-operand full-capacity sort with
    #   cell-relative 10/10/12-bit quantized coordinates (error <=
    #   cell/2048 per axis, ~0.05 mm at deployment grids).
    # - "exact": bit-exact f32 means via a 4-operand sort.
    # - "auto" (default): "packed".
    voxel_mean_mode: str = "auto"
    voxel_occupancy_lifetime: int = 1   # frames; launch default 10
    # static cap on emitted voxelized points (= max simultaneously occupied
    # cells; overflow drops cells and caps the count — explicit policy
    # where the reference grew buffers silently). 256k cells is ~8% of the
    # largest deployment grid. The occupancy scatter-max and output
    # compaction scale with this CAP, not the live cell count, so size it
    # to the deployment's occupancy with headroom;
    # FrameOutputs.fused_count vs this cap is the overflow observable.
    voxelize_output_capacity: int = 262144

    # --- host->device depth link ---
    # "dpcm" (default): lossless masked row-DPCM compression of the depth
    # upload, decoded on device (ops/depth_codec.py). "dpcm_temporal":
    # adds P-frames coding
    # zigzag(curr_q - prev_q) against the previous frame (kept on device
    # in EngineState) with automatic I-frame fallback when residuals or
    # hole churn blow the exception budget, and periodic I keyframes for
    # resync; stable real streams code 1-2 bits narrower. "none": raw u16.
    depth_link_codec: str = "dpcm"
    depth_codec_keyframe_interval: int = 30
    depth_codec_max_exceptions: int = 8192
    # p4 P-frames (dpcm_temporal only): with budget L > 0, P-frames use
    # the sparse 4-pixel-group format — 1 flag bit per group + up to L/2
    # 16-bit group literals per row of 4-bit zigzag codes (deltas to +-7
    # bins in-stream + new-hole; wider deltas, revivals and over-budget
    # spills ride the exception list; automatic I fallback on exception
    # overflow). On realistic 30 Hz streams (static background + fixed
    # pattern noise) this codes ~1 bit/px instead of the fixed >= 2;
    # decode looks each group's literal up with an exact integer gather
    # (ops/depth_codec.py).
    # L must be a multiple of 4. 0 = classic fixed-width P-frames.
    depth_codec_p4_budget: int = 0
    # hysteresis quantization for p4 (raw depth units): a valid pixel
    # keeps its previous bin while |raw - dequant(prev)| <=
    # 2**(shift-1) + hysteresis — error bound rises to q/2 + hysteresis
    # but fresh-noise bin flips (the dominant P-frame payload) drop
    # ~5x at hysteresis ~= 2 sigma_noise.
    depth_codec_hysteresis: int = 0
    # bounded-loss link quantization: nonzero depths are rounded to
    # multiples of 2**shift before the DPCM (error <= 2**(shift-1) depth
    # units, e.g. <= 2 mm at shift 2 with mm depth — below sensor noise at
    # range and ~2 orders below deployment voxel sizes) and the deltas
    # shrink by the same factor, typically dropping the code width by
    # ~shift bits. 0 (default) = lossless bit-exact round trip.
    depth_codec_quant_shift: int = 0
    # lidar-link quantization: with step s > 0, staged sequence points ride
    # the packet as 3 x u16 (6 bytes/point instead of 16) quantized to
    # multiples of s over [-32768*s, +32767*s) — at the 2 mm default-ish
    # step that spans +-65 m with error <= 1 mm, an order below lidar
    # range noise. 0 (default) = lossless f32 xyzw staging.
    lidar_link_quant_step: float = 0.0
    # delta-code the quantized lidar staging (requires quant_step > 0):
    # per-point per-component 4-bit zigzag deltas in quant steps packed
    # one u16/point (vs 3 u16), per-sequence raw first points, wider
    # deltas on a small exception list — 3x fewer lidar link bytes,
    # BIT-EXACT vs plain u16 staging (lossless in the quantized series).
    # Decode: shift-unpack, exception scatter, two-level cumsum,
    # per-sequence rebase via a [stage_cap, seq_cap] one-hot matvec at
    # HIGHEST precision. Sequences whose deltas overflow the exception
    # budget are TRUNCATED at the first uncovered point (explicit drop
    # policy like the stage-capacity drop; HostPacket.lidar_dropped
    # counts them).
    lidar_link_delta: bool = False

    # also emit the compacted raw (pre-voxelize) cloud every frame. The
    # reference only builds the cloud it publishes, so pipelines that
    # consume the voxelized output can turn this off and skip a 2.5M-row
    # compaction per frame.
    emit_raw_points: bool = True

    # --- segmentation / tracking ---
    # "auto": host (native C++, reference-parity architecture) when the
    # native library is available, else the on-device XLA program.
    segmentation_backend: str = "auto"   # "auto" | "host" | "device"
    object_min_area: float = 0.2 * 0.2  # m^2 in topview
    cc_max_labels_per_layer: int = 256  # static cap for per-layer CC labels
    max_objects: int = 64               # static cap for extracted objects
    # detail pruning for the host assembly: objects whose world-xy AABB
    # area is below this get stats-only stubs (no contours/hulls/shapes).
    # Sound for the TRACKING consumer: min-area-rect area <= AABB area, so
    # every pruned object is below object_min_area and tracking skips it
    # anyway (cpp:2776-2777) — but viz/downstream consumers of
    # MappingResult would lose sub-threshold contours, so the DEFAULT is
    # 0 = build full detail for everything (reference behavior).
    # -1 = prune below object_min_area (opt-in where the cycle budget is
    # measured, e.g. bench.py's mapping loop).
    mapping_detail_min_area: float = 0.0
    max_tracks: int = 128               # static cap for live tracks
    # emit the dense [num_cells] u8 historic occupancy in FrameOutputs
    # (reference uints_to_chars download payload). The mapping consumers
    # use the packed bitmap / sparse words instead; disabling this saves
    # one full-grid u8 materialization per frame.
    # FrameOutputs.occupancy_u8 is a [1]-stub when off.
    emit_occupancy_u8: bool = True
    # sparse occupancy output for the mapping d2h: the fused step emits
    # the NONZERO 128-bit BLOCKS (4 u32 words) of the packed occupancy
    # bitmap as (block_index, words) rows capped here — at the
    # deployment grid the bitmap is ~420 KB of which ~99% is zeros, so
    # the mapping consumer's per-cycle transfer drops ~5-20x
    # (FrameOutputs.occupancy_sparse_*; count > capacity is the overflow
    # observable and the consumer falls back to the dense bitmap).
    # 0 = disabled (dense bitmap only).
    occupancy_sparse_capacity: int = 0

    # --- radius filter: params exist in the reference but the filter is
    # unimplemented there (component.cpp:414-421); kept for config parity ---
    enable_radius_filter: bool = False
    radius_filter_radius: float = 0.1
    radius_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    radius_max: Tuple[float, float, float] = (+1.0, +1.0, +1.0)

    # --- capacities (replace the reference's grow-only SSBO resizing;
    # XLA needs static shapes, overflow is explicit: excess points dropped
    # with their mask cleared) ---
    rollbuffer_point_capacity: int = 131072   # ref practical cap ~100k pts
    rollbuffer_seq_capacity: int = 1024       # max live sequences in window
    max_points_per_sequence: int = 32768      # staging cap per lidar packet

    # --- misc ---
    enable_debug_output: bool = False
    dtype: str = "float32"              # compute dtype for point math

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.voxel_mean_mode not in VOXEL_MEAN_MODES:
            raise ValueError(
                f"voxel_mean_mode={self.voxel_mean_mode!r} is not one of "
                f"{VOXEL_MEAN_MODES}")

    @property
    def depth_pixels_per_stream(self) -> int:
        return self.depth_height * self.depth_width

    @property
    def resolved_stream_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Per-stream (height, width), defaulting to the global shape."""
        if self.stream_shapes is None:
            return ((self.depth_height, self.depth_width),) \
                * self.num_depth_streams
        assert len(self.stream_shapes) == self.num_depth_streams, \
            (len(self.stream_shapes), self.num_depth_streams)
        return tuple((int(h), int(w)) for h, w in self.stream_shapes)

    @property
    def resolved_depth_scales(self) -> Tuple[float, ...]:
        """Per-stream depth unit -> meters, defaulting to depth_scale."""
        if self.depth_scales is None:
            return (self.depth_scale,) * self.num_depth_streams
        assert len(self.depth_scales) == self.num_depth_streams
        return tuple(float(s) for s in self.depth_scales)

    @property
    def is_heterogeneous(self) -> bool:
        return (self.stream_shapes is not None
                and len(set(self.stream_shapes)) > 1)

    @property
    def stream_groups(self) -> Tuple[Tuple[Tuple[int, ...], int, int], ...]:
        """Streams grouped by shared (h, w), first-seen order:
        ``((stream_indices, h, w), ...)``. One group for homogeneous rigs."""
        groups: list = []
        by_shape: dict = {}
        for i, (h, w) in enumerate(self.resolved_stream_shapes):
            if (h, w) not in by_shape:
                by_shape[(h, w)] = len(groups)
                groups.append(([i], h, w))
            else:
                groups[by_shape[(h, w)]][0].append(i)
        return tuple((tuple(ix), h, w) for ix, h, w in groups)

    @property
    def depthmaps_total_elements(self) -> int:
        """Total depth-derived point slots (ref: m_depthmapsTotalElements)."""
        return sum(h * w for h, w in self.resolved_stream_shapes)

    @property
    def total_point_capacity(self) -> int:
        """Depth points + rollbuffer selection capacity (ref: m_numPointsTotal
        upper bound, gpu_depthmap_fusion.cpp:1500)."""
        return self.depthmaps_total_elements + self.rollbuffer_point_capacity

    def replace(self, **kw) -> "FusionConfig":
        return dataclasses.replace(self, **kw)


# Launch-file deployment presets (launch/gpu_depthmap_fusion.launch:144-181).
PRESET_HAFEN = FusionConfig(
    num_depth_streams=6,
    voxel_min=(-20.0, -20.0, 0.0),
    voxel_max=(+20.0, +20.0, 2.5),
    voxel_size=(0.1, 0.1, 0.12),      # 400 x 400 x 21 ~ 3.4M cells
    crop_min=(-20.0, -20.0, 0.0),
    crop_max=(+20.0, +20.0, 2.5),
    voxel_occupancy_lifetime=10,
)

PRESET_OFFICE = FusionConfig(
    num_depth_streams=2,
    voxel_min=(-4.0, -4.0, 0.0),
    voxel_max=(+4.0, +4.0, 2.5),
    voxel_size=(0.1, 0.1, 0.1),
    crop_min=(-4.0, -4.0, 0.0),
    crop_max=(+4.0, +4.0, 2.5),
    voxel_occupancy_lifetime=10,
)
