"""Mapping pipeline: occupancy grid -> segmented objects -> tracks.

Drives the device segmentation program (:mod:`.segmentation`, one jitted
call per frame) and the small-N host stages (object assembly, tracking),
mirroring the reference's objectSegmentation() + objectTracking() tail
(``gpu_depthmap_fusion.cpp:2552-2944``; SURVEY.md §3.4).
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid
from ros_gpu_depthmap_fusion_tpu.mapping.segmentation import segment
from ros_gpu_depthmap_fusion_tpu.mapping.objects import (
    CCObject, build_objects)
from ros_gpu_depthmap_fusion_tpu.mapping.tracking import (
    CCObjectTrack, TrackingStats, track_objects)


class MappingResult(NamedTuple):
    objects: List[CCObject]
    tracks: List[CCObjectTrack]
    stats: TrackingStats
    num_merged: int


class MappingPipeline:
    """Stateful (tracks persist across frames) mapping driver.

    Two segmentation backends (``cfg.segmentation_backend``):

    - ``"device"`` — the jitted XLA program (:mod:`.segmentation`); results
      come back in ONE batched ``jax.device_get`` with labels narrowed to
      u16 (sequential per-array fetches pay a link round-trip each).
    - ``"host"`` — the native C++ path (``fh_segment_grid``), mirroring the
      reference's production CPU-CC architecture
      (gpu_depthmap_fusion.cpp:1872-2361): only the (small) occupancy grid
      crosses the link. Bit-exact with the device program (tested).
    - ``"auto"`` (default) — host when the native library is present.
    """

    def __init__(self, cfg: FusionConfig, grid: VoxelGrid):
        self.cfg = cfg
        self.grid = grid
        self.tracks: List[CCObjectTrack] = []

        # segmentation only consumes occupancy > 0 (both backends binarize),
        # so the host path ships a BITMAP: 1 bit/cell instead of 1 byte —
        # 8x fewer bytes over the d2h link (420 KB vs 3.4 MB at the largest
        # deployment grid). Packing runs on device; numpy unpacks.
        n = grid.num_cells

        def _pack_bits(occ_u8):
            m = -(-n // 8) * 8
            bits = jnp.pad((occ_u8[:n] > 0).astype(jnp.uint8),
                           (0, m - n)).reshape(-1, 8)
            w = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
            return jnp.sum(bits * w, axis=-1, dtype=jnp.uint8)

        self._pack_bits = jax.jit(_pack_bits)

        def _segment_u16(occ):
            seg = segment(occ, max_labels=cfg.cc_max_labels_per_layer,
                          max_objects=cfg.max_objects)
            return seg._replace(labels=seg.labels.astype(jnp.uint16))

        self._segment = jax.jit(_segment_u16)
        backend = getattr(cfg, "segmentation_backend", "auto")
        if backend == "auto":
            from ros_gpu_depthmap_fusion_tpu.utils import native
            backend = "host" if native.available() else "device"
        self.backend = backend

    def _segment_host(self, occ: np.ndarray) -> dict:
        from ros_gpu_depthmap_fusion_tpu.utils import native
        # the host backend has no static-shape constraint, so stats cover
        # EVERY merged id (the device program clamps ids to max_objects-1,
        # which under heavy clutter both loses stats for late real objects
        # and pollutes the last slot); Z*max_labels bounds the id space
        host_cap = max(self.cfg.max_objects,
                       occ.shape[0] * self.cfg.cc_max_labels_per_layer)
        res = native.segment_grid(occ, self.cfg.cc_max_labels_per_layer,
                                  host_cap)
        if res is None:  # no native library: fall back to device
            seg = jax.device_get(self._segment(jnp.asarray(occ)))
            res = dict(labels=seg.labels, num_labels=seg.num_labels,
                       merged_of_label=seg.merged_of_label,
                       num_merged=int(seg.num_merged),
                       voxel_count=seg.voxel_count, centroid=seg.centroid,
                       vmin=seg.vmin, vmax=seg.vmax)
        return res

    def _detail_mask(self, res: dict) -> Optional[np.ndarray]:
        """Detail-pruning mask: objects whose world-xy AABB area is below
        the threshold get stats-only stubs. Sound for the tracking
        consumer: the topview min-area rect is contained in the AABB, so
        its area is <= the AABB area and every pruned object fails the
        ``object_min_area`` gate (cpp:2776-2777) regardless."""
        thr = self.cfg.mapping_detail_min_area
        if thr < 0:
            thr = self.cfg.object_min_area
        if thr <= 0:
            return None
        nm = int(res["num_merged"])
        vmin, vmax = np.asarray(res["vmin"]), np.asarray(res["vmax"])
        n = min(nm, len(vmin))
        cs = np.asarray(self.grid.cell_size, np.float64)
        ext = (vmax[:n] - vmin[:n] + 1).astype(np.float64)
        area = ext[:, 0] * cs[0] * ext[:, 1] * cs[1]
        mask = np.zeros(nm, bool)
        mask[:n] = (area >= thr) & (np.asarray(
            res["voxel_count"])[:n] > 0)
        return mask

    def fetch_occupancy(self, occupancy_u8: jnp.ndarray) -> np.ndarray:
        """Device->host transfer of the binarized occupancy as a bitmap
        (the link is the mapping cycle's fixed cost; 1 bit/cell)."""
        z, y, x = self.grid.shape_zyx
        packed = np.asarray(self._pack_bits(occupancy_u8))
        return np.unpackbits(packed, bitorder="little",
                             count=self.grid.num_cells).reshape(z, y, x)

    def process_packed(self, occupancy_bits,
                       dt: float | None = None,
                       with_contours: bool = True) -> MappingResult:
        """Mapping step from the fused step's packed bitmap output
        (``FrameOutputs.occupancy_bits``): the d2h is ONE small
        materialization — no separate pack dispatch on the link."""
        import time as _t
        t0 = _t.perf_counter()
        packed = np.asarray(occupancy_bits)
        t1 = _t.perf_counter()
        z, y, x = self.grid.shape_zyx
        occ = np.unpackbits(packed, bitorder="little",
                            count=self.grid.num_cells).reshape(z, y, x)
        if self.backend == "host":
            res = self._segment_host(occ)
            t2 = _t.perf_counter()
            out = self._finish(res, dt, with_contours)
            t3 = _t.perf_counter()
            # phase budget of the latest cycle (ms): d2h / segment / rest
            self.last_phase_ms = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                  (t3 - t2) * 1e3)
            return out
        return self.process(jnp.asarray(occ.reshape(-1)), dt, with_contours)

    def process_sparse(self, sparse,
                       dt: float | None = None,
                       with_contours: bool = True) -> MappingResult:
        """Mapping step from the fused step's SPARSE occupancy output
        (``FrameOutputs.occupancy_sparse_*``): ``sparse`` is
        ``(word_idx, words, count, true_count[, dense_bits_fallback])``.
        The d2h is ~8 bytes per occupied bitmap word instead of the full
        ~num_cells/8-byte bitmap; on capacity overflow (true_count >
        capacity) the dense bitmap fallback is fetched instead."""
        import time as _t
        t0 = _t.perf_counter()
        idx, words = sparse[0], sparse[1]
        cnt = int(np.asarray(sparse[2]))
        true_cnt = int(np.asarray(sparse[3]))
        cap = int(idx.shape[0])
        if true_cnt > cap:
            if len(sparse) <= 4 or sparse[4] is None:
                raise ValueError(
                    "sparse occupancy overflowed its capacity "
                    f"({true_cnt} > {cap}) and no dense fallback was "
                    "passed")
            return self.process_packed(sparse[4], dt, with_contours)
        iw = np.asarray(idx)[:cnt]
        wv = np.asarray(words)[:cnt]          # [cnt, 4] block words
        t1 = _t.perf_counter()
        n = self.grid.num_cells
        nbytes = -(-n // 8)
        nblocks = -(-nbytes // 16)
        buf = np.zeros((nblocks, 4), np.uint32)
        buf[iw] = wv.view(np.uint32)
        z, y, x = self.grid.shape_zyx
        occ = np.unpackbits(buf.view(np.uint8)[:nbytes],
                            bitorder="little", count=n).reshape(z, y, x)
        if self.backend == "host":
            res = self._segment_host(occ)
            t2 = _t.perf_counter()
            out = self._finish(res, dt, with_contours)
            t3 = _t.perf_counter()
            self.last_phase_ms = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                  (t3 - t2) * 1e3)
            return out
        return self.process(jnp.asarray(occ.reshape(-1)), dt, with_contours)

    def process_host_grid(self, occ_zyx: np.ndarray,
                          dt: float | None = None,
                          with_contours: bool = True) -> MappingResult:
        """Mapping step from a host-assembled ``[Z, Y, X]`` binarized
        occupancy (the sharded engine's per-block bitmap assembly —
        ShardedFusionEngine.segment_and_track). Uses the host backend
        directly; the device backend would need a redundant h2d."""
        res = self._segment_host(np.ascontiguousarray(occ_zyx, np.uint8))
        return self._finish(res, dt, with_contours)

    def process(self, occupancy_u8: jnp.ndarray,
                dt: float | None = None,
                with_contours: bool = True) -> MappingResult:
        """One mapping step on a flat ``[num_cells]`` (or padded) occupancy
        vector."""
        z, y, x = self.grid.shape_zyx
        occ = occupancy_u8[: self.grid.num_cells].reshape(z, y, x)
        if self.backend == "host":
            res = self._segment_host(self.fetch_occupancy(occupancy_u8))
        else:
            seg = self._segment(occ)
            # one batched async fetch (device_get prefetches the pytree)
            host = jax.device_get(
                (seg.labels, seg.num_labels, seg.merged_of_label,
                 seg.num_merged, seg.voxel_count, seg.centroid, seg.vmin,
                 seg.vmax))
            res = dict(labels=host[0], num_labels=host[1],
                       merged_of_label=host[2], num_merged=int(host[3]),
                       voxel_count=host[4], centroid=host[5], vmin=host[6],
                       vmax=host[7])
        return self._finish(res, dt, with_contours)

    def _finish(self, res: dict, dt: float | None,
                with_contours: bool) -> MappingResult:
        dt = self.cfg.tracking_dt if dt is None else dt
        objects = build_objects(
            labels=res["labels"], num_labels=res["num_labels"],
            merged_of_label=res["merged_of_label"],
            num_merged=int(res["num_merged"]),
            voxel_count=res["voxel_count"], centroid=res["centroid"],
            vmin=res["vmin"], vmax=res["vmax"], grid=self.grid,
            with_contours=with_contours,
            detail_mask=self._detail_mask(res))
        stats = track_objects(objects, self.tracks,
                              self.cfg.object_min_area, dt,
                              max_tracks=self.cfg.max_tracks)
        return MappingResult(objects=objects, tracks=self.tracks,
                             stats=stats, num_merged=int(res["num_merged"]))


class AsyncMappingWorker:
    """Overlap the host mapping cycle with subsequent fusion frames.

    The reference runs segmentation+tracking inline in its 30 Hz loop; on
    this platform the mapping cycle (bitmap d2h + native CC + assembly +
    tracking) costs tens of ms of HOST time that would otherwise serialize
    with the device pipeline. Mapping consumes only the occupancy grid, so
    it runs on a worker thread over the LATEST occupancy while fusion
    stages the next frames — the reference's resample decoupling
    (``_component.cpp:74-90``) applied between fusion and mapping instead
    of between input and fusion.

    Queue depth is 1 with drop-oldest: if mapping is slower than fusion it
    processes the newest grid (same degradation semantics as the
    reference's resample timer skipping stale frames).

    Tracking dt: the reference's fixed ``dt = 1/30``
    (gpu_depthmap_fusion.cpp:2730) was consistent with its inline 30 Hz
    loop; here cycles arrive at the worker's own (variable) rate, so each
    cycle passes the MEASURED wall-clock time since the previous cycle into
    ``track_objects`` — the filter library is dt-corrected
    (filter.h:70-84), so score decay and velocity estimates then advance at
    wall speed regardless of mapping cadence. Clamped to
    [tracking_dt, dt_max] so a long stall doesn't kill every track in one
    step.
    """

    #: upper clamp for the measured inter-cycle dt (seconds)
    dt_max = 2.0

    def __init__(self, pipeline: MappingPipeline, packed: bool = False):
        self.pipeline = pipeline
        #: submitted grids are FrameOutputs.occupancy_bits bitmaps
        self.packed = packed
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._latest: Optional[MappingResult] = None
        self._lock = threading.Lock()
        self.cycles = 0
        self._stop = False
        self._last_cycle_t: Optional[float] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, occupancy_u8) -> None:
        """Non-blocking: hand the newest occupancy to the worker (device
        array; the d2h happens on the worker thread).

        The transfer is PREFETCHED here (``copy_to_host_async``) so the
        worker's ``np.asarray`` finds the bytes already on host instead of
        queueing its fetch behind in-flight device work.

        A TUPLE submission is the sparse occupancy path
        (``FrameOutputs.occupancy_sparse_*`` + optional dense fallback,
        routed to :meth:`MappingPipeline.process_sparse`); only its
        sparse members are prefetched (the dense fallback is the rare
        overflow path)."""
        items = (occupancy_u8[:4] if isinstance(occupancy_u8, tuple)
                 else (occupancy_u8,))
        for it in items:
            if hasattr(it, "copy_to_host_async"):
                it.copy_to_host_async()
        try:
            self._q.put_nowait(occupancy_u8)
        except queue.Full:
            try:  # replace the stale grid with the newest
                self._q.get_nowait()
            except queue.Empty:
                pass
            try:
                self._q.put_nowait(occupancy_u8)
            except queue.Full:
                pass

    def latest(self) -> Optional[MappingResult]:
        with self._lock:
            return self._latest

    def _run(self):
        while not self._stop:
            try:
                occ = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if occ is None:
                break
            now = time.monotonic()
            dt = (self.pipeline.cfg.tracking_dt if self._last_cycle_t is None
                  else min(max(now - self._last_cycle_t,
                               self.pipeline.cfg.tracking_dt), self.dt_max))
            self._last_cycle_t = now
            if isinstance(occ, tuple):
                res = self.pipeline.process_sparse(occ, dt=dt)
            elif self.packed:
                res = self.pipeline.process_packed(occ, dt=dt)
            else:
                res = self.pipeline.process(occ, dt=dt)
            with self._lock:
                self._latest = res
                self.cycles += 1

    def close(self):
        self._stop = True
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=5.0)
