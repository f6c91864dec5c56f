"""Streaming component: callback-driven host loop around the engine.

Equivalent of the reference's ROS layer ``GPUDepthmapFusionComponent``
(``src/gpu_depthmap_fusion_component.cpp``) with message-bus specifics
replaced by plain callables:

- :meth:`callback_depthmap` / :meth:`callback_point_sequence` — the
  subscription callbacks (cpp:1047-1104, 991-1013), with the depth streams
  synchronized by :class:`~.sync.ApproximateTimeSynchronizer`.
- resample decoupling — with ``cfg.resample_rate > 0``, arriving frames are
  stashed and :meth:`tick_resample` processes the latest stash, decoupling
  input rate from processing rate (cpp:74-90, 1202-1210).
- live reconfig — :meth:`set_flying_pixel_config` mirrors the reference's
  three ``in/Config/FilterFlyingPixels/*`` topics (cpp:970-990). Changed
  values re-jit the step lazily (they are trace-time constants).
- publishers — ``on_points`` / ``on_mapping`` callables replace
  ``out/Points`` / ``out/Viz`` advertising (cpp:1197-1200).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.pipeline.engine import (
    FrameOutputs, FusionEngine)
from ros_gpu_depthmap_fusion_tpu.pipeline.sync import (
    ApproximateTimeSynchronizer, SlotConfig, Stamped)


@dataclasses.dataclass
class DepthMessage:
    depth: np.ndarray
    intrinsics: PinholeIntrinsics
    tf_world_cam: np.ndarray
    tf_crop_cam: np.ndarray


class FusionComponent:
    def __init__(self, cfg: FusionConfig,
                 on_points: Optional[Callable[[FrameOutputs], None]] = None,
                 on_mapping: Optional[Callable] = None,
                 enable_mapping: bool = False,
                 sync_slop: float = 1.0 / 60.0):
        self.cfg = cfg
        self.engine = FusionEngine(cfg, enable_mapping=enable_mapping)
        self.on_points = on_points
        self.on_mapping = on_mapping
        self.enable_mapping = enable_mapping
        slots = [SlotConfig(trigger=(i == 0), optional=(i != 0))
                 for i in range(cfg.num_depth_streams)]
        self.sync = ApproximateTimeSynchronizer(slots, slop=sync_slop)
        self.resample = cfg.resample_rate > 0
        self._stash: Optional[List[Optional[Stamped]]] = None
        self._stash_new = False
        self._tf_world_move = np.eye(4, dtype=np.float32)
        self._tf_crop_move = np.eye(4, dtype=np.float32)
        self.frames_processed = 0
        # per-slot CameraInfo state (cpp:131-135); images arriving before
        # the slot's intrinsics are dropped (guard at _component.cpp:118)
        self._camera_info: List[Optional[PinholeIntrinsics]] = (
            [None] * cfg.num_depth_streams)
        self.frames_skipped_no_intrinsics = 0

    # ------ subscriptions -------------------------------------------------
    def callback_camera_info(self, slot: int,
                             intrinsics: PinholeIntrinsics) -> None:
        """CameraInfo for a stream slot (reference ``in/CameraInfo/N``
        subscription, _component.cpp:131-135,1398-1405). Depth images on a
        slot are processed only once its intrinsics are known."""
        self._camera_info[slot] = intrinsics

    def callback_depthmap(self, slot: int, stamp: float,
                          depth_u16: np.ndarray,
                          intrinsics: Optional[PinholeIntrinsics] = None,
                          tf_world_cam: np.ndarray = None,
                          tf_crop_cam: Optional[np.ndarray] = None):
        """One depth image arriving on a stream slot. Emits a processing
        step when the sync policy fires (or stashes under resampling).

        ``intrinsics`` may ride with the image (synthetic/dataset sources)
        or arrive separately via :meth:`callback_camera_info`; an image on
        a slot with no intrinsics from either source is SKIPPED, mirroring
        the reference's guard (``_component.cpp:118``: images before the
        first CameraInfo are dropped, not processed with garbage)."""
        if intrinsics is None:
            intrinsics = self._camera_info[slot]
        if intrinsics is None:
            self.frames_skipped_no_intrinsics += 1
            return None
        if tf_crop_cam is None:
            tf_crop_cam = tf_world_cam
        msg = DepthMessage(depth_u16, intrinsics, tf_world_cam, tf_crop_cam)
        tup = self.sync.push(slot, stamp, msg)
        if tup is None:
            return None
        if self.resample:
            self._stash = tup
            self._stash_new = True
            return None
        return self._process_tuple(tup, stamp)

    def callback_point_sequence(self, stamp: float, points_xyz: np.ndarray,
                                tf_move_sensor: Optional[np.ndarray] = None):
        """One lidar packet (cpp:991-1013): stage points with their capture
        transform; consumed by the next processing step."""
        if tf_move_sensor is None:
            tf_move_sensor = np.eye(4, dtype=np.float32)
        sec = int(stamp)
        nsec = int(round((stamp - sec) * 1e9))
        self.engine.add_point_sequence(points_xyz, sec, nsec, tf_move_sensor)

    def set_move_transforms(self, tf_world_move: np.ndarray,
                            tf_crop_move: Optional[np.ndarray] = None):
        """Update the move-frame transforms used for rollbuffer points (the
        reference looks these up from TF each frame, cpp:171-211; missing
        TF degrades to identity)."""
        self._tf_world_move = np.asarray(tf_world_move, np.float32)
        self._tf_crop_move = np.asarray(
            tf_world_move if tf_crop_move is None else tf_crop_move,
            np.float32)

    # ------ live reconfig -------------------------------------------------
    def set_flying_pixel_config(self,
                                threshold: Optional[float] = None,
                                size: Optional[int] = None,
                                rot45: Optional[bool] = None):
        """Runtime reconfiguration of the flying-pixel filter
        (cpp:970-990). The threshold is a per-frame packet scalar — it
        takes effect next frame with ZERO recompilation (parity with the
        reference's live uniform update). Size/rot45 change the stencil
        structure (trace-time static) and rebuild the step lazily."""
        if threshold is not None:
            self.cfg = self.cfg.replace(
                flyingpixels_filter_threshold=float(threshold))
            self.engine.set_runtime_filters(fp_threshold=threshold)
        kw = {}
        if size is not None and size != self.cfg.flyingpixels_filter_size:
            kw["flyingpixels_filter_size"] = int(size)
        if (rot45 is not None
                and rot45 != self.cfg.flyingpixels_filter_enable_rot45):
            kw["flyingpixels_filter_enable_rot45"] = bool(rot45)
        if not kw:
            return
        self.cfg = self.cfg.replace(**kw)
        old_state = self.engine.state
        runtime = (self.engine.fp_threshold, self.engine.fp_max_distance,
                   self.engine.ps_threshold)
        self.engine = FusionEngine(self.cfg,
                                   enable_mapping=self.enable_mapping)
        self.engine.state = old_state  # carry device state across reconfig
        self.engine.set_runtime_filters(*runtime)

    # ------ processing ----------------------------------------------------
    def tick_resample(self, now: float) -> Optional[FrameOutputs]:
        """Resample-timer body (cpp:74-90): process the newest stashed
        tuple, if any arrived since the last tick."""
        if not self._stash_new or self._stash is None:
            return None
        self._stash_new = False
        return self._process_tuple(self._stash, now)

    def _process_tuple(self, tup: List[Optional[Stamped]], now: float
                       ) -> FrameOutputs:
        for slot, stamped in enumerate(tup):
            if stamped is None:
                continue  # optional slot missing: zero depth contributes 0s
            m: DepthMessage = stamped.data
            self.engine.add_depthmap(slot, m.depth, m.intrinsics,
                                     m.tf_world_cam, m.tf_crop_cam)
        out = self.engine.process(now, self._tf_world_move,
                                  self._tf_crop_move)
        self.frames_processed += 1
        if self.on_points is not None:
            self.on_points(out)
        if self.enable_mapping and self.on_mapping is not None:
            self.on_mapping(self.engine.segment_and_track(out))
        return out
