"""Full TUM-layout pipeline test (BASELINE configs #2/#4 shape) on a
synthetic sequence written through the PNG codec."""

import numpy as np

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
from ros_gpu_depthmap_fusion_tpu.pipeline.tum_runner import (
    run_tum_sequence, write_synthetic_tum_sequence)


def _cfg(w, h):
    return FusionConfig(
        num_depth_streams=1, depth_height=h, depth_width=w,
        depth_scale=1.0 / 5000.0,
        crop_min=(-8, -8, -8), crop_max=(8, 8, 8),
        voxel_min=(-8, -8, 0), voxel_max=(8, 8, 8),
        voxel_size=(0.1, 0.1, 0.1), voxel_occupancy_lifetime=10,
        flyingpixels_filter_threshold=0.2,
        rollbuffer_point_capacity=256,
        max_points_per_sequence=32)


def test_tum_groundtruth_pose_fusion(tmp_path):
    """Config #2 analog: known poses + voxel fusion over the sequence."""
    root = str(tmp_path / "seq")
    write_synthetic_tum_sequence(root, n_frames=6, width=96, height=72)
    res = run_tum_sequence(root, cfg=_cfg(96, 72),
                           pose_source="groundtruth", max_frames=6)
    assert res.frames == 6
    assert res.ate_rmse_m is not None and res.ate_rmse_m < 1e-6
    assert res.occupied_cells > 50
    assert res.fused_points_last > 10


def test_tum_slam_pose_fusion(tmp_path):
    """Config #4 analog: SLAM-estimated poses + fusion + ATE bound."""
    root = str(tmp_path / "seq2")
    write_synthetic_tum_sequence(root, n_frames=8, width=160, height=120,
                                 seed=3)
    res = run_tum_sequence(root, cfg=_cfg(160, 120), pose_source="slam",
                           max_frames=8, ba_every=0)
    assert res.frames == 8
    assert res.ate_rmse_m is not None
    # depth-shaded features on a small synthetic scene: generous bound
    assert res.ate_rmse_m < 0.10, res.ate_rmse_m
    assert res.occupied_cells > 0


def test_tum_hard_sequence_ate_under_5cm(tmp_path):
    """The BASELINE <=5 cm ATE bar on the HARD synthetic (fr1-class
    difficulty: aggressive loop-closed orbit, quadratic depth noise,
    range-growing dropout — see write_hard_synthetic_tum_sequence). CI
    runs a reduced-size cut (320x240, 40 frames at the full-sequence
    angular rate)."""
    from ros_gpu_depthmap_fusion_tpu.pipeline.tum_runner import (
        write_hard_synthetic_tum_sequence)
    root = str(tmp_path / "hard")
    write_hard_synthetic_tum_sequence(root, n_frames=40, width=320,
                                      height=240, orbit_frames=150)
    res = run_tum_sequence(root, pose_source="slam", ba_every=8)
    assert res.frames == 40
    assert res.ate_rmse_m is not None
    assert res.ate_rmse_m <= 0.05, f"ATE {res.ate_rmse_m*100:.2f} cm > 5 cm"
