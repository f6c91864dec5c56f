"""Checkpoint/resume for long-running mapping sessions.

The reference has no persistence at all — restart is a cold start
(SURVEY.md §5: "Checkpoint/resume: none"). Here the engine's device state
(rollbuffer + historic occupancy + frame index) and the SLAM session
(keyframe poses, landmarks, trajectory) save/restore as ``.npz`` files, so a
mapping process survives restarts with its decayed occupancy history and
map intact.
"""

from __future__ import annotations

import os

import jax
import numpy as np


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def save_engine_state(path: str, state) -> None:
    """Persist an EngineState pytree as one ``state.npz`` of its leaves
    (readable on any platform)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    flat, _ = jax.tree.flatten(_np_tree(state))
    np.savez(os.path.join(path, "state.npz"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(flat)})


def restore_engine_state(path: str, template):
    """Restore into the structure of ``template`` (an EngineState)."""
    path = os.path.abspath(path)
    data = np.load(os.path.join(path, "state.npz"))
    flat, treedef = jax.tree.flatten(template)
    leaves = [jax.numpy.asarray(data[f"leaf_{i}"], dtype=flat[i].dtype)
              for i in range(len(flat))]
    return jax.tree.unflatten(treedef, leaves)


def save_slam_session(path: str, odometry) -> None:
    """Persist an RgbdOdometry session (keyframes, landmarks, trajectory)."""
    os.makedirs(path, exist_ok=True)
    kf_poses = np.stack([kf.pose for kf in odometry.keyframes]) \
        if odometry.keyframes else np.zeros((0, 4, 4), np.float32)
    kf_stamps = np.array([kf.stamp for kf in odometry.keyframes])
    lm_ids = np.array(sorted(odometry.landmarks), np.int64)
    lm_pos = np.stack([odometry.landmarks[i] for i in lm_ids]) \
        if len(lm_ids) else np.zeros((0, 3), np.float32)
    traj_stamps = np.array([s for s, _ in odometry.trajectory])
    traj_poses = np.stack([p for _, p in odometry.trajectory]) \
        if odometry.trajectory else np.zeros((0, 4, 4), np.float32)
    obs = odometry.observations
    np.savez(os.path.join(path, "slam.npz"),
             kf_poses=kf_poses, kf_stamps=kf_stamps,
             lm_ids=lm_ids, lm_pos=lm_pos,
             traj_stamps=traj_stamps, traj_poses=traj_poses,
             obs_kf=np.array([o[0] for o in obs], np.int64),
             obs_lm=np.array([o[1] for o in obs], np.int64),
             obs_pt=(np.stack([o[2] for o in obs])
                     if obs else np.zeros((0, 3), np.float32)),
             pose=odometry.pose,
             next_landmark=np.int64(odometry._next_landmark))


def restore_slam_session(path: str, odometry) -> None:
    """Restore trajectory/landmark state into an odometry instance (feature
    descriptors are not persisted; the next frame re-keyframes)."""
    data = np.load(os.path.join(path, "slam.npz"))
    odometry.keyframes = []  # descriptors not persisted; poses live below
    odometry.trajectory = [(float(s), p) for s, p in
                           zip(data["traj_stamps"], data["traj_poses"])]
    odometry.landmarks = {int(i): p for i, p in
                          zip(data["lm_ids"], data["lm_pos"])}
    odometry.observations = [
        (int(k), int(l), p) for k, l, p in
        zip(data["obs_kf"], data["obs_lm"], data["obs_pt"])]
    odometry.pose = data["pose"]
    odometry._next_landmark = int(data["next_landmark"])
    odometry.restored_keyframe_poses = data["kf_poses"]
