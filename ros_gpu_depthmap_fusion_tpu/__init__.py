"""Accelerator-native depth-map + lidar fusion and mapping engine.

A from-scratch re-design of the capabilities of ``xaedes/ros_gpu_depthmap_fusion``
(reference: C++11 + OpenGL 4.3 compute shaders, single GPU, ROS1) in JAX:
JAX/XLA for the fused per-frame compute graph (it runs on an NVIDIA H100),
``jax.sharding`` + ``shard_map`` for multi-GPU scaling, and a small C++
native host runtime for input staging, encoding and segmentation.

Top-level layout (mirrors the reference's layer map, SURVEY.md §1):

- :mod:`~ros_gpu_depthmap_fusion_tpu.core`     — grid geometry, camera models,
  SE(3) transforms, timestamps, config (reference L5 ``grid_meta.h`` et al).
- :mod:`~ros_gpu_depthmap_fusion_tpu.ops`      — the device op set: one JAX/XLA
  op per GLSL compute kernel family (reference L3/L4).
- :mod:`~ros_gpu_depthmap_fusion_tpu.state`    — functional state containers:
  rolling point buffer, historic voxel occupancy (reference L2 SSBO state).
- :mod:`~ros_gpu_depthmap_fusion_tpu.pipeline` — the fused per-frame step and
  the host streaming loop (reference L1/L2).
- :mod:`~ros_gpu_depthmap_fusion_tpu.mapping`  — object segmentation (connected
  components), object extraction and tracking (reference L6 + engine tail).
- :mod:`~ros_gpu_depthmap_fusion_tpu.parallel` — device meshes, sharded fusion
  step, collectives (no reference analog; north-star requirement).
- :mod:`~ros_gpu_depthmap_fusion_tpu.slam`     — feature frontend, pose graph,
  windowed Schur-complement bundle adjustment (north-star extension).
- :mod:`~ros_gpu_depthmap_fusion_tpu.utils`    — profiling, visualization.
"""

__version__ = "0.1.0"

from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig  # noqa: F401
from ros_gpu_depthmap_fusion_tpu.core.grid import VoxelGrid  # noqa: F401
