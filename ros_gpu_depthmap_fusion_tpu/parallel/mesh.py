"""Device mesh construction.

The reference is single-process/single-GPU (SURVEY.md §2.7) — the only
parallelism it has is SIMT dispatch + OpenMP. This framework's scaling
axes are:

- ``stream``: data parallelism over depth cameras / lidar streams — each
  device ingests and unprojects its own subset of sensors.
- ``space``:  spatial partitioning of the voxel grid — the historic
  occupancy grid is block-partitioned along its linear cell index, so a
  grid larger than one card's memory spreads over the cards.

The target is up to four NVLink-connected GPUs of one host. Every card
reaches every other at the same rate, so the mesh shape follows the
algorithm alone — (stream 4, space 1) or (2, 2) for an 8-camera rig. The
collectives (``psum_scatter`` and ``pmax`` inside ``shard_map``) go to
NCCL.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

STREAM_AXIS = "stream"
SPACE_AXIS = "space"


def make_mesh(num_stream: Optional[int] = None,
              num_space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (stream, space) mesh over the available devices.

    With ``num_stream=None`` all remaining devices go to the stream axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if num_stream is None:
        assert n % num_space == 0, (n, num_space)
        num_stream = n // num_space
    assert num_stream * num_space == n, (num_stream, num_space, n)
    arr = np.asarray(devices).reshape(num_stream, num_space)
    return Mesh(arr, (STREAM_AXIS, SPACE_AXIS))
