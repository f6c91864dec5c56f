"""ROS-style (sec, nsec) timestamps.

The reference stores per-sequence timestamps as two u32s and compares them
lexicographically (``shader/rollbuffer_count_discarded_points.glsl:49-56``,
``compareTime`` in the engine). On the host we encode both into one int64
nanosecond count so expiry/selection become single ``searchsorted`` calls
over a sorted-by-time sequence table.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

NSEC_PER_SEC = 1_000_000_000


def encode(sec, nsec):
    """(sec, nsec) u32 pair -> int64 nanoseconds. Works for jnp and np."""
    if isinstance(sec, (jnp.ndarray,)):
        return sec.astype(jnp.int64) * NSEC_PER_SEC + nsec.astype(jnp.int64)
    return np.int64(sec) * NSEC_PER_SEC + np.int64(nsec)


def decode(t_ns):
    """int64 nanoseconds -> (sec, nsec)."""
    sec = t_ns // NSEC_PER_SEC
    nsec = t_ns - sec * NSEC_PER_SEC
    return sec, nsec


def from_seconds(t: float) -> np.int64:
    """Float seconds -> int64 nanoseconds (host-side convenience)."""
    return np.int64(round(t * NSEC_PER_SEC))


def compare(a_sec, a_nsec, b_sec, b_nsec) -> int:
    """Lexicographic compare, mirroring the reference's compareTime:
    -1 if a < b, 0 if equal, +1 if a > b."""
    if a_sec != b_sec:
        return -1 if a_sec < b_sec else 1
    if a_nsec != b_nsec:
        return -1 if a_nsec < b_nsec else 1
    return 0
