"""Historic point-sequence rollbuffer.

Functional, fixed-capacity re-design of the reference's double-buffered
rollbuffer SSBO group (``gpu_depthmap_fusion.h:402-416`` — points, masks,
per-point sequence indices, ``PointSequence`` structs, selection scratch).
The CPU paths are the behavioral spec (the GPU variants are buggy/unused,
SURVEY.md §2.9):

- expiry:    ``rollPointSequenceRollbufferCPU``  (gpu_depthmap_fusion.cpp:1098-1217)
- selection: ``selectPointSequenceTimespanCPU``  (cpp:1358-1416)
- insert:    ``insertNewPointSequencesInRollbuffer`` (cpp:979-1087)
- transform: ``insertSelectedPointSequence`` + ``transformPointSequence``
             (cpp:1509-1581)

Design notes:
- All arrays have static capacity; live extents are int32 scalars. Overflow
  is explicit: inserts that do not fit are dropped and reported (the
  reference silently grew SSBOs; its own GPU path hard-discards above 100k
  points, cpp:1271-1275).
- Sequences are stored contiguous and time-ordered (the reference assumes
  monotone arrival — its selection window is a contiguous [start, last]
  range, cpp:1377-1404; here the invariant is explicit and enforced with a
  clamp at insert).
- Timestamps are (sec, nsec) int32 pairs compared lexicographically
  (compareTime parity) — no 64-bit integers, so the hot path stays in
  32-bit arithmetic. Expiry/selection counts are O(S_cap) masked
  reductions instead of a host scan + download.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ros_gpu_depthmap_fusion_tpu.core import transforms


def time_lt(a_sec, a_nsec, b_sec, b_nsec):
    """Lexicographic (sec, nsec) less-than (reference compareTime < 0)."""
    return (a_sec < b_sec) | ((a_sec == b_sec) & (a_nsec < b_nsec))


def time_le(a_sec, a_nsec, b_sec, b_nsec):
    return (a_sec < b_sec) | ((a_sec == b_sec) & (a_nsec <= b_nsec))


class RollBuffer(NamedTuple):
    """Pytree state. Point slots [0, num_points) and sequence slots
    [0, num_seqs) are live; sequence i owns the contiguous point range
    [seq_start[i], seq_start[i] + seq_count[i])."""

    points: jnp.ndarray     # [P, 4] float32, sensor-frame homogeneous
    mask: jnp.ndarray       # [P] bool (post sequence-filter validity)
    seq_idx: jnp.ndarray    # [P] int32, owning sequence slot per point
    seq_sec: jnp.ndarray    # [S] int32
    seq_nsec: jnp.ndarray   # [S] int32
    seq_start: jnp.ndarray  # [S] int32
    seq_count: jnp.ndarray  # [S] int32
    seq_tf_move: jnp.ndarray  # [S, 4, 4] float32, move <- capture frame
    num_points: jnp.ndarray   # scalar int32
    num_seqs: jnp.ndarray     # scalar int32

    @property
    def point_capacity(self) -> int:
        return self.points.shape[0]

    @property
    def seq_capacity(self) -> int:
        return self.seq_sec.shape[0]


def _shift_rows(x: jnp.ndarray, shift, fill_value=0) -> jnp.ndarray:
    """``x[i] = x[i + shift]`` with ``fill_value`` beyond the end —
    the gather-free form of ``jnp.take(x, iota + shift, mode="fill")``:
    a pad + ``dynamic_slice`` is a contiguous copy. ``shift`` must be in
    [0, len(x)]."""
    pad_shape = (x.shape[0],) + x.shape[1:]
    if fill_value is False:
        pad = jnp.zeros(pad_shape, x.dtype)
    else:
        pad = jnp.full(pad_shape, fill_value, x.dtype)
    ext = jnp.concatenate([x, pad], axis=0)
    return jax.lax.dynamic_slice_in_dim(
        ext, jnp.clip(shift, 0, x.shape[0]), x.shape[0], axis=0)


def _write_block(x: jnp.ndarray, block: jnp.ndarray, offset,
                 n_live) -> jnp.ndarray:
    """Write ``block[:n_live]`` into ``x`` at row ``offset`` (rows past
    ``n_live`` keep x's values; writes past the end are dropped) — the
    dynamic-slice form of ``x.at[offset + iota].set(block, mode="drop")``
    for a CONTIGUOUS destination window."""
    cap = x.shape[0]
    m = block.shape[0]
    off = jnp.clip(offset, 0, cap)
    ext = jnp.concatenate(
        [x, jnp.zeros((m,) + x.shape[1:], x.dtype)], axis=0)
    cur = jax.lax.dynamic_slice_in_dim(ext, off, m, axis=0)
    iota = jnp.arange(m, dtype=jnp.int32)
    live = iota < n_live
    merged = jnp.where(live.reshape((m,) + (1,) * (x.ndim - 1)),
                       block.astype(x.dtype), cur)
    ext = jax.lax.dynamic_update_slice_in_dim(ext, merged, off, axis=0)
    return ext[:cap]


def make_rollbuffer(point_capacity: int, seq_capacity: int) -> RollBuffer:
    return RollBuffer(
        points=jnp.zeros((point_capacity, 4), jnp.float32),
        mask=jnp.zeros((point_capacity,), bool),
        seq_idx=jnp.zeros((point_capacity,), jnp.int32),
        seq_sec=jnp.zeros((seq_capacity,), jnp.int32),
        seq_nsec=jnp.zeros((seq_capacity,), jnp.int32),
        seq_start=jnp.zeros((seq_capacity,), jnp.int32),
        seq_count=jnp.zeros((seq_capacity,), jnp.int32),
        seq_tf_move=jnp.tile(jnp.eye(4, dtype=jnp.float32),
                             (seq_capacity, 1, 1)),
        num_points=jnp.int32(0),
        num_seqs=jnp.int32(0),
    )


def insert_sequences(rb: RollBuffer,
                     new_points: jnp.ndarray,
                     new_mask: jnp.ndarray,
                     new_seq_idx: jnp.ndarray,
                     new_seq_sec: jnp.ndarray,
                     new_seq_nsec: jnp.ndarray,
                     new_seq_count: jnp.ndarray,
                     new_seq_tf_move: jnp.ndarray,
                     num_new_points: jnp.ndarray,
                     num_new_seqs: jnp.ndarray
                     ) -> Tuple[RollBuffer, jnp.ndarray]:
    """Append a staging batch of sequences (reference
    insertNewPointSequencesInRollbuffer, cpp:979-1087).

    ``new_seq_idx`` numbers each new point's sequence 0-based within the
    batch (the reference stamps these with set_uints, cpp:1052-1061);
    ``new_seq_count`` gives points per new sequence; new points are
    concatenated in sequence order.

    Returns (state, overflowed) — overflowed is True when part of the batch
    was dropped for capacity.
    """
    p_cap, s_cap = rb.point_capacity, rb.seq_capacity
    n_idx = jnp.arange(new_points.shape[0], dtype=jnp.int32)
    s_idx = jnp.arange(new_seq_sec.shape[0], dtype=jnp.int32)

    # how many new seqs/points actually fit
    fit_seqs = jnp.minimum(num_new_seqs, s_cap - rb.num_seqs)
    # points of the seqs that fit = sum of their counts
    new_counts_live = jnp.where(s_idx < fit_seqs, new_seq_count, 0)
    fit_points_by_seq = jnp.sum(new_counts_live)
    fit_points = jnp.minimum(fit_points_by_seq, p_cap - rb.num_points)
    # if the point capacity truncates mid-sequence, drop that whole sequence:
    # recompute fit_seqs as the number of whole sequences within fit_points
    cum = jnp.cumsum(new_counts_live)
    fit_seqs = jnp.sum((cum <= fit_points) & (s_idx < fit_seqs))
    fit_points = jnp.sum(jnp.where(s_idx < fit_seqs, new_seq_count, 0))
    overflow = (fit_seqs < num_new_seqs) | (fit_points_by_seq > fit_points)

    # write new points at offset num_points (contiguous destination —
    # dynamic-slice form, not a scatter)
    points = _write_block(rb.points, new_points, rb.num_points, fit_points)
    mask = _write_block(rb.mask, new_mask, rb.num_points, fit_points)
    seq_idx = _write_block(rb.seq_idx, new_seq_idx + rb.num_seqs,
                           rb.num_points, fit_points)

    # enforce the monotone-time invariant: clamp each appended timestamp to
    # be >= the buffer's current latest (reference relies on arrival order)
    last_sec = jnp.where(rb.num_seqs > 0,
                         rb.seq_sec[jnp.maximum(rb.num_seqs - 1, 0)],
                         -2**31 + 1)
    last_nsec = jnp.where(rb.num_seqs > 0,
                          rb.seq_nsec[jnp.maximum(rb.num_seqs - 1, 0)], 0)
    behind = time_lt(new_seq_sec, new_seq_nsec, last_sec, last_nsec)
    eff_sec = jnp.where(behind, last_sec, new_seq_sec)
    eff_nsec = jnp.where(behind, last_nsec, new_seq_nsec)

    # new seq start offsets: buffer offset + exclusive cumsum of counts
    excl = jnp.cumsum(new_seq_count) - new_seq_count
    stgt = jnp.where(s_idx < fit_seqs, rb.num_seqs + s_idx, s_cap)
    seq_sec = rb.seq_sec.at[stgt].set(eff_sec, mode="drop")
    seq_nsec = rb.seq_nsec.at[stgt].set(eff_nsec, mode="drop")
    seq_start = rb.seq_start.at[stgt].set(rb.num_points + excl, mode="drop")
    seq_count = rb.seq_count.at[stgt].set(new_seq_count, mode="drop")
    seq_tf_move = rb.seq_tf_move.at[stgt].set(new_seq_tf_move, mode="drop")

    return rb._replace(
        points=points, mask=mask, seq_idx=seq_idx,
        seq_sec=seq_sec, seq_nsec=seq_nsec,
        seq_start=seq_start, seq_count=seq_count, seq_tf_move=seq_tf_move,
        num_points=rb.num_points + fit_points,
        num_seqs=rb.num_seqs + fit_seqs,
    ), overflow


def roll(rb: RollBuffer, min_sec, min_nsec) -> RollBuffer:
    """Expire sequences older than (min_sec, min_nsec) — reference
    rollPointSequenceRollbufferCPU (cpp:1098-1217): discard every leading
    sequence with timestamp < min, shift the remainder to the front and
    rebase point sequence indices / start offsets."""
    p_cap, s_cap = rb.point_capacity, rb.seq_capacity
    s_idx = jnp.arange(s_cap, dtype=jnp.int32)
    live_seq = s_idx < rb.num_seqs
    expired = live_seq & time_lt(rb.seq_sec, rb.seq_nsec, min_sec, min_nsec)
    # the reference discards only the contiguous leading run (cpp:1109-1123);
    # with the monotone invariant every expired seq is in that run
    n_disc_seqs = jnp.sum(expired.astype(jnp.int32))
    n_disc_pts = jnp.sum(jnp.where(expired, rb.seq_count, 0))

    p_idx = jnp.arange(p_cap, dtype=jnp.int32)
    points = _shift_rows(rb.points, n_disc_pts)
    mask = _shift_rows(rb.mask, n_disc_pts, fill_value=False)
    seq_idx = _shift_rows(rb.seq_idx, n_disc_pts) - n_disc_seqs

    seq_sec = _shift_rows(rb.seq_sec, n_disc_seqs)
    seq_nsec = _shift_rows(rb.seq_nsec, n_disc_seqs)
    seq_start = _shift_rows(rb.seq_start, n_disc_seqs) - n_disc_pts
    seq_count = _shift_rows(rb.seq_count, n_disc_seqs)
    seq_tf_move = _shift_rows(rb.seq_tf_move, n_disc_seqs)

    num_points = rb.num_points - n_disc_pts
    num_seqs = rb.num_seqs - n_disc_seqs
    # zero the dead tails so state stays canonical
    live_p = p_idx < num_points
    live_s = s_idx < num_seqs
    return rb._replace(
        points=jnp.where(live_p[:, None], points, 0.0),
        mask=mask & live_p,
        seq_idx=jnp.where(live_p, seq_idx, 0),
        seq_sec=jnp.where(live_s, seq_sec, 0),
        seq_nsec=jnp.where(live_s, seq_nsec, 0),
        seq_start=jnp.where(live_s, seq_start, 0),
        seq_count=jnp.where(live_s, seq_count, 0),
        seq_tf_move=jnp.where(live_s[:, None, None], seq_tf_move,
                              jnp.eye(4, dtype=jnp.float32)),
        num_points=num_points, num_seqs=num_seqs,
    )


class Selection(NamedTuple):
    point_start: jnp.ndarray
    point_count: jnp.ndarray
    seq_start: jnp.ndarray
    seq_count: jnp.ndarray


def select_timespan(rb: RollBuffer, min_sec, min_nsec, max_sec, max_nsec
                    ) -> Selection:
    """Contiguous window of sequences with min <= t <= max (reference
    selectPointSequenceTimespanCPU, cpp:1358-1416)."""
    s_idx = jnp.arange(rb.seq_capacity, dtype=jnp.int32)
    live = s_idx < rb.num_seqs
    ge_min = ~time_lt(rb.seq_sec, rb.seq_nsec, min_sec, min_nsec)
    le_max = time_le(rb.seq_sec, rb.seq_nsec, max_sec, max_nsec)
    inside = live & ge_min & le_max
    any_inside = jnp.any(inside)
    first = jnp.argmax(inside)  # first True (0 if none; gated below)
    count = jnp.sum(inside.astype(jnp.int32))
    sel_seq_start = jnp.where(any_inside, first, rb.num_seqs)
    point_start = jnp.where(any_inside, rb.seq_start[first], 0)
    point_count = jnp.sum(jnp.where(inside, rb.seq_count, 0))
    return Selection(point_start.astype(jnp.int32), point_count,
                     sel_seq_start.astype(jnp.int32), count)


def gather_selection(rb: RollBuffer,
                     sel: Selection,
                     tf_world_move: jnp.ndarray,
                     tf_crop_move: jnp.ndarray,
                     capacity: int):
    """Materialize a selection window for the fusion pipeline: per-point
    world/crop coordinates and mask, mirroring insertSelectedPointSequence +
    transformPointSequence (cpp:1509-1581): sequence transform indices are
    renumbered 0-based, per-sequence transforms composed as
    ``T_frame<-move @ T_move<-seq``, points gathered and transformed.

    Returns (points_world ``[capacity, 4]``, points_crop, mask, count).
    """
    assert capacity <= rb.point_capacity, (capacity, rb.point_capacity)
    p_idx = jnp.arange(capacity, dtype=jnp.int32)
    live = p_idx < sel.point_count
    # contiguous selection window -> dynamic slices, not gathers
    pts = _shift_rows(rb.points, sel.point_start)[:capacity]
    msk = _shift_rows(rb.mask, sel.point_start,
                      fill_value=False)[:capacity] & live
    tf_idx = _shift_rows(rb.seq_idx, sel.point_start)[:capacity]
    tf_idx = jnp.clip(tf_idx - sel.seq_start, 0, rb.seq_capacity - 1)

    tfs_world = transforms.compose_seq_transforms(
        tf_world_move,
        jnp.take(rb.seq_tf_move,
                 jnp.arange(rb.seq_capacity, dtype=jnp.int32) + sel.seq_start,
                 axis=0, mode="clip"))
    tfs_crop = transforms.compose_seq_transforms(
        tf_crop_move,
        jnp.take(rb.seq_tf_move,
                 jnp.arange(rb.seq_capacity, dtype=jnp.int32) + sel.seq_start,
                 axis=0, mode="clip"))

    pw = transforms.transform_points_indirect(pts, tfs_world, tf_idx, msk)
    pc = transforms.transform_points_indirect(pts, tfs_crop, tf_idx, msk)
    pw = jnp.where(msk[:, None], pw, 0.0)
    pc = jnp.where(msk[:, None], pc, 0.0)
    return pw, pc, msk, sel.point_count


def dump(rb: RollBuffer) -> dict:
    """Download every rollbuffer field to host numpy for inspection —
    the analog of the reference's debug inspector
    ``checkAllPointSequenceBuffers`` (gpu_depthmap_fusion.cpp:859-926),
    which pulls all 19 rollbuffer SSBOs into host vectors. Here the state
    is one pytree, so the dump is a single batched ``device_get``; live
    extents are pre-sliced for convenience (the full-capacity arrays are
    included under ``*_raw``).
    """
    import numpy as np
    host = jax.device_get(rb)
    np_pts = int(host.num_points)
    np_seqs = int(host.num_seqs)
    return {
        "num_points": np_pts,
        "num_seqs": np_seqs,
        "points": np.asarray(host.points[:np_pts]),
        "mask": np.asarray(host.mask[:np_pts]),
        "seq_idx": np.asarray(host.seq_idx[:np_pts]),
        "seq_sec": np.asarray(host.seq_sec[:np_seqs]),
        "seq_nsec": np.asarray(host.seq_nsec[:np_seqs]),
        "seq_start": np.asarray(host.seq_start[:np_seqs]),
        "seq_count": np.asarray(host.seq_count[:np_seqs]),
        "seq_tf_move": np.asarray(host.seq_tf_move[:np_seqs]),
        "points_raw": np.asarray(host.points),
        "mask_raw": np.asarray(host.mask),
        "seq_idx_raw": np.asarray(host.seq_idx),
    }
