"""Depth-link codec: on-device decoders + reference encoders.

The codec shrinks the host->device depth upload (8 cameras at 848x480
move 6.5 MB/frame raw); it moves ~4x fewer bytes, losslessly:

- encoder (``native/fusionhost.cpp fh_depth_encode2``, OpenMP): escape-zero
  row-DPCM — each pixel is a ``B``-bit code; codes ``0..2^B-2`` are
  zigzag(d - previous valid pixel), the top code ``ESC = 2^B-1`` marks a
  hole (depth 0) so no separate mask plane is shipped; each row's first
  valid pixel travels raw (``row_first``); oversized deltas go to a small
  (index, value) exception list.
- decoder (:func:`decode_depth`, pure jnp, static shapes per ``B``):
  bit-unpack via vectorized shift/mask math (no gathers), scatter the few
  exceptions, zigzag-undo, one cumsum along the row, add the row base,
  zero the ESC pixels. Runs inside the fused frame step.

``B`` is bucketed (:data:`B_BUCKETS`) so the jit cache holds a handful of
decoder variants, not one per frame.

Temporal mode (P-frames): when the engine keeps the previous frame's
quantized depth on device, a frame can instead code
``zigzag(curr_q - prev_q)`` per pixel — no row DPCM, no cumsum; decode is
``prev_q + delta`` pointwise (:func:`decode_depth_temporal`). Pixels whose
previous value was a hole carry the full magnitude and ride the exception
list; the encoder picks I vs P per frame by measured payload bytes
(stable real camera streams code 1-2 bits narrower temporally; scenes
with fast content change or hole churn fall back to spatial I-frames).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

# frame bit widths are rounded up to one of these (keeps jit variants few).
# B=17 never overflows: max zigzag(+-65535) = 2^17-2 = ESC-1.
B_BUCKETS = (2, 3, 4, 6, 8, 12, 17)


def bucket_bits(b: int) -> int:
    for cand in B_BUCKETS:
        if b <= cand:
            return cand
    return 17


def words_per_row(width: int, bits: int) -> int:
    return max(1, (width * bits + 31) // 32)


class EncodedDepth(NamedTuple):
    """One frame of compressed depth (all arrays host or device)."""
    words: jnp.ndarray        # [C, H, words_per_row(W, B)] uint32
    row_first: jnp.ndarray    # [C, H] uint16 (first valid pixel per row)
    exc_idx: jnp.ndarray      # [cap] int32 flat pixel index
    exc_zz: jnp.ndarray       # [cap] int32 true zigzag delta
    exc_count: jnp.ndarray    # scalar int32


def _extract_zz(enc: EncodedDepth, width: int, bits: int):
    """Shared decoder front half: per-pixel codes -> (zigzag values with
    exceptions scattered in, hole mask)."""
    c, h, wpr = enc.words.shape
    n = c * h * width
    esc = (1 << bits) - 1
    codes = _extract_codes(enc.words, width, bits)
    is_hole = codes == esc
    zz_stream = jnp.where(is_hole, 0, codes)
    flat = zz_stream.reshape(-1)
    target = jnp.where(
        jnp.arange(enc.exc_idx.shape[0], dtype=jnp.int32) < enc.exc_count,
        enc.exc_idx.astype(jnp.int32), jnp.int32(n))
    flat = flat.at[target].set(enc.exc_zz.astype(jnp.int32), mode="drop")
    return flat.reshape(c, h, width), is_hole


def decode_depth_temporal(enc: EncodedDepth, prev_q: jnp.ndarray,
                          height: int, width: int, bits: int,
                          quant_shift: int = 0):
    """Decode a P-frame: per-pixel ``curr_q = prev_q + unzigzag(code)``
    (no cumsum — cheaper than the spatial decode). ``prev_q`` is the
    previous frame's ``[C, H, W]`` u16 QUANTIZED series (holes = 0),
    exactly as returned by either decoder's second output.

    Returns ``(depth_u16, curr_q)``.
    """
    zz, is_hole = _extract_zz(enc, width, bits)
    delta = (zz >> 1) ^ -(zz & 1)
    curr_q = jnp.where(is_hole, 0, prev_q.astype(jnp.int32) + delta)
    depth = curr_q << quant_shift if quant_shift else curr_q
    return depth.astype(jnp.uint16), curr_q.astype(jnp.uint16)


def _extract_codes(words: jnp.ndarray, width: int, bits: int):
    """Per-pixel ``bits``-wide codes from the packed word stream."""
    c, h, wpr = words.shape
    if 32 % bits == 0:
        # aligned fast path (B in {2, 4, 8} of B_BUCKETS): every field
        # lives inside one word — one shift+mask per pixel. The shifted
        # planes are built in [c, h*wpr] layout and interleaved by one
        # stack+reshape
        ppw = 32 // bits
        flat = words.reshape(c, h * wpr)
        planes = jnp.stack(
            [(flat >> jnp.uint32(k * bits)) & jnp.uint32((1 << bits) - 1)
             for k in range(ppw)], axis=-1)       # [c, h*wpr, ppw]
        return planes.reshape(c, h, wpr * ppw)[..., :width] \
            .astype(jnp.int32)
    # gather-free bit unpack: explode words to a bit tensor (pure
    # shifts + reshapes, so XLA lowers to fused vector ops), then
    # recombine each pixel's `bits`-wide field with a weighted sum
    bit_lanes = (words[..., None]
                 >> jnp.arange(32, dtype=jnp.uint32)) & jnp.uint32(1)
    bit_stream = bit_lanes.reshape(c, h, wpr * 32)[..., :width * bits]
    fields = bit_stream.reshape(c, h, width, bits).astype(jnp.int32)
    weights = jnp.asarray(1 << np.arange(bits, dtype=np.int64),
                          jnp.int32)
    return jnp.sum(fields * weights, axis=-1)


def decode_depth(enc: EncodedDepth, height: int, width: int,
                 bits: int, quant_shift: int = 0,
                 return_series: bool = False):
    """Decode an I-frame to ``[C, H, W]`` uint16. ``bits`` is static (jit
    per bucket).

    ``quant_shift`` must match the encoder's: the DPCM series is in units
    of ``2**quant_shift`` and is scaled back here (holes stay exact 0).
    With ``return_series`` also returns the quantized series (holes = 0)
    — the ``prev_q`` state for a following P-frame.
    """
    zz, is_hole = _extract_zz(enc, width, bits)
    # zigzag undo -> row prefix sum -> add row base -> zero the holes
    delta = (zz >> 1) ^ -(zz & 1)
    series = enc.row_first.astype(jnp.int32)[..., None] + jnp.cumsum(
        delta, axis=-1)
    series = jnp.where(is_hole, 0, series)
    depth = series << quant_shift if quant_shift else series
    if return_series:
        return depth.astype(jnp.uint16), series.astype(jnp.uint16)
    return depth.astype(jnp.uint16)


# ---------------------------------------------------------------------------
# "p4" temporal codec: 4-pixel-group flags + per-row byte-budgeted literals
# ---------------------------------------------------------------------------
#
# The classic P-frame codes EVERY pixel at a fixed width even though, on a
# realistic 30 Hz depth stream (static background + fixed pattern noise +
# small moving objects), only a few percent of pixels change quantization
# bin between frames — especially with HYSTERESIS quantization (a pixel
# keeps its previous bin while the raw depth stays within half a step +
# `hysteresis` of it; error bound q/2 + hysteresis instead of q/2). The
# p4 format exploits that sparsity:
#
#   flags:    1 bit per 4-pixel group, [rows, ceil(ceil(W/4)/32)] u32 —
#             set iff the group got a literal slot.
#   literals: [rows, L] bytes, row-local: row r's flagged groups' 16-bit
#             literals in order, 2 bytes each little-endian (L = per-row
#             byte budget, multiple of 4 — capacity L/2 groups; groups
#             beyond it are NOT flagged and spill their non-zero pixels
#             to the exception list).
#   codes:    4 bits/pixel inside a group literal: 0..14 =
#             zigzag-coded delta in [-7, +7] (0 = delta 0), 15 = new
#             hole. |delta| > 7 (fast content motion) and hole->value
#             revivals code 0 and ride the exception list (a value->hole
#             transition can also ride it as zigzag(-prev): prev + delta
#             == 0 IS the hole encoding). Persistent holes code delta 0
#             (0 + 0 == 0 stays a hole). The +-7 in-stream range
#             matters: a realistic moving object sweeps thousands of
#             multi-bin deltas per frame along its depth edges — at 2
#             bits those all burst the exception budget (measured 37k on
#             the bench scene), at 4 bits they ride in-stream.
#
# Decode (static shapes, fully vectorized, integer-exact): unpack flag
# bits, exclusive per-row prefix over groups (cumsum), then each flagged
# group's literal is lit16[r, prefix[r, j]] — a per-row integer gather,
# exact on every backend (no matmul, so no TF32/bf16 rounding).

P4_GROUP = 4
P4_HOLE = 15   # 4-bit code for a value->hole transition


def _p4_geometry(width: int, budget: int):
    gw = -(-width // P4_GROUP)          # groups per row
    fw = -(-gw // 32)                   # flag words per row
    assert budget % 4 == 0 and budget > 0, budget
    return gw, fw


class EncodedDepthP4(NamedTuple):
    """One p4 P-frame (arrays host or device)."""
    flags: jnp.ndarray    # [rows, fw] u32/i32 flag words (little-endian bits)
    lits: jnp.ndarray     # [rows, L // 4] u32/i32 literal bytes packed LE
    exc_idx: jnp.ndarray  # [cap] int32 flat pixel index
    exc_zz: jnp.ndarray   # [cap] int32 true zigzag delta
    exc_count: jnp.ndarray


def quantize_hysteresis_reference(depth: np.ndarray, prev_q: np.ndarray,
                                  quant_shift: int,
                                  hysteresis: int) -> np.ndarray:
    """Encoder-side hysteresis quantization: a valid pixel KEEPS its
    previous bin while |raw - dequant(prev_q)| <= 2^(shift-1) +
    hysteresis (raw units); otherwise it re-quantizes normally. Error
    bound: q/2 + hysteresis while held, q/2 after a flip."""
    d = np.asarray(depth).astype(np.int64)
    pq = np.asarray(prev_q).astype(np.int64)
    q_std = quantize_reference(depth, quant_shift).astype(np.int64)
    if not quant_shift:
        return q_std.astype(np.uint16)
    band = (1 << (quant_shift - 1)) + int(hysteresis)
    hold = (d != 0) & (pq != 0) & (np.abs(d - (pq << quant_shift)) <= band)
    return np.where(hold, pq, q_std).astype(np.uint16)


def encode_depth_p4_reference(depth: np.ndarray, prev_q: np.ndarray,
                              budget: int, max_exceptions: int,
                              quant_shift: int = 0,
                              hysteresis: int = 0):
    """Reference p4 encoder (vectorized-ish numpy; oracle for the native
    ``fh_depth_encode_p4``). Returns ``(enc dict, curr_q)`` or ``None``
    when the exception list overflows (caller sends an I-frame)."""
    c, h, w = depth.shape
    rows = c * h
    gw, fw = _p4_geometry(w, budget)
    curr_q = quantize_hysteresis_reference(depth, prev_q, quant_shift,
                                           hysteresis)
    cq = curr_q.reshape(rows, w).astype(np.int64)
    pq = np.asarray(prev_q).reshape(rows, w).astype(np.int64)
    delta = cq - pq
    new_hole = (cq == 0) & (pq != 0)
    # in-stream 4-bit code per pixel: zigzag(delta) for |delta| <= 7,
    # P4_HOLE for value->hole
    zzs = np.where(delta >= 0, delta << 1, ((-delta) << 1) - 1)
    code = np.where((np.abs(delta) <= 7) & (cq != 0) & (pq != 0),
                    zzs, 0).astype(np.uint8)
    code[new_hole] = P4_HOLE
    code[(cq == 0) & (pq == 0)] = 0
    # pixels needing the exception list (code stays 0 there)
    wide = (np.abs(delta) > 7) & (cq != 0) & (pq != 0)
    revive = (cq != 0) & (pq == 0)
    exc_px = wide | revive
    code[exc_px] = 0
    # pad width to a group multiple
    wp = gw * P4_GROUP
    code_p = np.zeros((rows, wp), np.uint8)
    code_p[:, :w] = code
    gcodes = code_p.reshape(rows, gw, P4_GROUP).astype(np.uint32)
    gbytes = (gcodes << (4 * np.arange(P4_GROUP,
                                       dtype=np.uint32))).sum(-1)
    gnz = gbytes != 0
    gcap = budget // 2          # 2 bytes per group literal
    flags = np.zeros((rows, fw), np.uint32)
    lits = np.zeros((rows, budget), np.uint8)
    exc = []
    for r in range(rows):
        nz = np.flatnonzero(gnz[r])
        kept = nz[:gcap]
        spilled = nz[gcap:]
        lits[r, 0: 2 * len(kept): 2] = gbytes[r, kept] & 0xFF
        lits[r, 1: 2 * len(kept) + 1: 2] = gbytes[r, kept] >> 8
        for g in kept:
            flags[r, g // 32] |= np.uint32(1) << np.uint32(g % 32)
        for g in spilled:
            for k in range(P4_GROUP):
                x = g * P4_GROUP + k
                if x >= w:
                    break
                cd = code[r, x]
                if cd == 0 and not exc_px[r, x]:
                    continue
                # every non-zero-code pixel of a spilled group rides the
                # exception list; holes as zigzag(-prev)
                d_eff = int(cq[r, x] - pq[r, x])
                zz = (d_eff << 1) ^ (d_eff >> 63) if d_eff >= 0 else \
                    ((-d_eff) << 1) - 1
                exc.append((r * w + x, zz))
    # wide/revive pixels of KEPT (or unflagged-but-zero-byte) groups
    for r, x in zip(*np.nonzero(exc_px)):
        g = x // P4_GROUP
        if gnz[r, g] and g not in set(np.flatnonzero(gnz[r])[gcap:]):
            d_eff = int(delta[r, x])
            zz = (d_eff << 1) if d_eff >= 0 else ((-d_eff) << 1) - 1
            exc.append((r * w + x, zz))
        elif not gnz[r, g]:
            # exception-only group (all other pixels delta 0): unflagged
            d_eff = int(delta[r, x])
            zz = (d_eff << 1) if d_eff >= 0 else ((-d_eff) << 1) - 1
            exc.append((r * w + x, zz))
    exc.sort()
    if len(exc) > max_exceptions:
        return None
    exc_idx = np.asarray([e[0] for e in exc], np.uint32)
    exc_zz = np.asarray([e[1] for e in exc], np.uint32)
    lw = lits.reshape(rows, budget // 4, 4).astype(np.uint32)
    lit_words = (lw[..., 0] | (lw[..., 1] << 8) | (lw[..., 2] << 16)
                 | (lw[..., 3] << 24))
    return dict(flags=flags, lits=lit_words, exc_idx=exc_idx,
                exc_zz=exc_zz), curr_q


def decode_depth_p4(enc: EncodedDepthP4, prev_q: jnp.ndarray,
                    height: int, width: int, budget: int,
                    quant_shift: int = 0):
    """Decode a p4 P-frame (see module comment). Every step is integer
    arithmetic; the literal lookup is a per-row gather.

    Returns ``(depth_u16, curr_q)``."""
    rows = enc.flags.shape[0]
    gw, fw = _p4_geometry(width, budget)
    n = rows * width
    # 1. flag bits [rows, gw] — broadcast+shift
    fwords = enc.flags.astype(jnp.int32)                     # [rows, fw]
    shifts = jnp.arange(32, dtype=jnp.int32)
    fl = ((fwords[:, :, None] >> shifts[None, None, :]) & 1) \
        .reshape(rows, fw * 32)[:, :gw]                      # [rows, gw]
    # 2. exclusive per-row prefix
    pr = jnp.cumsum(fl, axis=-1) - fl                        # [rows, gw]
    # 3. 16-bit group literals [rows, L/2] from packed words
    lw = enc.lits.astype(jnp.int32)                          # [rows, L/4]
    hshift = 16 * jnp.arange(2, dtype=jnp.int32)
    lit16 = ((lw[:, :, None] >> hshift[None, None, :]) & 0xFFFF) \
        .reshape(rows, budget // 2)                          # [rows, L/2]
    # 4. literal for flagged group (r, j) = lit16[r, pr[r, j]]; unflagged
    # groups code 0 (pr of an over-budget unflagged group may point past
    # the row's literals, so clamp before masking)
    slot = jnp.minimum(pr, budget // 2 - 1)
    g16 = jnp.where(fl > 0, jnp.take_along_axis(lit16, slot, axis=1),
                    0)                                       # [rows, gw]
    # 5. per-pixel 4-bit codes
    k = jnp.arange(P4_GROUP, dtype=jnp.int32)
    codes = ((g16[:, :, None] >> (4 * k)[None, None, :]) & 15)
    codes = codes.reshape(rows, gw * P4_GROUP)[:, :width]    # [rows, W]
    # 6. zigzag -> delta, exceptions override, holes
    is_hole = codes == P4_HOLE
    zz = jnp.where(is_hole, 0, codes).reshape(-1)
    target = jnp.where(
        jnp.arange(enc.exc_idx.shape[0], dtype=jnp.int32) < enc.exc_count,
        enc.exc_idx.astype(jnp.int32), jnp.int32(n))
    zz = zz.at[target].set(enc.exc_zz.astype(jnp.int32), mode="drop")
    delta = (zz >> 1) ^ -(zz & 1)
    pq = prev_q.reshape(-1).astype(jnp.int32)
    curr = jnp.where(is_hole.reshape(-1), 0, pq + delta)
    depth = curr << quant_shift if quant_shift else curr
    c = prev_q.shape[0]
    return (depth.astype(jnp.uint16).reshape(c, height, width),
            curr.astype(jnp.uint16).reshape(c, height, width))


# ---------------------------------------------------------------------------
# Pure-python reference encoder (oracle for the native encoder; slow)
# ---------------------------------------------------------------------------

def encode_depth_reference(depth: np.ndarray, max_exceptions: int = 8192,
                           allowed_bits=B_BUCKETS,
                           quant_shift: int = 0) -> Tuple[dict, int]:
    """Reference implementation of ``fh_depth_encode2`` semantics (pixel
    loops; use only at test scale). Returns exception arrays at their
    actual length (the native binding pads them to the static cap)."""
    c, h, w = depth.shape
    rows = depth.reshape(c * h, w).astype(np.int64)
    if quant_shift:
        nz = rows != 0
        q = np.clip((rows + (1 << (quant_shift - 1))) >> quant_shift,
                    1, 65535 >> quant_shift)
        rows = np.where(nz, q, 0)
    zz = np.zeros((c * h, w), np.int64)
    hole = np.zeros((c * h, w), bool)
    row_first = np.zeros(c * h, np.uint16)
    for r in range(c * h):
        prev = -1
        for x in range(w):
            d = int(rows[r, x])
            if d == 0:
                hole[r, x] = True
                continue
            if prev < 0:
                row_first[r] = d
            else:
                delta = d - prev
                zz[r, x] = (delta << 1) ^ (delta >> 63)
            prev = d
    valid_zz = zz[~hole]
    bits = None
    for b in sorted(allowed_bits):
        if 1 <= b <= 17 and int((valid_zz >= (1 << b) - 1).sum()) \
                <= max_exceptions:
            bits = b
            break
    if bits is None:
        raise ValueError("exception budget exceeded at every allowed width")
    esc = (1 << bits) - 1
    over = (zz >= esc) & ~hole
    exc = np.flatnonzero(over.reshape(-1))
    exc_zz = zz.reshape(-1)[exc].copy()
    codes = zz.copy()
    codes[over] = 0
    codes[hole] = esc
    wpr = words_per_row(w, bits)
    words = np.zeros((c * h, wpr), np.uint32)
    for r in range(c * h):
        for x in range(w):
            z = int(codes[r, x])
            bitpos = x * bits
            wi, sh = bitpos // 32, bitpos % 32
            words[r, wi] |= (z << sh) & 0xFFFFFFFF
            if sh + bits > 32:
                words[r, wi + 1] |= z >> (32 - sh)
    return dict(words=words.reshape(c, h, wpr),
                row_first=row_first.reshape(c, h),
                exc_idx=exc.astype(np.uint32),
                exc_zz=exc_zz.astype(np.uint32)), bits


def quantize_reference(depth: np.ndarray, quant_shift: int) -> np.ndarray:
    """The encoders' quantization: nonzero depth -> clamped multiples of
    2**shift in quantized units (holes stay 0)."""
    d = np.asarray(depth).astype(np.int64)
    if not quant_shift:
        return d.astype(np.uint16)
    nz = d != 0
    q = np.clip((d + (1 << (quant_shift - 1))) >> quant_shift,
                1, 65535 >> quant_shift)
    return np.where(nz, q, 0).astype(np.uint16)


def encode_depth_temporal_reference(depth: np.ndarray,
                                    prev_q: np.ndarray,
                                    max_exceptions: int = 8192,
                                    allowed_bits=B_BUCKETS,
                                    quant_shift: int = 0):
    """Reference P-frame encoder: per-pixel ``zigzag(curr_q - prev_q)``
    with escape-zero holes; pixels whose previous value was a hole carry
    full magnitude and land in the exception list.

    Returns ``(enc dict, bits, curr_q)`` or ``None`` when no allowed
    width fits the exception budget (caller falls back to an I-frame).
    ``row_first`` is all zeros (P-frames carry no row bases).
    """
    c, h, w = depth.shape
    curr_q = quantize_reference(depth, quant_shift)
    cq = curr_q.reshape(c * h, w).astype(np.int64)
    pq = np.asarray(prev_q).reshape(c * h, w).astype(np.int64)
    hole = cq == 0
    delta = cq - pq
    zz = np.where(delta >= 0, delta << 1, ((-delta) << 1) - 1)
    zz[hole] = 0
    bits = None
    for b in sorted(allowed_bits):
        if 1 <= b <= 17 and int(((zz >= (1 << b) - 1) & ~hole).sum()) \
                <= max_exceptions:
            bits = b
            break
    if bits is None:
        return None
    esc = (1 << bits) - 1
    over = (zz >= esc) & ~hole
    exc = np.flatnonzero(over.reshape(-1))
    exc_zz = zz.reshape(-1)[exc].copy()
    codes = zz.copy()
    codes[over] = 0
    codes[hole] = esc
    wpr = words_per_row(w, bits)
    words = np.zeros((c * h, wpr), np.uint32)
    for r in range(c * h):
        for x in range(w):
            z = int(codes[r, x])
            bitpos = x * bits
            wi, sh = bitpos // 32, bitpos % 32
            words[r, wi] |= (z << sh) & 0xFFFFFFFF
            if sh + bits > 32:
                words[r, wi + 1] |= z >> (32 - sh)
    return dict(words=words.reshape(c, h, wpr),
                row_first=np.zeros((c, h), np.uint16),
                exc_idx=exc.astype(np.uint32),
                exc_zz=exc_zz.astype(np.uint32)), bits, curr_q
