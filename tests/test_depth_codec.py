"""Depth-link codec: native encoder vs python reference; lossless
roundtrips through the jitted decoder; engine equivalence codec on/off."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ros_gpu_depthmap_fusion_tpu.ops import depth_codec as DC
from ros_gpu_depthmap_fusion_tpu.utils import native


requires_native = pytest.mark.skipif(not native.available(),
                                     reason="native library not built")


def _to_enc(enc_dict):
    return DC.EncodedDepth(**{k: jnp.asarray(v) for k, v in
                              enc_dict.items()})


def _roundtrip(depth, **kw):
    enc, bits = native.depth_encode(depth, **kw)
    h, w = depth.shape[1], depth.shape[2]
    dec = np.asarray(DC.decode_depth(_to_enc(enc), h, w, bits))
    return dec, bits


@requires_native
def test_roundtrip_smooth_with_holes():
    rng = np.random.default_rng(0)
    h, w = 120, 212
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    base = 2500 + 200 * np.sin(u / 40.0) + 150 * np.cos(v / 30.0)
    d = (base + rng.standard_normal((3, h, w))).astype(np.uint16)
    d[rng.random((3, h, w)) < 0.02] = 0
    dec, bits = _roundtrip(d)
    assert bits <= 6  # smooth data must compress
    np.testing.assert_array_equal(dec, d)


@requires_native
@pytest.mark.parametrize("case", ["random", "zeros", "leading_holes",
                                  "const", "steps"])
def test_roundtrip_adversarial(case):
    rng = np.random.default_rng(1)
    if case == "random":
        d = rng.integers(0, 65536, (2, 9, 37), dtype=np.uint16)
    elif case == "zeros":
        d = np.zeros((1, 4, 31), np.uint16)
    elif case == "leading_holes":
        d = np.array([[[0, 0, 5000, 5003, 0, 4998, 0, 0]]], np.uint16)
    elif case == "const":
        d = np.full((1, 3, 40), 1234, np.uint16)
    else:  # extreme steps exercise the exception path
        d = np.tile(np.array([100, 65000, 50, 60000], np.uint16), (1, 2, 8))
    dec, _ = _roundtrip(d)
    np.testing.assert_array_equal(dec, d)


@requires_native
def test_roundtrip_bucketed_bits():
    rng = np.random.default_rng(2)
    d = (3000 + rng.integers(-3, 4, (2, 16, 53))).astype(np.uint16)
    enc, bits = native.depth_encode(d, allowed_bits=DC.B_BUCKETS)
    assert bits in DC.B_BUCKETS
    dec = np.asarray(DC.decode_depth(_to_enc(enc), 16, 53, bits))
    np.testing.assert_array_equal(dec, d)


@requires_native
def test_native_encoder_matches_reference():
    rng = np.random.default_rng(3)
    d = rng.integers(0, 3000, (2, 6, 23), dtype=np.uint16)
    d[rng.random(d.shape) < 0.15] = 0
    enc_n, bits_n = native.depth_encode(d)
    enc_p, bits_p = DC.encode_depth_reference(d)
    assert bits_n == bits_p
    np.testing.assert_array_equal(enc_n["words"], enc_p["words"])
    np.testing.assert_array_equal(enc_n["row_first"], enc_p["row_first"])
    nexc = int(enc_n["exc_count"])
    assert nexc == len(enc_p["exc_idx"])
    np.testing.assert_array_equal(enc_n["exc_idx"][:nexc], enc_p["exc_idx"])
    np.testing.assert_array_equal(enc_n["exc_zz"][:nexc], enc_p["exc_zz"])


def test_reference_encoder_roundtrip_no_native():
    """v2 format sanity without the native lib: python encoder -> jitted
    decoder, exercising holes + escape code + exceptions."""
    rng = np.random.default_rng(7)
    d = (2000 + np.cumsum(rng.integers(-3, 4, (2, 8, 40)), axis=-1)
         ).astype(np.uint16)
    d[rng.random(d.shape) < 0.1] = 0
    d[0, 2, 17] = 65000  # forces an exception at small B
    cap = 64
    enc, bits = DC.encode_depth_reference(d, max_exceptions=cap)
    pad = lambda a: np.pad(a, (0, cap - len(a)))
    enc_j = DC.EncodedDepth(
        words=jnp.asarray(enc["words"]),
        row_first=jnp.asarray(enc["row_first"]),
        exc_idx=jnp.asarray(pad(enc["exc_idx"]).astype(np.int32)),
        exc_zz=jnp.asarray(pad(enc["exc_zz"]).astype(np.int32)),
        exc_count=jnp.int32(len(enc["exc_idx"])))
    dec = np.asarray(DC.decode_depth(enc_j, 8, 40, bits))
    np.testing.assert_array_equal(dec, d)


@requires_native
def test_engine_equivalence_codec_on_off():
    """The compressed link must be invisible: identical frame outputs."""
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
    from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine

    rng = np.random.default_rng(4)
    base = dict(
        num_depth_streams=2, depth_height=24, depth_width=32,
        num_point_sequences=1,
        crop_min=(-6, -6, -6), crop_max=(6, 6, 6),
        voxel_min=(-6, -6, -6), voxel_max=(6, 6, 6),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=256, rollbuffer_seq_capacity=8,
        max_points_per_sequence=64, voxel_occupancy_lifetime=3)
    intr = PinholeIntrinsics.default_for(32, 24)
    eye = np.eye(4, dtype=np.float32)
    depths = []
    for _ in range(3):
        d = rng.integers(800, 4000, (24, 32), dtype=np.uint16)
        d[rng.random((24, 32)) < 0.05] = 0
        depths.append(d)

    outs = []
    for codec in ("dpcm", "none"):
        eng = FusionEngine(FusionConfig(depth_link_codec=codec, **base))
        for f, d in enumerate(depths):
            for s in range(2):
                eng.add_depthmap(s, d, intr, eye, eye)
            out = eng.process(10.0 + f / 30.0)
        outs.append(jax.device_get(out))
    a, b = outs
    np.testing.assert_array_equal(np.asarray(a.occupancy_u8),
                                  np.asarray(b.occupancy_u8))
    np.testing.assert_array_equal(np.asarray(a.raw_points),
                                  np.asarray(b.raw_points))
    assert int(a.fused_count) == int(b.fused_count)
    np.testing.assert_allclose(np.asarray(a.fused_points),
                               np.asarray(b.fused_points))


@requires_native
@pytest.mark.parametrize("shift", [1, 2])
def test_quantized_roundtrip_bounded_error(shift):
    """quant_shift q: |decoded - original| <= 2^(q-1) for nonzero depth,
    holes exact, and the chosen width drops vs lossless."""
    rng = np.random.default_rng(3)
    h, w = 96, 160
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    base = 2500 + 200 * np.sin(u / 40.0) + 150 * np.cos(v / 30.0)
    d = (base + rng.standard_normal((2, h, w))).astype(np.uint16)
    d[rng.random((2, h, w)) < 0.02] = 0
    enc, bits = native.depth_encode(d, quant_shift=shift)
    enc0, bits0 = native.depth_encode(d)
    assert bits <= bits0
    dec = np.asarray(DC.decode_depth(_to_enc(enc), h, w, bits,
                                     quant_shift=shift))
    nz = d != 0
    assert (dec[~nz] == 0).all()
    assert (dec[nz] != 0).all()  # quantization never creates holes
    err = np.abs(dec.astype(np.int32) - d.astype(np.int32))[nz]
    assert err.max() <= (1 << (shift - 1))


@requires_native
@pytest.mark.parametrize("shift", [1, 2])
def test_quantized_native_matches_reference(shift):
    rng = np.random.default_rng(4)
    d = (3000 + 40 * rng.standard_normal((2, 13, 57))).astype(np.uint16)
    d[rng.random(d.shape) < 0.05] = 0
    d[0, 0, :3] = [65535, 1, 65534]  # clamp edges
    n_enc, n_bits = native.depth_encode(d, quant_shift=shift)
    r_enc, r_bits = DC.encode_depth_reference(d, quant_shift=shift)
    assert n_bits == r_bits
    np.testing.assert_array_equal(n_enc["words"], r_enc["words"])
    np.testing.assert_array_equal(n_enc["row_first"], r_enc["row_first"])
    assert int(n_enc["exc_count"]) == len(r_enc["exc_idx"])
    h, w = d.shape[1], d.shape[2]
    dec_n = np.asarray(DC.decode_depth(_to_enc(n_enc), h, w, n_bits,
                                       quant_shift=shift))
    # near-zero depths clamp UP to code 1 (never create holes) and
    # top-of-range depths clamp DOWN to 65535 >> shift: error there is
    # < 2^shift; everywhere else the round-to-nearest bound holds
    err = np.abs(dec_n.astype(np.int32) - d.astype(np.int32))
    edge = ((d.astype(np.int32) < (1 << shift))
            | (d.astype(np.int32) > 65535 - (1 << shift)))
    assert err[(d != 0) & ~edge].max() <= (1 << (shift - 1))
    assert err[d != 0].max() <= (1 << shift) - 1


def test_temporal_roundtrip_and_gain():
    """P-frame roundtrip: decode(prev_q + coded residual) reproduces the
    quantized depth exactly; on a slowly-changing scene the temporal
    width is narrower than the spatial one."""
    import numpy as np
    import jax.numpy as jnp
    from ros_gpu_depthmap_fusion_tpu.ops.depth_codec import (
        EncodedDepth, decode_depth, decode_depth_temporal,
        encode_depth_reference, encode_depth_temporal_reference,
        quantize_reference)
    rng = np.random.default_rng(3)
    h, w = 40, 64
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    frames = []
    for k in range(2):
        d = (3000 + 400 * np.sin(u / 9.0) + 300 * np.cos(v / 7.0)
             + 4.0 * k + rng.integers(-1, 2, (h, w))).astype(np.uint16)
        d[rng.random((h, w)) < 0.02] = 0
        frames.append(d[None])
    qs = 2
    enc0, b0 = encode_depth_reference(frames[0], quant_shift=qs)
    e0 = EncodedDepth(words=jnp.asarray(enc0["words"]),
                      row_first=jnp.asarray(enc0["row_first"]),
                      exc_idx=jnp.asarray(enc0["exc_idx"].astype(np.int32)),
                      exc_zz=jnp.asarray(enc0["exc_zz"].astype(np.int32)),
                      exc_count=jnp.int32(len(enc0["exc_idx"])))
    d0, q0 = decode_depth(e0, h, w, b0, qs, return_series=True)
    np.testing.assert_array_equal(np.asarray(q0),
                                  quantize_reference(frames[0], qs))

    res = encode_depth_temporal_reference(frames[1], np.asarray(q0),
                                          quant_shift=qs)
    assert res is not None
    enc1, b1, curr_q_ref = res
    # slow scene: temporal residuals are narrower than spatial deltas
    _, b1_spatial = encode_depth_reference(frames[1], quant_shift=qs)
    assert b1 <= b1_spatial
    e1 = EncodedDepth(words=jnp.asarray(enc1["words"]),
                      row_first=jnp.asarray(enc1["row_first"]),
                      exc_idx=jnp.asarray(enc1["exc_idx"].astype(np.int32)),
                      exc_zz=jnp.asarray(enc1["exc_zz"].astype(np.int32)),
                      exc_count=jnp.int32(len(enc1["exc_idx"])))
    d1, q1 = decode_depth_temporal(e1, q0, h, w, b1, qs)
    np.testing.assert_array_equal(np.asarray(q1), curr_q_ref)
    np.testing.assert_array_equal(
        np.asarray(d1), quantize_reference(frames[1], qs).astype(
            np.int32) << qs)
    # holes stay exact zeros
    assert (np.asarray(d1)[frames[1] == 0] == 0).all()


def test_temporal_encoder_rejects_hole_churn():
    """Random per-frame dropout makes prev-hole pixels carry full
    magnitude: with a tiny exception budget the P-encoder must refuse."""
    import numpy as np
    from ros_gpu_depthmap_fusion_tpu.ops.depth_codec import (
        encode_depth_temporal_reference, quantize_reference)
    rng = np.random.default_rng(9)
    h, w = 32, 48
    base = np.full((1, h, w), 4000, np.uint16)
    prev = base.copy()
    prev[0][rng.random((h, w)) < 0.3] = 0
    curr = base.copy()
    curr[0][rng.random((h, w)) < 0.3] = 0
    res = encode_depth_temporal_reference(
        curr, quantize_reference(prev, 2), max_exceptions=4,
        allowed_bits=(2, 3, 4), quant_shift=2)
    assert res is None


# ---------------------------------------------------------------------------
# p4 sparse P-frames (round 5)
# ---------------------------------------------------------------------------

def _p4_scene(rng, C=2, H=16, W=41):
    u = np.arange(W)[None, None, :]
    v = np.arange(H)[None, :, None]
    base = 2000 + 30 * np.sin(u / 5.0) + 20 * np.cos(v / 4.0)
    pat = rng.normal(0, 6, (C, H, W))
    holes = rng.random((C, H, W)) < 0.02

    def frame(k):
        d = base + pat + rng.normal(0, 1, (C, H, W))
        d[:, 4:9, (3 + 2 * k) % 30:(8 + 2 * k) % 30] += 120
        d = d.astype(np.uint16)
        d[holes] = 0
        churn = rng.random((C, H, W)) < 0.002
        d[churn] = 0
        return d
    return frame


def _p4_to_device(enc, cap):
    ei = np.zeros(cap, np.int32)
    ez = np.zeros(cap, np.int32)
    n = len(enc["exc_idx"]) if enc["exc_idx"].ndim else 0
    ei[:n] = enc["exc_idx"][:n]
    ez[:n] = enc["exc_zz"][:n]
    return DC.EncodedDepthP4(
        jnp.asarray(np.asarray(enc["flags"]).astype(np.int32)),
        jnp.asarray(np.asarray(enc["lits"]).astype(np.int32)),
        jnp.asarray(ei), jnp.asarray(ez), jnp.int32(n))


@pytest.mark.parametrize("budget", [16, 4])
def test_p4_reference_roundtrip(budget):
    """decode(encode) reproduces the encoder's quantized series exactly
    (budget 4 forces the spill path) and respects the q/2 + hysteresis
    error bound."""
    rng = np.random.default_rng(0)
    frame = _p4_scene(rng)
    shift, hyst = 3, 2
    pq = DC.quantize_reference(frame(0), shift)
    for k in range(1, 4):
        d = frame(k)
        res = DC.encode_depth_p4_reference(d, pq, budget, 4096, shift,
                                           hyst)
        assert res is not None
        enc, cq = res
        e = _p4_to_device(enc, 4096)
        dd, dq = DC.decode_depth_p4(e, jnp.asarray(pq), 16, 41, budget,
                                    shift)
        np.testing.assert_array_equal(np.asarray(dq), cq)
        np.testing.assert_array_equal(
            np.asarray(dd), (cq.astype(np.uint32) << shift)
            .astype(np.uint16))
        mask = (d != 0) & (cq != 0)
        err = np.abs((cq.astype(np.int64) << shift)
                     - d.astype(np.int64))[mask]
        assert err.max() <= (1 << (shift - 1)) + hyst
        pq = cq


@pytest.mark.skipif(not native.available(), reason="no native library")
@pytest.mark.parametrize("budget", [16, 4])
def test_p4_native_matches_reference(budget):
    rng = np.random.default_rng(1)
    frame = _p4_scene(rng)
    shift, hyst = 3, 2
    pq = DC.quantize_reference(frame(0), shift)
    for k in range(1, 4):
        d = frame(k)
        ref = DC.encode_depth_p4_reference(d, pq, budget, 4096, shift,
                                           hyst)
        nat = native.depth_encode_p4(d, pq, budget, 4096,
                                     quant_shift=shift, hysteresis=hyst)
        assert (ref is None) == (nat is None)
        renc, rq = ref
        nenc, nq = nat
        np.testing.assert_array_equal(rq, nq)
        rows = d.shape[0] * d.shape[1]
        np.testing.assert_array_equal(
            renc["flags"].reshape(rows, -1), nenc["flags"])
        nl = nenc["lits"].reshape(rows, budget // 4, 4).astype(np.uint32)
        nlw = (nl[..., 0] | (nl[..., 1] << 8) | (nl[..., 2] << 16)
               | (nl[..., 3] << 24))
        np.testing.assert_array_equal(renc["lits"], nlw)
        ne = int(nenc["exc_count"])
        np.testing.assert_array_equal(renc["exc_idx"],
                                      nenc["exc_idx"][:ne])
        np.testing.assert_array_equal(renc["exc_zz"], nenc["exc_zz"][:ne])
        pq = nq


def test_p4_exception_overflow_returns_none():
    rng = np.random.default_rng(2)
    prev = DC.quantize_reference(
        rng.integers(800, 4000, (1, 8, 16)).astype(np.uint16), 3)
    d = ((prev.astype(np.int64) << 3)
         + rng.integers(-200, 200, prev.shape)).astype(np.uint16)
    assert DC.encode_depth_p4_reference(d, prev, 4, 3, 3, 0) is None
    if native.available():
        assert native.depth_encode_p4(d, prev, 4, 3, quant_shift=3) is None


@pytest.mark.skipif(not native.available(), reason="no native library")
def test_engine_p4_matches_quantized_oracle():
    """Engine with the p4 temporal codec must be bit-identical to a
    codec-free engine fed the dequantized series the encoders produced
    (the codec is lossless w.r.t. its quantized series by construction;
    keyframe_interval=3 exercises I-frames mid-run)."""
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
    from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine
    H, W = 24, 32
    base = dict(
        num_depth_streams=2, depth_height=H, depth_width=W,
        num_point_sequences=1,
        crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=256, rollbuffer_seq_capacity=16,
        max_points_per_sequence=64, voxel_occupancy_lifetime=3)
    cfg = FusionConfig(depth_link_codec="dpcm_temporal",
                       depth_codec_quant_shift=3,
                       depth_codec_hysteresis=2,
                       depth_codec_p4_budget=16,
                       depth_codec_keyframe_interval=3,
                       depth_codec_max_exceptions=2048, **base)
    cfg_ref = FusionConfig(depth_link_codec="none", **base)
    eng = FusionEngine(cfg)
    ref = FusionEngine(cfg_ref)
    intr = PinholeIntrinsics.default_for(W, H)
    eye = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(7)
    frame = _p4_scene(rng, C=2, H=H, W=W)
    bits_seen = []
    for f in range(6):
        d = frame(f)
        for i in range(2):
            eng.add_depthmap(i, d[i], intr, eye, eye)
        out = eng.process(1.0 + f * 0.1)
        bits_seen.append(eng.last_frame_bits)
        # oracle: feed the engine's OWN reconstructed series (encoder
        # curr_q <<= shift) to a codec-free engine
        dq = (eng._host_prev_q.astype(np.uint32) << 3).astype(np.uint16)
        for i in range(2):
            ref.add_depthmap(i, dq[i], intr, eye, eye)
        out_r = ref.process(1.0 + f * 0.1)
        np.testing.assert_array_equal(np.asarray(out.occupancy_u8),
                                      np.asarray(out_r.occupancy_u8))
        assert int(out.raw_count) == int(out_r.raw_count)
    assert "p4" in bits_seen, bits_seen          # p4 actually engaged
    assert any(isinstance(b, int) and b > 0 for b in bits_seen), bits_seen


@pytest.mark.skipif(not native.available(), reason="no native library")
def test_engine_p4_pipelined_matches_sync():
    from ros_gpu_depthmap_fusion_tpu.core.config import FusionConfig
    from ros_gpu_depthmap_fusion_tpu.core.camera import PinholeIntrinsics
    from ros_gpu_depthmap_fusion_tpu.pipeline import FusionEngine
    H, W = 24, 32
    kw = dict(
        num_depth_streams=2, depth_height=H, depth_width=W,
        num_point_sequences=1,
        crop_min=(-5, -5, -5), crop_max=(5, 5, 5),
        voxel_min=(-5, -5, -5), voxel_max=(5, 5, 5),
        voxel_size=(0.5, 0.5, 0.5),
        rollbuffer_point_capacity=256, rollbuffer_seq_capacity=16,
        max_points_per_sequence=64, voxel_occupancy_lifetime=3,
        depth_link_codec="dpcm_temporal", depth_codec_quant_shift=3,
        depth_codec_hysteresis=2, depth_codec_p4_budget=16,
        depth_codec_keyframe_interval=4,
        depth_codec_max_exceptions=2048)
    sync = FusionEngine(FusionConfig(**kw))
    pipe = FusionEngine(FusionConfig(**kw), pipeline_depth=1)
    intr = PinholeIntrinsics.default_for(W, H)
    eye = np.eye(4, dtype=np.float32)
    rng = np.random.default_rng(9)
    frame = _p4_scene(rng, C=2, H=H, W=W)
    outs_s, outs_p = [], []
    for f in range(6):
        d = frame(f)
        for i in range(2):
            sync.add_depthmap(i, d[i], intr, eye, eye)
            pipe.add_depthmap(i, d[i], intr, eye, eye)
        outs_s.append(sync.process(1.0 + f * 0.1))
        o = pipe.process(1.0 + f * 0.1)
        if o is not None:
            outs_p.append(o)
    tail = pipe.flush()
    assert tail is not None
    outs_p.append(tail)
    assert len(outs_p) == len(outs_s)
    for a, b in zip(outs_s, outs_p):
        np.testing.assert_array_equal(np.asarray(a.occupancy_u8),
                                      np.asarray(b.occupancy_u8))
        assert int(a.raw_count) == int(b.raw_count)


def _p4_budget_scene(rng, c, h, w, budget):
    """prev/curr quantized series where row 0 fills the literal budget
    exactly, row 1 spills past it, row 2 is unchanged and the rest are
    random; deltas span the whole in-stream range (+-7, new holes) so
    literals carry high nibbles, plus wide deltas and revivals for the
    exception list."""
    gw = -(-w // 4)
    prev = rng.integers(100, 4000, (c, h, w)).astype(np.int64)
    prev[rng.random((c, h, w)) < 0.03] = 0
    curr = prev.copy()
    gcap = budget // 2
    for ci in range(c):
        for r in range(h):
            if r == 2:
                continue
            n = {0: gcap, 1: min(gw, gcap + 3)}.get(r, rng.integers(0, gw))
            for g in rng.choice(gw, size=n, replace=False):
                x = 4 * g + rng.integers(0, 4)
                if x >= w:
                    x = w - 1
                if prev[ci, r, x] == 0:
                    curr[ci, r, x] = rng.integers(100, 4000)   # revival
                elif rng.random() < 0.1:
                    curr[ci, r, x] = 0                          # new hole
                elif rng.random() < 0.1:
                    curr[ci, r, x] += 50                        # wide
                else:
                    curr[ci, r, x] += rng.choice([-7, -6, 5, 7])
    return prev.astype(np.uint16), curr.astype(np.uint16)


@pytest.mark.parametrize("budget,shape", [
    (4, (1, 3, 41)),      # tiny budget: every busy row spills
    (8, (2, 5, 130)),     # two flag words per row, width not /4
    (48, (1, 4, 200)),    # the bench budget
])
def test_p4_decode_matches_reference_reconstruction(budget, shape):
    """The device decode equals the reference encoder's reconstruction
    bit for bit, including rows that fill the literal budget exactly and
    rows whose groups spill past it (the literal lookup is an integer
    gather, exact on every backend)."""
    c, h, w = shape
    rng = np.random.default_rng(budget)
    prev, curr = _p4_budget_scene(rng, c, h, w, budget)
    res = DC.encode_depth_p4_reference(curr, prev, budget, 4096, 0, 0)
    assert res is not None
    enc, cq = res
    np.testing.assert_array_equal(cq, curr)
    rows_full = np.unpackbits(enc["flags"].view(np.uint8), axis=1).sum(1)
    assert rows_full.max() == budget // 2          # a full-budget row
    assert len(enc["exc_idx"]) > 0                  # spills + wide deltas
    e = _p4_to_device(enc, 4096)
    dd, dq = DC.decode_depth_p4(e, jnp.asarray(prev), h, w, budget, 0)
    np.testing.assert_array_equal(np.asarray(dq), curr)
    np.testing.assert_array_equal(np.asarray(dd), curr)
