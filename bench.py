#!/usr/bin/env python3
"""Benchmark: RX + TX throughput on the GPU.

All rows measure against the reference's only published number
(5.22 Msample/s through its full RX chain; BASELINE.md):

1. dense capture RX: back-to-back 1500-byte RATE_3_4_QAM16 frames (the
   reference test_sim configuration) through the batched detect+decode
   megagraph at a production batch size (512 frames / ~3.8 M samples per
   dispatch).
2. streaming RX (reference parity): the user-facing pipelined
   ReceiverChain fed 4096-sample float32 chunks like the reference
   receiver loop (src/receiver.cpp:42-58, NUM_RX_SAMPLES=4096).
3. streaming RX (tuned): same chain fed the USRP's native sc16 wire
   format (the N210 ADC is 14-bit, so int16 ingest is radio-exact) in
   whole 2M-sample supersteps.
4. streaming RX (sc12/sc8): UHD's 12-bit and 8-bit over-the-wire formats
   (sc8 is not enough for 64-QAM; sc12 is transparent at every rate).
5. streaming RX all-rates: the Receiver DEFAULT config (rates=ALL_RATES,
   any frame's rate read from its header, reference
   src/frame_decoder.cpp:72-88) on a dense mixed-rate sc12 stream -
   decoded through the universal any-rate decoder, ONE device dispatch
   per superstep decode batch.
Plus: CFO-corrected streaming, K=1/auto delivery latency, the H2D wire
roofline, and TX batched frame building (samples/s onto the air).

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np

REFERENCE_SAMPLES_PER_SEC = 1100 * 7120 / 1.5005  # ~5.22e6


def bench_capture(jax, jnp, frontend, tx, rate, length):
    """Dense-capture megagraph throughput (round-2 headline, unchanged)."""
    from fun_ofdm_tpu.rates import params_for

    frame_len = params_for(rate).frame_samples(length)  # 7120

    # 512 frames, ~3.8 M samples per dispatch: a batch decode of whole
    # recorded captures, not slivers (re-sizing it for the H100 is
    # ROADMAP Speed #7).
    channels = 16
    frames_per_channel = 32

    rng = np.random.default_rng(0)
    payloads = rng.integers(
        0, 256, size=(channels, length), dtype=np.uint8)
    fre, fim = tx.build_frame_p(jnp.asarray(payloads), rate)
    fre, fim = np.asarray(fre), np.asarray(fim)

    def dense(f):
        return np.concatenate(
            [np.tile(f[:, None, :], (1, frames_per_channel, 1)).reshape(
                channels, -1),
             np.zeros((channels, 2048), np.float32)], axis=1).astype(np.float32)

    s_re, s_im = dense(fre), dense(fim)
    n_samples = s_re.size

    def capture(r, i):
        return jax.vmap(functools.partial(
            lambda rr, ii: frontend.receive_capture_p(
                (rr, ii), rate=rate, length=length,
                max_frames=frames_per_channel)))(r, i)

    fn = jax.jit(capture)

    streams_dev = (jax.device_put(jnp.asarray(s_re)),
                   jax.device_put(jnp.asarray(s_im)))
    out = fn(*streams_dev)
    jax.block_until_ready(out)
    ok = int(np.asarray(out["crc_ok"]).sum())
    expected = channels * frames_per_channel
    assert ok == expected, f"decoded {ok}/{expected}"

    # Chain each rep's input on the previous rep's output (numerically a
    # no-op fused INTO the megagraph: one dispatch per rep) so reps
    # serialize on device. Best of 2 measurement loops.
    chained_fn = jax.jit(lambda r, i, ok: capture(
        r + 0.0 * ok.sum().astype(r.dtype), i))
    reps = 10
    ok_dev = out["crc_ok"]
    out = chained_fn(*streams_dev, ok_dev)   # compile
    jax.block_until_ready(out)
    ok_dev = out["crc_ok"]
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = chained_fn(*streams_dev, ok_dev)
            ok_dev = out["crc_ok"]
        jax.block_until_ready(out)
        dt = min(dt, (time.perf_counter() - t0) / reps)

    frame_bits = channels * frames_per_channel * length * 8
    return (n_samples / dt, frame_bits / dt / 1e6,
            (s_re[0], s_im[0]), frames_per_channel)


def bench_tx(jax, jnp, tx, rate, length):
    """Batched frame-builder throughput (reference src/transmitter.cpp:33-37;
    its README calls TX 'not very computationally complex' — ours is one
    fused jit over the whole batch)."""
    from fun_ofdm_tpu.rates import params_for

    batch = 512    # production burst size
    rng = np.random.default_rng(1)
    payloads = jnp.asarray(rng.integers(
        0, 256, size=(batch, length), dtype=np.uint8))
    # serialize reps through a payload-dependent no-op fused INTO the
    # builder (one dispatch per rep; see bench_capture)
    fn = jax.jit(lambda p, o: tx.build_frame_p(
        p ^ (o.sum() > jnp.inf).astype(p.dtype), rate=rate))
    out = fn(payloads, jnp.zeros((), jnp.float32))
    jax.block_until_ready(out)
    reps = 10
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(payloads, out[0][0])
        jax.block_until_ready(out)
        dt = min(dt, (time.perf_counter() - t0) / reps)
    n_samples = batch * params_for(rate).frame_samples(length)
    return n_samples / dt


def run_stream(stream_planar, expected, chunk_feed=4096, prequant=False,
               passes=1, **chain_kwargs):
    """Feed a planar dense stream through a ReceiverChain in chunk_feed
    pieces; return samples/s (best of `passes` timed runs).

    prequant=True quantizes the stream once up front to the chain's
    ingest format and feeds whole supersteps — modeling a radio that
    delivers its native sc16/sc8 buffers (UHD over-the-wire formats).
    """
    from fun_ofdm_tpu.runtime.chain import INGEST_FORMATS, ReceiverChain

    sc_re, sc_im = stream_planar
    n_samples = sc_re.size
    probe = ReceiverChain(**chain_kwargs)
    if prequant:
        from fun_ofdm_tpu.runtime.chain import PACKED_FORMATS, _pack_np
        np_dtype, scale = INGEST_FORMATS[probe.ingest_dtype]
        n_whole = sc_re.size // probe.step * probe.step
        n_samples = n_whole
        if probe.ingest_dtype in PACKED_FORMATS:
            gb, gs = PACKED_FORMATS[probe.ingest_dtype]
            sc_re = _pack_np(sc_re[:n_whole], probe.ingest_dtype, scale)
            sc_im = _pack_np(sc_im[:n_whole], probe.ingest_dtype, scale)
            chunk_feed = probe.step * gb // gs
        else:
            lim = float(np.iinfo(np_dtype).max)
            sc_re = np.clip(np.rint(sc_re[:n_whole] * scale),
                            -lim, lim).astype(np_dtype)
            sc_im = np.clip(np.rint(sc_im[:n_whole] * scale),
                            -lim, lim).astype(np_dtype)
            chunk_feed = probe.step
    best = 0.0
    for _ in range(passes):
        chain = ReceiverChain(**chain_kwargs)
        t0 = time.perf_counter()
        got = 0
        for i in range(0, sc_re.size, chunk_feed):
            got += len(chain.process_samples(
                (sc_re[i:i + chunk_feed], sc_im[i:i + chunk_feed])))
        got += len(chain.flush())
        dt = time.perf_counter() - t0
        if expected is not None:
            assert got >= expected, f"streaming decoded {got}/{expected}"
        best = max(best, n_samples / dt)
    return best


def bench_multichannel(jax, jnp, tx, rate, length, channels=4,
                       passes=2, strides_per_step=256,
                       target_per_channel=4 << 20):
    """Aggregate multi-channel streaming throughput: ONE chain serving
    `channels` synchronized dense streams (multi-antenna site / C
    co-located radios), int10 wire, one fused detection+header dispatch
    and one payload-decode dispatch per length class per superstep
    covering ALL channels (VERDICT r4 #2). Returns aggregate samples/s
    with every planted frame delivered."""
    import time as _time

    from fun_ofdm_tpu.config import ChainParams
    from fun_ofdm_tpu.rates import params_for
    from fun_ofdm_tpu.runtime.chain import ReceiverChain, pack10

    rng = np.random.default_rng(7)
    payloads = rng.integers(0, 256, size=(channels, length), dtype=np.uint8)
    fre, fim = tx.build_frame_p(jnp.asarray(payloads), rate)
    fre, fim = np.asarray(fre), np.asarray(fim)
    frames_per_channel = 8
    unit_re = np.concatenate(
        [np.tile(fre[:, None, :], (1, frames_per_channel, 1)).reshape(
            channels, -1), np.zeros((channels, 2048), np.float32)], axis=1)
    unit_im = np.concatenate(
        [np.tile(fim[:, None, :], (1, frames_per_channel, 1)).reshape(
            channels, -1), np.zeros((channels, 2048), np.float32)], axis=1)
    tiles = max(1, target_per_channel // unit_re.shape[-1])
    s_re = np.tile(unit_re, (1, tiles)).astype(np.float32)
    s_im = np.tile(unit_im, (1, tiles)).astype(np.float32)

    params = ChainParams(strides_per_step=strides_per_step,
                         min_frame_samples=4000)
    probe = ReceiverChain(rates=(rate,), max_length=length, params=params,
                          channels=channels, ingest_dtype="int10")
    n_whole = s_re.shape[-1] // probe.step * probe.step
    pc_re = pack10(s_re[:, :n_whole])
    pc_im = pack10(s_im[:, :n_whole])
    pb = probe.step * 5 // 4
    expected = (n_whole // unit_re.shape[-1]) * frames_per_channel         * channels
    best = 0.0
    for _ in range(passes + 1):   # first pass warms compiles
        chain = ReceiverChain(rates=(rate,), max_length=length,
                              params=params, channels=channels,
                              ingest_dtype="int10")
        t0 = _time.perf_counter()
        got = 0
        for i in range(0, pc_re.shape[-1], pb):
            got += len(chain.process_samples(
                (pc_re[:, i:i + pb], pc_im[:, i:i + pb])))
        got += len(chain.flush())
        dt = _time.perf_counter() - t0
        assert got >= expected, f"multichannel decoded {got}/{expected}"
        best = max(best, channels * n_whole / dt)
    return best


def bench_h2d_roofline(jax, jnp, n_samples=2 << 20, reps=8, passes=3):
    """Sustained H2D wire bandwidth (MB/s) for planar int16 superstep
    buffers - the streaming chain's ingest ceiling (VERDICT r3 item 2:
    state streaming throughput as a fraction of this). Distinct source
    buffers per put (matching the chain's fresh-chunk pattern), best of
    `passes`)."""
    rng = np.random.default_rng(3)
    bufs = [(rng.integers(-32768, 32767, n_samples, dtype=np.int16),
             rng.integers(-32768, 32767, n_samples, dtype=np.int16))
            for _ in range(reps)]
    jax.block_until_ready((jnp.asarray(bufs[0][0]),
                           jnp.asarray(bufs[0][1])))
    best = 0.0
    for _ in range(passes):
        t0 = time.perf_counter()
        outs = [(jnp.asarray(re), jnp.asarray(im)) for re, im in bufs]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - t0
        del outs
        best = max(best, reps * 2 * bufs[0][0].nbytes / dt / 1e6)
    return best


def bench_latency(jax, jnp, tx, rate, length, strides, reps=3,
                  latency_target_ms=None):
    """Sparse-stream delivery latency: wall ms from the frame's LAST
    sample entering process_samples - followed only by idle (zero)
    samples, a radio receiving one lone frame - to its DecodedPacket.
    The K=1 row is the reference's per-4096-chunk cadence; the auto row
    is the production superstep configuration with the adaptive ladder
    (latency_target_ms, VERDICT r4 #4) - without it a sparse stream
    would wait out a full 2^20-sample superstep."""
    from fun_ofdm_tpu.config import ChainParams
    from fun_ofdm_tpu.runtime.chain import ReceiverChain

    payload = np.arange(length, dtype=np.uint8)
    fre, fim = tx.build_frame_p(jnp.asarray(payload[None, :]), rate)
    fre = np.asarray(fre)[0].astype(np.float32)
    fim = np.asarray(fim)[0].astype(np.float32)
    params = ChainParams(strides_per_step=strides,
                         latency_target_ms=latency_target_ms)
    lats = []
    for rep in range(reps + 1):  # first rep warms the compile cache
        chain = ReceiverChain(rates=(rate,), max_length=length,
                              params=params)
        pos = 3000
        n = pos + fre.size + 256
        s_re = np.zeros(n, np.float32)
        s_im = np.zeros(n, np.float32)
        s_re[pos:pos + fre.size] = fre
        s_im[pos:pos + fim.size] = fim
        pkts = chain.process_samples((s_re, s_im))
        t0 = time.perf_counter()
        zeros = (np.zeros(4096, np.float32), np.zeros(4096, np.float32))
        pushed = 0
        # idle fill at the radio's chunk cadence (4096 @ 5 MS/s = 0.8 ms)
        while not pkts and pushed < 64 << 20:
            time.sleep(0.0008)
            pkts = chain.process_samples(zeros)
            pushed += 4096
        if not pkts:
            pkts = chain.flush()
        lat = time.perf_counter() - t0
        assert pkts and pkts[0].start == pos
        if rep:
            lats.append(lat)
    return sorted(lats)[len(lats) // 2] * 1e3


def bench_streaming_cfo(stream_planar, expected, cfo_norm, **chain_kwargs):
    """Streaming run on a CFO-impaired stream with cfo_correct=True (the
    native-mode improvement the reference lacks - its CFO loop is dead
    code, src/timing_sync.cpp:109-112; VERDICT r3 item 9)."""
    s_re, s_im = stream_planar
    n = s_re.size
    ang = (2.0 * np.pi * cfo_norm) * np.arange(n, dtype=np.float64)
    c, s = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    rot = (s_re * c - s_im * s, s_re * s + s_im * c)
    return run_stream(rot, expected, cfo_correct=True, **chain_kwargs)


def build_mixed_rate_stream(jax, jnp, tx, length, target_samples):
    """Dense stream cycling through ALL 11 rates (1500-byte frames,
    64-sample guards), tiled to ~target_samples."""
    from fun_ofdm_tpu.rates import ALL_RATES

    rng = np.random.default_rng(2)
    pieces_re, pieces_im = [], []
    n_unit = 0
    per_rate_payload = {}
    for r in ALL_RATES:
        payload = rng.integers(0, 256, size=(1, length), dtype=np.uint8)
        per_rate_payload[r] = payload
        fre, fim = tx.build_frame_p(jnp.asarray(payload), r)
        fre = np.asarray(fre)[0].astype(np.float32)
        fim = np.asarray(fim)[0].astype(np.float32)
        gap = np.zeros(64, np.float32)
        pieces_re += [fre, gap]
        pieces_im += [fim, gap]
        n_unit += fre.size + 64
    unit_re = np.concatenate(pieces_re)
    unit_im = np.concatenate(pieces_im)
    tiles = max(1, target_samples // n_unit)
    return (np.tile(unit_re, tiles), np.tile(unit_im, tiles)), \
        tiles * len(ALL_RATES)


def main() -> None:
    from fun_ofdm_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import jax
    import jax.numpy as jnp

    from fun_ofdm_tpu.config import ChainParams
    from fun_ofdm_tpu.models import frontend, tx
    from fun_ofdm_tpu.rates import ALL_RATES, Rate

    rate = Rate.RATE_3_4_QAM16
    length = 1500

    capture_sps, payload_mbps, chan0, unit_frames = bench_capture(
        jax, jnp, frontend, tx, rate, length)
    tx_sps = bench_tx(jax, jnp, tx, rate, length)

    # --- streaming: single-rate dense stream -----------------------------
    # chan0 unit = unit_frames x 7120-sample frames + 2048 pad
    unit = chan0[0].size
    tiles = max(1, (30 << 20) // unit)   # ~30 M samples
    s_re = np.tile(chan0[0], tiles)
    s_im = np.tile(chan0[1], tiles)
    n_frames = unit_frames * tiles
    warm_units = max(1, -(-(5 << 20) // unit))   # >= 1 superstep at K=1024
    warm = (s_re[:unit * warm_units], s_im[:unit * warm_units])

    # reference-parity FEED: float32 samples, 4096-sample chunks
    # (NUM_RX_SAMPLES=4096, receiver.h:16); superstep auto (~1M samples).
    # The chain ships int10 over the wire (host-side 10-bit
    # quantization, ~34 dB SNR - transparent at every rate).
    parity_kwargs = dict(rates=(rate,), max_length=length,
                         params=ChainParams(), ingest_dtype="int10")
    run_stream(warm, None, **parity_kwargs)
    streaming_sps = run_stream((s_re, s_im), n_frames, passes=3,
                               **parity_kwargs)

    # tuned: sc16 radio-wire ingest (UHD int16 OTW format, the N210
    # ADC's true precision), 2M-sample supersteps, detection capacity
    # sized for >=4000-sample frames (detect_saturated guards violations)
    tuned_kwargs = dict(rates=(rate,), max_length=length,
                        params=ChainParams(strides_per_step=512,
                                           min_frame_samples=4000),
                        ingest_dtype="int16", prequant=True)
    n_whole = s_re.size // (512 * 4096) * (512 * 4096)
    run_stream(warm, None, **tuned_kwargs)
    tuned_sps = run_stream((s_re, s_im), n_whole // unit * unit_frames,
                           passes=2, **tuned_kwargs)

    # sc12 radio-wire: UHD's 12-bit OTW format (2 samples / 3 bytes),
    # transparent at every rate incl. 64-QAM
    sc12_kwargs = dict(rates=(rate,), max_length=length,
                       params=ChainParams(strides_per_step=512,
                                          min_frame_samples=4000),
                       ingest_dtype="int12", prequant=True)
    n_whole = s_re.size // (512 * 4096) * (512 * 4096)
    run_stream(warm, None, **sc12_kwargs)
    sc12_sps = run_stream((s_re, s_im), n_whole // unit * unit_frames,
                          passes=2, **sc12_kwargs)

    # sc8 radio-wire: UHD int8 OTW format, 4M-sample supersteps
    sc8_kwargs = dict(rates=(rate,), max_length=length,
                      params=ChainParams(strides_per_step=1024,
                                         min_frame_samples=4000),
                      ingest_dtype="int8", prequant=True)
    n_whole = s_re.size // (1024 * 4096) * (1024 * 4096)
    run_stream(warm, None, **sc8_kwargs)
    sc8_sps = run_stream((s_re, s_im), n_whole // unit * unit_frames,
                         passes=3, **sc8_kwargs)

    # --- CFO-impaired stream with native-mode correction ------------------
    n_cfo_units = max(8, -(-(14 << 20) // unit))
    n_cfo = unit * n_cfo_units
    cfo_kwargs = dict(rates=(rate,), max_length=length,
                      params=ChainParams(strides_per_step=256),
                      ingest_dtype="int10")
    # warm pass: cfo_correct=True decode variants compile fresh
    bench_streaming_cfo((s_re[:unit * 2], s_im[:unit * 2]), None,
                        cfo_norm=2e-4, **cfo_kwargs)
    cfo_sps = bench_streaming_cfo(
        (s_re[:n_cfo], s_im[:n_cfo]), n_cfo // unit * unit_frames,
        cfo_norm=2e-4, passes=2, **cfo_kwargs)

    # --- multi-channel aggregate (C=4 and C=16, one chain, one
    # dispatch/stage covering all channels; the wire is shared so the
    # aggregate ceiling is format-bound, not channel-bound) -------------
    mc4_sps = bench_multichannel(jax, jnp, tx, rate, length, channels=4)
    mc16_sps = bench_multichannel(jax, jnp, tx, rate, length, channels=16,
                                  strides_per_step=64,
                                  target_per_channel=1 << 20)

    # --- delivery latency (K=1 reference-cadence and auto superstep) ------
    lat_k1_ms = bench_latency(jax, jnp, tx, rate, length, strides=1)
    # auto superstep + adaptive ladder: sparse tails flush to the device
    # at the transport's latency floor instead of waiting out a full
    # 2^20-sample superstep
    lat_auto_ms = bench_latency(jax, jnp, tx, rate, length, strides=None,
                                latency_target_ms=40.0)

    # --- H2D wire roofline -------------------------------------------------
    h2d_mbps = bench_h2d_roofline(jax, jnp)

    # --- streaming all-rates (the Receiver default config) ---------------
    # int10 wire format (4 samples / 5 bytes, ~34 dB quantization SNR -
    # transparent through 64-QAM at 17% fewer bytes than sc12).
    # min_frame_samples=4000: the shortest 1500-byte frame of any rate
    # is 4880 samples; header_slots=384 sizes the SIGNAL budget to the
    # stream's ~314 frames/superstep (overflow re-runs a full pass,
    # nothing lost).
    mixed, n_mixed = build_mixed_rate_stream(
        jax, jnp, tx, length, target_samples=12 << 20)
    allrates_kwargs = dict(rates=ALL_RATES, max_length=length,
                           params=ChainParams(strides_per_step=512,
                                              min_frame_samples=4000,
                                              header_slots=384),
                           ingest_dtype="int10", prequant=True)
    run_stream((mixed[0][:3 << 20], mixed[1][:3 << 20]), None,
               **allrates_kwargs)
    mixed_unit = mixed[0].size * len(ALL_RATES) // n_mixed
    n_whole = mixed[0].size // (512 * 4096) * (512 * 4096)
    allrates_sps = run_stream(
        mixed, n_whole // mixed_unit * len(ALL_RATES), passes=5,
        **allrates_kwargs)

    print(json.dumps({
        "metric": "dense_rx_throughput",
        "value": capture_sps,
        "unit": "samples/s",
        "vs_baseline": capture_sps / REFERENCE_SAMPLES_PER_SEC,
        "streaming_samples_per_sec": streaming_sps,
        "streaming_vs_baseline": streaming_sps / REFERENCE_SAMPLES_PER_SEC,
        "streaming_tuned_samples_per_sec": tuned_sps,
        "streaming_tuned_vs_baseline":
            tuned_sps / REFERENCE_SAMPLES_PER_SEC,
        "streaming_sc12_samples_per_sec": sc12_sps,
        "streaming_sc12_vs_baseline":
            sc12_sps / REFERENCE_SAMPLES_PER_SEC,
        "streaming_sc8_samples_per_sec": sc8_sps,
        "streaming_sc8_vs_baseline":
            sc8_sps / REFERENCE_SAMPLES_PER_SEC,
        "streaming_allrates_samples_per_sec": allrates_sps,
        "streaming_allrates_vs_baseline":
            allrates_sps / REFERENCE_SAMPLES_PER_SEC,
        "streaming_cfo_samples_per_sec": cfo_sps,
        "streaming_cfo_vs_baseline": cfo_sps / REFERENCE_SAMPLES_PER_SEC,
        "multichannel_c4_samples_per_sec": mc4_sps,
        "multichannel_c4_vs_baseline": mc4_sps / REFERENCE_SAMPLES_PER_SEC,
        "multichannel_c16_samples_per_sec": mc16_sps,
        "multichannel_c16_vs_baseline":
            mc16_sps / REFERENCE_SAMPLES_PER_SEC,
        "latency_k1_ms": lat_k1_ms,
        "latency_auto_ms": lat_auto_ms,
        "h2d_roofline_mbps": h2d_mbps,
        "tx_samples_per_sec": tx_sps,
        "tx_vs_baseline": tx_sps / REFERENCE_SAMPLES_PER_SEC,
        "decoded_payload_mbps": payload_mbps,
    }))


if __name__ == "__main__":
    main()
