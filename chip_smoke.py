#!/usr/bin/env python3
"""Run the 802.11a RX/TX main path once on the GPU and check every result.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: only the sharded phase

Phases (one process; a second JAX process on the same card would fail
for want of device memory):

  device   the card's name and power limit (nvidia-smi) and jax.devices();
           fails unless the default device is a GPU.
  viterbi  the compiled Viterbi decoders (the Triton kernel and the
           block-overlap decode around it) against the lax.scan reference,
           bit for bit, at 1500-byte RATE_3_4_QAM16 trellises (batch 1, 4,
           16, 64, 512), the shortest and longest 1500-byte trellis of the
           11 rates, and a renormalization-hot noisy 3600-bit case.
  golden   the GPU path on tests/golden/golden.npz (vectors from the
           compiled C++ reference) and tests/golden_model.py (NumPy f64).
  capture  frontend.receive_capture_p vmapped over 16 channels x 32
           1500-byte RATE_3_4_QAM16 frames.
  stream   ReceiverChain.process_samples + flush() on one second of a
           20 MHz channel (2e7 samples) of 1500-byte frames cycling all 11
           rates, default ChainParams, float32 and int16 ingest, and again
           with the exact Viterbi forced.
  tx       Transmitter.send_burst of 512 x 1500 B onto a LoopbackRadio,
           received by a Receiver.
  sharded  (--cards 4 only) sharded_receive and sharded_receive_dynamic
           on a 2x2 (channel, time) mesh, 16 channels x 2^22 samples,
           against single-card receive_capture_p on the same capture.

Every phase prints its wall and XLA compile seconds. Any failure makes
the script exit non-zero with {"ok": false, ...} as its last line; on
success the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
LENGTH = 1500

_compile_s = [0.0]


def _on_duration(event: str, duration: float, **_) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --- device ----------------------------------------------------------------

def phase_device(cards: int) -> dict:
    import jax

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({e})"
    log(f"nvidia-smi: {smi}")
    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    d0 = devs[0]
    check(d0.platform == "gpu",
          f"default device is {d0.platform!r}, not a GPU")
    check(len(devs) >= cards, f"{cards} cards asked for, {len(devs)} found")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


# --- viterbi ---------------------------------------------------------------

def _coded_soft(rng, batch: int, nbits: int, noise: int) -> np.ndarray:
    """Random data bits, convolutionally encoded, as noisy soft bits."""
    import jax.numpy as jnp

    from fun_ofdm_tpu.ops import convcode

    bits = rng.integers(0, 2, size=(batch, nbits + 6))
    bits[:, nbits:] = 0
    coded = np.asarray(convcode.conv_encode(jnp.asarray(bits)))
    return np.clip(coded * 255 + rng.integers(-noise, noise + 1, coded.shape),
                   0, 255).astype(np.int32)


def viterbi_cases(batches=(1, 4, 16, 64, 512)):
    """(label, batch, nbits, noise) of the Viterbi checks."""
    from fun_ofdm_tpu.rates import ALL_RATES, Rate, params_for

    def nb(r):
        return params_for(r).num_data_bits(LENGTH) - 6

    qam16 = nb(Rate.RATE_3_4_QAM16)
    nbs = sorted(nb(r) for r in ALL_RATES)
    cases = [(f"qam16_3/4 b={b}", b, qam16, 60) for b in batches]
    cases += [("shortest b=16", 16, nbs[0], 60),
              ("longest b=16", 16, nbs[-1], 60),
              ("renorm-hot b=2", 2, 3600, 110)]
    return cases


def phase_viterbi(cases) -> dict:
    import jax
    import jax.numpy as jnp

    from fun_ofdm_tpu.ops import viterbi

    rng = np.random.default_rng(0)
    info = {}
    for label, batch, nbits, noise in cases:
        soft = jnp.asarray(_coded_soft(rng, batch, nbits, noise))
        ref = np.asarray(jax.jit(functools.partial(
            viterbi.viterbi_decode_scan, nbits=nbits))(soft))
        t0 = time.perf_counter()
        got = np.asarray(jax.jit(functools.partial(
            viterbi.viterbi_decode, nbits=nbits))(soft))
        t_exact = time.perf_counter() - t0
        check(np.array_equal(got, ref),
              f"viterbi {label}: exact decoder differs from the scan in "
              f"{int((got != ref).sum())} bits")
        blk, ok = jax.jit(functools.partial(
            viterbi.viterbi_decode, nbits=nbits, impl="blocked",
            return_exact=True))(soft)
        blk, ok = np.asarray(blk), np.asarray(ok)
        differs = (blk != ref).any(axis=-1)
        check(not (differs & ok).any(),
              f"viterbi {label}: blocked decode differs from the scan on a "
              f"frame its merge guard passed")
        info[label] = {"exact_first_s": round(t_exact, 3),
                       "blocked_flagged": int((~ok).sum())}
        log(f"  viterbi {label} nbits={nbits}: exact bit-exact; blocked "
            f"flagged {int((~ok).sum())}/{batch}, unflagged frames exact")
    return info


# --- golden ----------------------------------------------------------------

def phase_golden() -> dict:
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import golden_model as gm

    from fun_ofdm_tpu.models import frontend
    from fun_ofdm_tpu.ops import fft64, qam, viterbi
    from fun_ofdm_tpu.rates import ALL_RATES
    from fun_ofdm_tpu.utils.bits import np_bits_to_bytes

    g = np.load(os.path.join(REPO, "tests", "golden", "golden.npz"))
    length, pos = 120, 200
    worst_soft = 0
    for r in ALL_RATES:
        # detection start and payload of the reference's own frame
        frame = g[f"frame_r{int(r)}"].astype(np.complex64)
        n = pos + frame.size + 400
        re = np.zeros(n, np.float32)
        im = np.zeros(n, np.float32)
        re[pos:pos + frame.size] = frame.real
        im[pos:pos + frame.size] = frame.imag
        out = jax.jit(functools.partial(
            frontend.receive_capture_p, rate=r, length=length,
            max_frames=2))((jnp.asarray(re), jnp.asarray(im)))
        ok = np.asarray(out["crc_ok"])
        starts = np.asarray(out["starts"])[ok]
        check(list(starts) == [pos],
              f"golden {r.name}: detected starts {list(starts)} != [{pos}]")
        k = int(np.nonzero(ok)[0][0])
        payload = np.asarray(out["payload"])[k, :length].astype(np.uint8)
        check(np.array_equal(payload, g[f"decode_r{int(r)}"]),
              f"golden {r.name}: payload differs from the reference's")

        # soft bits: the f32 DFT (full f32 matmuls) + demap on the card
        # against the f64 NumPy oracle, within one quantization level
        data = frame[400:].reshape(-1, 80)[:, 16:]          # CP removed
        f_re, f_im = jax.jit(fft64.forward_p)(
            (jnp.asarray(data.real), jnp.asarray(data.imag)))
        soft = np.asarray(jax.jit(functools.partial(
            qam.demodulate_p, rate=r))((f_re, f_im)))
        want = np.concatenate([
            gm.demodulate(gm.fft_centered(row.astype(np.complex128)), int(r))
            for row in data])
        worst = int(np.abs(soft.reshape(-1) - want).max())
        worst_soft = max(worst_soft, worst)
        check(worst <= 1,
              f"golden {r.name}: soft bits differ from the f64 oracle by "
              f"{worst} levels (> 1)")

    # the reference's noisy soft-decision Viterbi vector, bit for bit
    nbits = 800
    bits = np.asarray(jax.jit(functools.partial(
        viterbi.viterbi_decode, nbits=nbits))(
        jnp.asarray(g["vit_soft"].astype(np.int32))))
    got = np_bits_to_bytes(bits).astype(np.uint8)[: nbits // 8]
    check(np.array_equal(got, g["vit_bits"][: nbits // 8]),
          "golden: Viterbi differs from the reference's SSE decoder")
    log(f"  golden: 11 rates detected at {pos} with the reference's payload;"
        f" soft bits within {worst_soft} level(s) of the f64 oracle"
        f" (matmuls at Precision.HIGHEST); Viterbi vector bit-exact")
    return {"worst_soft_level": worst_soft}


# --- capture ---------------------------------------------------------------

def build_capture(channels: int, frames: int, rate, length: int, seed: int):
    """(re, im, planted): each channel holds `frames` distinct back-to-back
    frames then 2048 zeros; planted[c] = [(start, payload bytes)]."""
    import jax.numpy as jnp

    from fun_ofdm_tpu.models import tx

    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 256, size=(channels, frames, length),
                       dtype=np.uint8)
    fre, fim = tx.build_frame_p_jit(rate)(jnp.asarray(pay))
    fre, fim = np.asarray(fre), np.asarray(fim)
    flen = fre.shape[-1]
    pad = np.zeros((channels, 2048), np.float32)
    re = np.concatenate([fre.reshape(channels, -1), pad], axis=1)
    im = np.concatenate([fim.reshape(channels, -1), pad], axis=1)
    planted = [[(f * flen, pay[c, f].tobytes()) for f in range(frames)]
               for c in range(channels)]
    return re, im, planted


def delivered_capture(out, length: int):
    """Per-channel sorted [(start, payload bytes)] of CRC-valid slots."""
    ok = np.asarray(out["crc_ok"])
    starts = np.asarray(out["starts"])
    pay = np.asarray(out["payload"])
    res = []
    for c in range(ok.shape[0]):
        res.append(sorted(
            (int(starts[c, k]), pay[c, k, :length].astype(np.uint8).tobytes())
            for k in np.nonzero(ok[c])[0]))
    return res


def phase_capture(channels: int = 16, frames: int = 32) -> dict:
    import jax
    import jax.numpy as jnp

    from fun_ofdm_tpu.models import frontend
    from fun_ofdm_tpu.rates import Rate

    rate = Rate.RATE_3_4_QAM16
    re, im, planted = build_capture(channels, frames, rate, LENGTH, seed=1)
    fn = jax.jit(jax.vmap(lambda r, i: frontend.receive_capture_p(
        (r, i), rate=rate, length=LENGTH, max_frames=frames)))
    args = (jnp.asarray(re), jnp.asarray(im))
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = compiled(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    got = delivered_capture(out, LENGTH)
    for c in range(channels):
        check(got[c] == planted[c],
              f"capture channel {c}: delivered {len(got[c])} frames, "
              f"planted {len(planted[c])}, or starts/payloads differ")
    log(f"  capture: {channels}x{frames} frames delivered exactly once; "
        f"compile {t_compile:.1f} s, one call {t_run * 1e3:.1f} ms "
        f"({re.size / t_run / 1e6:.1f} Msample/s)")
    return {"compile_s": round(t_compile, 2), "call_ms": round(t_run * 1e3, 2)}


# --- stream ----------------------------------------------------------------

def build_mixed_stream(n_samples: int, length: int, seed: int, gap: int = 64):
    """Back-to-back frames cycling all 11 rates (distinct payloads,
    `gap` zeros after each) filling n_samples; returns (re, im, planted)."""
    import jax.numpy as jnp

    from fun_ofdm_tpu.models import tx
    from fun_ofdm_tpu.rates import ALL_RATES, params_for

    rng = np.random.default_rng(seed)
    unit = sum(params_for(r).frame_samples(length) + gap for r in ALL_RATES)
    cycles = n_samples // unit + 1
    frames = {}
    for r in ALL_RATES:
        pay = rng.integers(0, 256, size=(cycles, length), dtype=np.uint8)
        fre, fim = tx.build_frame_p_jit(r)(jnp.asarray(pay))
        frames[r] = (pay, np.asarray(fre), np.asarray(fim))
    re = np.zeros(n_samples, np.float32)
    im = np.zeros(n_samples, np.float32)
    planted = []
    pos = 0
    for cyc in range(cycles):
        for r in ALL_RATES:
            pay, fre, fim = frames[r]
            flen = fre.shape[-1]
            if pos + flen > n_samples:
                return re, im, planted
            re[pos:pos + flen] = fre[cyc]
            im[pos:pos + flen] = fim[cyc]
            planted.append((pos, pay[cyc].tobytes()))
            pos += flen + gap
    return re, im, planted


def run_chain(re, im, feed: int, **kwargs):
    from fun_ofdm_tpu.runtime.chain import ReceiverChain

    chain = ReceiverChain(**kwargs)
    pkts = []
    for i in range(0, re.size, feed):
        pkts += chain.process_samples((re[i:i + feed], im[i:i + feed]))
    pkts += chain.flush()
    return sorted((p.start, p.payload) for p in pkts), chain


def phase_stream(n_samples: int = 20_000_000, feed: int = 1 << 16) -> dict:
    from fun_ofdm_tpu.rates import ALL_RATES

    re, im, planted = build_mixed_stream(n_samples, LENGTH, seed=2)
    info = {}
    ref = None
    for label, kw in (("float32", {"ingest_dtype": "float32"}),
                      ("int16", {"ingest_dtype": "int16"}),
                      ("float32 exact", {"ingest_dtype": "float32",
                                         "viterbi_impl": "exact"})):
        c0 = _compile_s[0]
        t0 = time.perf_counter()
        got, chain = run_chain(re, im, feed, rates=ALL_RATES,
                               max_length=LENGTH, **kw)
        dt = time.perf_counter() - t0
        cut = chain.step
        check(got == planted,
              f"stream {label}: delivered {len(got)} frames, planted "
              f"{len(planted)}, or starts/payloads differ")
        straddle = [s for s, _ in planted
                    if s // cut != (s + 4000) // cut]
        check(straddle, f"stream {label}: no frame straddles a superstep cut")
        if ref is not None:
            check(got == ref, f"stream {label}: delivered set differs")
        ref = got
        st = chain.stats
        info[label] = {"wall_s": round(dt, 2),
                       "compile_s": round(_compile_s[0] - c0, 2),
                       "superstep": cut,
                       "viterbi_fallbacks": st.viterbi_fallbacks}
        log(f"  stream {label}: {len(got)} frames of 11 rates delivered "
            f"exactly once ({len(straddle)} straddle a {cut}-sample "
            f"superstep cut); {dt:.1f} s incl. {_compile_s[0] - c0:.1f} s "
            f"compile; merge-guard re-decodes {st.viterbi_fallbacks}")
    return info


# --- tx --------------------------------------------------------------------

def phase_tx(frames: int = 512, timeout_s: float = 240.0) -> dict:
    import threading

    from fun_ofdm_tpu import api
    from fun_ofdm_tpu.rates import Rate
    from fun_ofdm_tpu.runtime.io import LoopbackRadio

    rate = Rate.RATE_3_4_QAM16
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, LENGTH, dtype=np.uint8).tobytes()
                for _ in range(frames)]
    radio = LoopbackRadio(capacity=1 << 23)
    got = []
    lock = threading.Lock()

    def on_packets(pkts):
        with lock:
            got.extend(p.payload for p in pkts)

    rx = api.Receiver(on_packets, source=radio, max_length=LENGTH)
    t0 = time.perf_counter()
    n = api.Transmitter(sink=radio).send_burst(payloads, rate)
    t_tx = time.perf_counter() - t0
    while radio.pending and time.perf_counter() - t0 < timeout_s:
        time.sleep(0.05)
    rx.stop()
    dt = time.perf_counter() - t0
    check(sorted(got) == sorted(payloads),
          f"tx: {len(got)} packets received, {frames} sent, or payloads "
          f"differ")
    log(f"  tx: {frames} frames ({n} samples) sent in {t_tx:.2f} s and "
        f"all received by Receiver in {dt:.1f} s")
    return {"send_s": round(t_tx, 2), "loop_s": round(dt, 2)}


# --- sharded (four cards) --------------------------------------------------

def phase_sharded(devices, channels: int = 16, n: int = 1 << 22,
                  per_channel: int = 48) -> dict:
    """sharded_receive(_dynamic) on a 2x2 mesh vs one-card capture."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fun_ofdm_tpu.models import frontend, tx
    from fun_ofdm_tpu.parallel import mesh as mesh_lib, stream_shard
    from fun_ofdm_tpu.rates import Rate, params_for

    rate = Rate.RATE_3_4_QAM16
    flen = params_for(rate).frame_samples(LENGTH)
    mesh = mesh_lib.make_mesh(devices, channel=2, time=2)
    cut = n // 2
    rng = np.random.default_rng(4)
    # frames spread over each channel, one straddling the time cut
    step = (n - flen - 4096) // per_channel
    starts = [1000 + k * step for k in range(per_channel)]
    starts = sorted(set(starts) | {cut - flen // 2})
    starts = [s for i, s in enumerate(starts)
              if i == 0 or s - starts[i - 1] >= flen + 64]
    pay = rng.integers(0, 256, size=(channels, len(starts), LENGTH),
                       dtype=np.uint8)
    fre, fim = tx.build_frame_p_jit(rate)(jnp.asarray(pay))
    fre, fim = np.asarray(fre), np.asarray(fim)
    re = np.zeros((channels, n), np.float32)
    im = np.zeros((channels, n), np.float32)
    for c in range(channels):
        for k, s in enumerate(starts):
            re[c, s:s + flen] = fre[c, k]
            im[c, s:s + flen] = fim[c, k]
    planted = [sorted((s, pay[c, k].tobytes()) for k, s in enumerate(starts))
               for c in range(channels)]

    sharding = NamedSharding(mesh, P("channel", "time"))
    sre = jax.device_put(jnp.asarray(re), sharding)
    sim = jax.device_put(jnp.asarray(im), sharding)
    on = sorted({d.id for s in sre.addressable_shards for d in [s.device]})
    check(len(on) == len(devices),
          f"sharded capture landed on devices {on}, not all {len(devices)}")
    slots = len(starts) + 8
    info = {"devices": on}

    # one card: the plain whole-capture receiver, channel by channel
    one = jax.jit(jax.vmap(lambda r, i: frontend.receive_capture_p(
        (r, i), rate=rate, length=LENGTH, max_frames=slots)))
    d0 = devices[0]
    t0 = time.perf_counter()
    ref = delivered_capture(one(jax.device_put(re, d0),
                                jax.device_put(im, d0)), LENGTH)
    info["one_card_s"] = round(time.perf_counter() - t0, 2)
    check(ref == planted, "one-card capture missed or duplicated a frame")

    for name, fn in (
            ("sharded_receive", functools.partial(
                stream_shard.sharded_receive, rate=rate, length=LENGTH,
                mesh=mesh, max_frames_per_block=slots)),
            ("sharded_receive_dynamic", functools.partial(
                stream_shard.sharded_receive_dynamic, rates=(rate,),
                max_length=LENGTH, mesh=mesh, max_frames_per_block=slots))):
        t0 = time.perf_counter()
        out = jax.jit(fn)((sre, sim))
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        got = delivered_capture(out, LENGTH)
        check(got == ref, f"{name}: delivered set differs from one card's")
        info[name + "_s"] = round(dt, 2)
        log(f"  {name}: {sum(map(len, got))} frames on a 2x2 mesh over "
            f"devices {on} equal the one-card result ({dt:.1f} s incl. "
            f"compile)")
    return info


# --- main ------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded phase over 4 local cards")
    args = ap.parse_args()
    device = None
    results = {}
    try:
        import jax
        import jax.monitoring

        sys.path.insert(0, REPO)
        from fun_ofdm_tpu.utils.cache import enable_persistent_cache

        jax.monitoring.register_event_duration_secs_listener(_on_duration)
        device = phase_device(args.cards)
        log(f"compile cache: {enable_persistent_cache()}")
        if args.cards == 4:
            phases = [("sharded",
                       lambda: phase_sharded(jax.devices()[:4]))]
        else:
            phases = [("viterbi", lambda: phase_viterbi(viterbi_cases())),
                      ("golden", phase_golden),
                      ("capture", phase_capture),
                      ("stream", phase_stream),
                      ("tx", phase_tx)]
        for name, run in phases:
            c0 = _compile_s[0]
            t0 = time.perf_counter()
            log(f"[{name}]")
            info = run()
            wall = time.perf_counter() - t0
            comp = _compile_s[0] - c0
            results[name] = {"wall_s": round(wall, 2),
                             "compile_s": round(comp, 2), **info}
            log(f"[{name}] ok: {wall:.1f} s wall, {comp:.1f} s XLA compile")
    except Exception as e:  # noqa: BLE001 - any failure fails the smoke
        traceback.print_exc()
        log(json.dumps({"phases": results}))
        log(json.dumps({"ok": False, "error": f"{type(e).__name__}: {e}"}))
        return 1
    log(json.dumps({"phases": results}))
    log(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
