#!/usr/bin/env python3
"""Measure streaming delivery latency vs superstep size.

The reference chain's real-time contract is per-4096-chunk processing at
5 MS/s (a ~0.8 ms chunk cadence, src/receiver.cpp:42-58); the superstep
runtime trades delivery latency for throughput. This reports, per
strides_per_step: wall latency from the moment the frame's last sample
is pushed until its DecodedPacket is returned, plus the stream-time
component (samples buffered before the owning superstep even dispatches).

Usage: python tools/latency_probe.py [--ks 1,16,256]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ks", type=str, default="1,16,256")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from fun_ofdm_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    import jax.numpy as jnp

    from fun_ofdm_tpu.config import ChainParams
    from fun_ofdm_tpu.models import tx
    from fun_ofdm_tpu.rates import Rate
    from fun_ofdm_tpu.runtime.chain import ReceiverChain

    rate = Rate.RATE_3_4_QAM16
    length = 1500
    payload = np.arange(length, dtype=np.uint8)
    fre, fim = tx.build_frame_p(jnp.asarray(payload[None, :]), rate)
    fre = np.asarray(fre)[0].astype(np.float32)
    fim = np.asarray(fim)[0].astype(np.float32)

    for k in [int(x) for x in args.ks.split(",")]:
        params = ChainParams(strides_per_step=k)
        lats = []
        for rep in range(args.reps + 1):  # first rep warms compile
            chain = ReceiverChain(rates=(rate,), max_length=length,
                                  params=params)
            # ownership of superstep r covers global
            # [(r-1)*step - halo, r*step - halo): place the frame start at
            # the top of roll 2's owned range so the frame's last sample
            # arrives just as its owning superstep triggers (the minimal-
            # delay position), then measure wall time from that trigger
            # push to packet delivery
            halo = chain.window - chain.step
            pos = 2 * chain.step - halo - 128
            assert pos >= 0, f"frame does not fit before roll 2"
            n = 2 * chain.step
            s_re = np.zeros(n, np.float32)
            s_im = np.zeros(n, np.float32)
            s_re[pos:pos + fre.size] = fre
            s_im[pos:pos + fim.size] = fim
            pkts = chain.process_samples((s_re[:n - 4096], s_im[:n - 4096]))
            t0 = time.perf_counter()
            pkts = pkts or chain.process_samples(
                (s_re[n - 4096:], s_im[n - 4096:]))
            # keep pushing idle chunks until the packet arrives (the
            # pipeline needs subsequent supersteps to trigger its syncs)
            zeros = (np.zeros(4096, np.float32), np.zeros(4096, np.float32))
            pushed = 0
            while not pkts and pushed < 100 * chain.step:
                pkts = chain.process_samples(zeros)
                pushed += 4096
            if not pkts:
                pkts = chain.flush()
            lat = time.perf_counter() - t0
            assert pkts and pkts[0].start == pos, (k, rep, pkts)
            if rep:
                lats.append((lat, pushed))
        wall = sorted(x[0] for x in lats)[len(lats) // 2]
        pushed = max(x[1] for x in lats)
        print(json.dumps({
            "strides_per_step": k,
            "superstep_samples": k * 4096,
            "median_wall_latency_ms": round(wall * 1e3, 1),
            "extra_samples_until_delivery": pushed,
            "stream_time_at_5msps_ms":
                round((k * 4096 + pushed) / 5e6 * 1e3, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
