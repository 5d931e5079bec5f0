#!/usr/bin/env python3
"""Measure host<->device transfer + dispatch latency on this transport.

The streaming ReceiverChain's operating point is set by per-transaction
latency as much as by bandwidth; this probe measures the curve so the
fetch pad (FETCH_PAD_BYTES) and superstep stride are chosen from data.

Usage: python tools/transport_probe.py [--reps N]
Prints one JSON line per measurement.
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
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    print(json.dumps({"device": str(dev)}))

    sizes = [1 << k for k in range(12, 24)]  # 4 KB .. 8 MB

    # --- D2H: np.asarray on a device buffer (the chain's sync fetch) -----
    # Each rep fetches a DIFFERENT buffer (outputs of a jitted add with
    # varying scalar) so no caching; buffers are blocked-ready before
    # timing so only the fetch is measured.
    f = jax.jit(lambda x, c: x + c)
    for size in sizes:
        n = size  # uint8 elements
        base = jax.device_put(jnp.zeros(n, jnp.uint8), dev)
        bufs = [f(base, np.uint8(i)) for i in range(args.reps)]
        jax.block_until_ready(bufs)
        ts = []
        for b in bufs:
            t0 = time.perf_counter()
            np.asarray(b)
            ts.append(time.perf_counter() - t0)
        print(json.dumps({"op": "d2h_sync", "bytes": size,
                          "ms_min": min(ts) * 1e3,
                          "ms_med": sorted(ts)[len(ts) // 2] * 1e3}))

    # --- D2H with copy_to_host_async started first -----------------------
    for size in sizes:
        n = size
        base = jax.device_put(jnp.zeros(n, jnp.uint8), dev)
        bufs = [f(base, np.uint8(i + 100)) for i in range(args.reps)]
        jax.block_until_ready(bufs)
        ts = []
        for b in bufs:
            t0 = time.perf_counter()
            ca = getattr(b, "copy_to_host_async", None)
            if ca is not None:
                ca()
            np.asarray(b)
            ts.append(time.perf_counter() - t0)
        print(json.dumps({"op": "d2h_async_then_get", "bytes": size,
                          "ms_min": min(ts) * 1e3,
                          "ms_med": sorted(ts)[len(ts) // 2] * 1e3}))

    # --- H2D: device_put + block ----------------------------------------
    for size in sizes:
        arrs = [np.full(size, i, np.uint8) for i in range(args.reps)]
        ts = []
        for a in arrs:
            t0 = time.perf_counter()
            jax.block_until_ready(jax.device_put(a, dev))
            ts.append(time.perf_counter() - t0)
        print(json.dumps({"op": "h2d_sync", "bytes": size,
                          "ms_min": min(ts) * 1e3,
                          "ms_med": sorted(ts)[len(ts) // 2] * 1e3}))

    # --- dispatch latency: trivial jitted fn, async return ---------------
    g = jax.jit(lambda x: x * 2)
    x = jax.device_put(jnp.zeros(1024, jnp.float32), dev)
    jax.block_until_ready(g(x))
    ts = []
    for _ in range(args.reps * 4):
        t0 = time.perf_counter()
        y = g(x)
        ts.append(time.perf_counter() - t0)
        x = y
    jax.block_until_ready(x)
    print(json.dumps({"op": "dispatch_async", "ms_min": min(ts) * 1e3,
                      "ms_med": sorted(ts)[len(ts) // 2] * 1e3}))

    # --- round trip: dispatch trivial + block (ping) ---------------------
    ts = []
    for _ in range(args.reps * 4):
        t0 = time.perf_counter()
        x = g(x)
        jax.block_until_ready(x)
        ts.append(time.perf_counter() - t0)
    print(json.dumps({"op": "dispatch_block_rt", "ms_min": min(ts) * 1e3,
                      "ms_med": sorted(ts)[len(ts) // 2] * 1e3}))


if __name__ == "__main__":
    main()
