#!/usr/bin/env python3
"""Multi-chip / multi-host scaling benchmark (BASELINE north-star harness).

Measures dense-stream RX throughput (samples/s) of the sharded streaming
receive at increasing device counts and reports per-chip efficiency vs the
1-device run — the ">=80% 1->N scaling" target from BASELINE.md. Run it
unchanged on a real pod slice (one process per host, `jax.distributed`
via env) or on a CPU rig:

  # single host, all local devices:
  python tools/scaling_bench.py

  # CPU smoke (8 virtual devices):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/scaling_bench.py --devices 1 2 4 8

  # multi-host pod slice (same command on every host):
  python tools/scaling_bench.py --distributed

Prints one JSON line per device count:
  {"devices": N, "samples_per_sec": X, "per_chip": Y, "efficiency": Z}
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def bench_devices(n_dev: int, rate, length: int, reps: int,
                  axis: str = "time") -> float:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from fun_ofdm_tpu.models import tx
    from fun_ofdm_tpu.parallel import mesh as mesh_lib, stream_shard
    from fun_ofdm_tpu.rates import params_for

    devices = jax.devices()[:n_dev]
    # scale along one mesh axis: "time" = one long capture in overlap-save
    # blocks (ppermute halo on the cut); "channel" = independent RF
    # channels, no cross-device communication
    if axis == "time":
        mesh = mesh_lib.make_mesh(devices, channel=1, time=n_dev)
    else:
        mesh = mesh_lib.make_mesh(devices, channel=n_dev, time=1)

    frame_len = params_for(rate).frame_samples(length)
    frames_per_block = 8
    # weak scaling: time axis grows the capture length, channel axis grows
    # the independent channel count
    channels = 16 * (n_dev if axis == "channel" else 1)
    block = frames_per_block * frame_len + 2048
    n = block * (n_dev if axis == "time" else 1)

    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 256, size=(channels, length), dtype=np.uint8)
    fre, fim = tx.build_frame_p(jnp.asarray(payloads), rate)
    fre, fim = np.asarray(fre), np.asarray(fim)
    s_re = np.zeros((channels, n), np.float32)
    s_im = np.zeros((channels, n), np.float32)
    pos = 0
    while pos + frame_len <= n:  # dense back-to-back frames
        s_re[:, pos:pos + frame_len] = fre
        s_im[:, pos:pos + frame_len] = fim
        pos += frame_len

    spec = P(None, "time") if axis == "time" else P("channel", None)
    sharding = NamedSharding(mesh, spec)
    streams = (jax.device_put(jnp.asarray(s_re), sharding),
               jax.device_put(jnp.asarray(s_im), sharding))

    max_frames = block // frame_len + 2
    fn = jax.jit(functools.partial(
        stream_shard.sharded_receive, rate=rate, length=length,
        mesh=mesh, max_frames_per_block=max_frames))
    out = fn(streams)
    jax.block_until_ready(out)

    # serialize reps: each rep consumes the previous one's output
    chain = jax.jit(lambda re_s, ok: re_s + 0.0 * ok.sum().astype(re_s.dtype))
    ok_dev = out["crc_ok"]
    jax.block_until_ready(chain(streams[0], ok_dev))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn((chain(streams[0], ok_dev), streams[1]))
        ok_dev = out["crc_ok"]
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / reps
    return s_re.size / dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="device counts to sweep (default 1,2,4,...,all)")
    ap.add_argument("--rate", default="RATE_3_4_QAM16")
    ap.add_argument("--length", type=int, default=1500)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--axis", choices=("time", "channel"), default="time",
                    help="mesh axis to scale (time = overlap-save blocks "
                         "with halo exchange; channel = independent "
                         "channels, no communication)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host: jax.distributed.initialize() from env")
    args = ap.parse_args()

    if args.distributed:
        from fun_ofdm_tpu.parallel import distributed
        distributed.initialize()

    import jax

    from fun_ofdm_tpu.rates import Rate
    from fun_ofdm_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    rate = Rate[args.rate]
    n_all = len(jax.devices())
    counts = args.devices
    if not counts:
        counts, c = [], 1
        while c <= n_all:
            counts.append(c)
            c *= 2
        if counts[-1] != n_all:
            counts.append(n_all)

    base = None
    for n_dev in counts:
        sps = bench_devices(n_dev, rate, args.length, args.reps,
                            axis=args.axis)
        if base is None:
            base = sps / n_dev
        rec = {
            "axis": args.axis,
            "devices": n_dev,
            "samples_per_sec": sps,
            "per_chip": sps / n_dev,
            "efficiency": (sps / n_dev) / base,
        }
        if jax.process_index() == 0:
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
