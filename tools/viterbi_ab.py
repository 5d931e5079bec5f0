#!/usr/bin/env python3
"""A/B of the Viterbi decoders on the GPU: the Triton kernel, the
block-overlap decode around it, and the plain lax.scan (several unrolls).

    python tools/viterbi_ab.py [--part micro|capture|chain|e2e|all] [--reps N]
                               [--out FILE.json]

micro: each decoder alone (forward pass alone for the kernel) at batch 1,
       4, 16, 64 and 512 of 1500-byte RATE_3_4_QAM16 trellises, and at
       batch 16 for the shortest and longest 1500-byte trellis of the 11
       rates. Median wall ms of N calls after a compiling call.
capture: the decoders inside the capture megagraph (16 channels x 32
       1500-byte RATE_3_4_QAM16 frames through receive_capture_p).
chain: ReceiverChain's viterbi_impl values on a mixed all-rates stream.
e2e:   capture and chain; each timed in turns within this one process.

Prints one JSON line per row; with --out, also writes every row, with
the card's name and power limit, to that file. Needs a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (stream and capture builders)

LENGTH = 1500


def timed(fn, args, reps: int):
    """(first-call s incl. compile, median ms of reps warm calls)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return first, float(np.median(ts))


def micro(reps: int) -> list:
    import jax
    import jax.numpy as jnp

    from fun_ofdm_tpu.ops import viterbi, viterbi_triton

    rows = []
    rng = np.random.default_rng(0)
    cases = [c for c in cs.viterbi_cases() if "renorm" not in c[0]]
    for label, batch, nbits, noise in cases:
        soft = jnp.asarray(cs._coded_soft(rng, batch, nbits, noise))
        sv = jnp.full((batch,), ((nbits + 6) // 2) * 2, jnp.int32)
        iv = jnp.ones((batch,), jnp.int32)
        impls = {
            "triton": functools.partial(viterbi.viterbi_decode, nbits=nbits,
                                        impl="triton"),
            "triton_fwd": lambda s, nb=nbits, sv=sv, iv=iv:
                viterbi_triton.forward_lanes(s, sv, iv, nbits=nb),
            "blocked": functools.partial(viterbi.viterbi_decode, nbits=nbits,
                                         impl="blocked"),
        }
        for u in (1, 4, 16):
            impls[f"scan_u{u}"] = functools.partial(
                viterbi.viterbi_decode_scan, nbits=nbits, unroll=u)
        for name, fn in impls.items():
            first, ms = timed(jax.jit(fn), (soft,), reps)
            row = {"part": "micro", "case": label, "batch": batch,
                   "nbits": nbits, "impl": name, "first_s": round(first, 3),
                   "ms": round(ms, 4)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def capture(reps: int) -> list:
    import jax
    import jax.numpy as jnp

    from fun_ofdm_tpu.models import frontend
    from fun_ofdm_tpu.rates import Rate

    rows = []
    rate = Rate.RATE_3_4_QAM16
    channels, frames = 16, 32
    re, im, planted = cs.build_capture(channels, frames, rate, LENGTH, 1)
    args = (jnp.asarray(re), jnp.asarray(im))
    fns = {}
    for impl in ("scan", "triton", "blocked"):
        fn = jax.jit(jax.vmap(functools.partial(
            lambda r, i, vi: frontend.receive_capture_p(
                (r, i), rate=rate, length=LENGTH, max_frames=frames,
                viterbi_impl=vi), vi=impl)))
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        first = time.perf_counter() - t0
        got = cs.delivered_capture(out, LENGTH)
        fns[impl] = fn
        row = {"part": "capture", "impl": impl, "first_s": round(first, 2),
               "delivered_ok": got == planted}
        rows.append(row)
        print(json.dumps(row), flush=True)
    ms = {k: [] for k in fns}
    for impl in ["scan", "triton", "blocked", "blocked", "triton", "scan"]:
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[impl](*args))
            ms[impl].append((time.perf_counter() - t0) * 1e3)
    for impl, v in ms.items():
        row = {"part": "capture", "impl": impl, "ms": round(
            float(np.median(v)), 3), "msample_s": round(
            re.size / float(np.median(v)) / 1e3, 2)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def chain(impls) -> list:
    """ReceiverChain on one second of a 20 MHz mixed all-rates stream
    (default ChainParams), each viterbi_impl timed in turns (forward,
    reverse, forward); the first run of each compiles."""
    from fun_ofdm_tpu.rates import ALL_RATES

    rows = []
    sre, sim, planted = cs.build_mixed_stream(20_000_000, LENGTH, seed=2)
    walls = {k: [] for k in impls}
    redecodes = {k: 0 for k in impls}
    for impl in list(impls) + list(impls)[::-1] + list(impls):
        t0 = time.perf_counter()
        got, chain = cs.run_chain(sre, sim, 1 << 16, rates=ALL_RATES,
                                  max_length=LENGTH, viterbi_impl=impl)
        walls[impl].append(time.perf_counter() - t0)
        redecodes[impl] += chain.stats.viterbi_fallbacks
        if got != planted:
            print(json.dumps({"part": "chain", "impl": impl,
                              "error": "delivered set differs"}), flush=True)
    for impl, v in walls.items():
        warm = sorted(v[1:])[len(v[1:]) // 2] if len(v) > 1 else v[0]
        row = {"part": "chain", "impl": impl, "first_s": round(v[0], 2),
               "s": round(warm, 3),
               "msample_s": round(sre.size / warm / 1e6, 2),
               "merge_guard_redecodes": redecodes[impl]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("micro", "capture", "chain", "e2e",
                                       "all"), default="all")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chain-impls", default="scan,exact,auto,blocked",
                    help="ReceiverChain viterbi_impl values to compare")
    ap.add_argument("--out", help="also write all rows to this JSON file")
    args = ap.parse_args()
    import jax

    from fun_ofdm_tpu.utils.cache import enable_persistent_cache
    from fun_ofdm_tpu.utils.platform import require_gpu

    require_gpu("tools/viterbi_ab.py")
    enable_persistent_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    rows = []
    if args.part in ("micro", "all"):
        rows += micro(args.reps)
    if args.part in ("capture", "e2e", "all"):
        rows += capture(args.reps)
    if args.part in ("chain", "e2e", "all"):
        rows += chain(args.chain_impls.split(","))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "device": jax.devices()[0].device_kind,
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
