#!/usr/bin/env python3
"""Batch-decode a recorded capture file through the capture megagraph.

A batch workflow with no reference equivalent: instead of replaying a
recording through the streaming chain in real-time order
(examples/rx.py), decode the WHOLE capture in one batched device call —
detection, timing sync, equalization, universal any-rate payload decode
(models/frontend.receive_capture*).

Usage:
  python examples/tx.py out.c64 --count 20        # record some frames
  python examples/capture.py out.c64              # decode them at once
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("capture", help="input capture file (complex64)")
    ap.add_argument("--rate", default=None,
                    help="restrict decoding to one Rate (default: all, "
                         "each frame's rate read from its header)")
    ap.add_argument("--max-length", type=int, default=1500)
    ap.add_argument("--max-frames", type=int, default=None,
                    help="detection slot capacity (default: auto-size)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args()

    from fun_ofdm_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    import numpy as np

    import jax.numpy as jnp

    from fun_ofdm_tpu.models import frontend
    from fun_ofdm_tpu.rates import ALL_RATES, Rate, params_for

    raw = np.fromfile(args.capture, dtype=np.complex64)
    if raw.size == 0:
        print("empty capture", file=sys.stderr)
        return 1
    rates = ALL_RATES if args.rate is None else (Rate[args.rate],)

    min_frame = min(params_for(r).frame_samples(0) for r in rates)
    max_frames = args.max_frames or max(4, raw.size // min_frame + 1)

    t0 = time.perf_counter()
    out = frontend.receive_capture_anyrate_p(
        (jnp.asarray(raw.real), jnp.asarray(raw.imag)),
        rates, args.max_length, max_frames)
    crc_ok = np.asarray(out["crc_ok"])
    starts = np.asarray(out["starts"])
    lengths = np.asarray(out["hdr_length"])
    fields = np.asarray(out["rate_field"])
    payloads = np.asarray(out["payload"]).astype(np.uint8)
    dt = time.perf_counter() - t0

    by_field = {params_for(r).rate_field: r for r in ALL_RATES}
    n = 0
    for k in np.nonzero(crc_ok)[0]:
        n += 1
        rate = by_field.get(int(fields[k]))
        if not args.quiet:
            data = payloads[k, : int(lengths[k])]
            head = bytes(data[:24])
            print(f"packet {n}: {int(lengths[k])} bytes @ "
                  f"{rate.name if rate else hex(int(fields[k]))} "
                  f"(start {int(starts[k])}) {head!r}...")
    print(f"Received {n} packets")
    print(f"Decoded {raw.size} samples in {dt*1e3:.1f} ms "
          f"({raw.size/dt/1e6:.1f} Msample/s incl. compile on first run)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
