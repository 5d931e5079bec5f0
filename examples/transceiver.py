#!/usr/bin/env python3
"""Interactive-style transceiver over an in-process loopback radio.

Mirrors the reference `transceiver` example (examples/simple_transceiver.cpp):
a Transmitter and a Receiver sharing one radio bus, with the receiver
paused while transmitting (the reference's half-duplex pattern). Sends a
message, resumes RX, and prints what comes back — optionally through an
AWGN channel.

For the reference's TWO-MACHINE demo (independent test_tx / test_rx
endpoints, README.md:299-311), run `examples/rx.py udp://0.0.0.0:PORT`
and `examples/tx.py udp://HOST:PORT --pace` as two OS processes — the
networked sample transport (runtime/io.UdpSink/UdpSource) replaces the
radios.
"""

from __future__ import annotations

import argparse
import sys
import time

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--message", default="Hello from the transceiver!")
    ap.add_argument("--count", type=int, default=10)
    ap.add_argument("--rate", default="RATE_1_2_QPSK")
    ap.add_argument("--snr", type=float, default=None, help="AWGN SNR (dB)")
    args = ap.parse_args()

    from fun_ofdm_tpu.api import Receiver, Transmitter
    from fun_ofdm_tpu.rates import Rate
    from fun_ofdm_tpu.runtime.io import LoopbackRadio

    channel = None
    if args.snr is not None:
        import jax
        import jax.numpy as jnp
        from fun_ofdm_tpu.sim import channel as chan

        key_holder = [jax.random.PRNGKey(0)]

        def channel(re, im):
            key_holder[0], k = jax.random.split(key_holder[0])
            out = chan.awgn((jnp.asarray(re), jnp.asarray(im)), k, args.snr)
            return np.asarray(out[0]), np.asarray(out[1])

    radio = LoopbackRadio(channel=channel)
    rate = Rate[args.rate]

    received = []

    def callback(packets):
        for p in packets:
            received.append(p)
            print(f"rx: {p.payload.decode(errors='replace')!r} "
                  f"({p.length} bytes @ {p.rate.name})")

    rx = Receiver(callback, source=radio, max_length=256)
    txer = Transmitter(radio)

    for i in range(args.count):
        rx.pause()  # half-duplex: don't receive our own send mid-chain
        msg = f"{args.message} #{i}".encode()
        txer.send_frame(msg, rate)
        rx.resume()
        time.sleep(0.05)

    deadline = time.perf_counter() + 30.0
    while len(received) < args.count and time.perf_counter() < deadline:
        time.sleep(0.1)
    rx.stop()
    print(f"Received {len(received)}/{args.count} packets")
    return 0 if len(received) == args.count else 1


if __name__ == "__main__":
    sys.exit(main())
