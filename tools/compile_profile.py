#!/usr/bin/env python3
"""Profile XLA compile time of the RX pipeline's subgraphs.

Times `jit(...).lower().compile()` for each stage in isolation on the
default device, so the compile-time hot spot is attributable. No
persistent cache (we want true compile cost).

Usage: python tools/compile_profile.py [part ...]
Parts: detect headers decode viterbi capture
"""

from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(name, build):
    t0 = time.perf_counter()
    out = build()
    dt = time.perf_counter() - t0
    print(f"{name:30s} {dt:8.2f}s", flush=True)
    return out


def main() -> None:
    parts = set(sys.argv[1:]) or {
        "detect", "headers", "decode", "viterbi", "capture"}
    import jax
    import jax.numpy as jnp

    from fun_ofdm_tpu.models import frontend, rx
    from fun_ofdm_tpu.ops import correlate, viterbi
    from fun_ofdm_tpu.rates import Rate, params_for

    rate = Rate.RATE_3_4_QAM16
    length = 1500
    channels = 16
    frames_per_channel = 8
    n = frames_per_channel * params_for(rate).frame_samples(length) + 2048
    print(f"stream: ({channels}, {n}) f32 planar; backend: "
          f"{jax.default_backend()}", flush=True)

    stream = (jax.ShapeDtypeStruct((channels, n), jnp.float32),
              jax.ShapeDtypeStruct((channels, n), jnp.float32))
    one = (jax.ShapeDtypeStruct((n,), jnp.float32),) * 2

    if "detect" in parts:
        fn = jax.jit(jax.vmap(functools.partial(
            lambda r, i: frontend.detect_frames_p(
                (r, i), max_frames=frames_per_channel))))
        timed("detect_frames (vmap 16)", lambda: fn.lower(*stream).compile())

        fn1 = jax.jit(lambda r, i: correlate.lts_correlation((r, i)))
        timed("lts_correlation (1ch)", lambda: fn1.lower(*one).compile())
        fn2 = jax.jit(lambda r, i: correlate.sts_ratio((r, i)))
        timed("sts_ratio (1ch)", lambda: fn2.lower(*one).compile())

    if "headers" in parts:
        fn = jax.jit(jax.vmap(functools.partial(
            lambda r, i: frontend.decode_headers_p(
                (r, i), max_frames=frames_per_channel))))
        timed("decode_headers (vmap 16)", lambda: fn.lower(*stream).compile())

    if "decode" in parts:
        starts = jax.ShapeDtypeStruct((channels, frames_per_channel),
                                      jnp.int32)
        fn = jax.jit(jax.vmap(lambda r, i, s: jax.vmap(
            lambda s1: rx.decode_frame_p((r, i), rate, length, start=s1)
        )(s)))
        timed("decode_frame (16x8)",
              lambda: fn.lower(*stream, starts).compile())

    if "viterbi" in parts:
        nbits = (16 + 8 * (length + 4) + 6)
        nbits += (-nbits) % params_for(rate).dbps
        soft = jax.ShapeDtypeStruct((channels, frames_per_channel,
                                     2 * (nbits + 6)), jnp.int32)
        fn = jax.jit(functools.partial(viterbi.viterbi_decode, nbits=nbits))
        timed(f"viterbi (nbits={nbits})",
              lambda: fn.lower(soft).compile())

    if "capture" in parts:
        fn = jax.jit(jax.vmap(functools.partial(
            lambda r, i: frontend.receive_capture_p(
                (r, i), rate=rate, length=length,
                max_frames=frames_per_channel))))
        timed("receive_capture (vmap 16)",
              lambda: fn.lower(*stream).compile())


if __name__ == "__main__":
    main()
