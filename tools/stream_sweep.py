#!/usr/bin/env python3
"""Sweep the streaming chain operating point on real hardware.

Measures ReceiverChain samples/s on a dense single-rate stream across
(strides_per_step, ingest_dtype) configurations; results inform the
bench.py parity/tuned configs and ChainParams defaults.

Usage: python tools/stream_sweep.py [--configs K:dtype,...] [--tiles N]
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
    ap.add_argument("--configs", type=str,
                    default="64:float32,256:float32,256:int16,"
                            "512:int16,512:int12,1024:int16,1024:int8")
    ap.add_argument("--tiles", type=int, default=512)
    ap.add_argument("--chunk-feed", type=int, default=4096)
    ap.add_argument("--prequant", action="store_true",
                    help="feed pre-quantized planar ints in whole "
                         "supersteps (models a radio delivering native "
                         "sc16/sc8 buffers)")
    ap.add_argument("--min-frame", type=int, default=None,
                    help="ChainParams.min_frame_samples (tuned capacity)")
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
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, size=(1, length), dtype=np.uint8)
    fre, fim = tx.build_frame_p(jnp.asarray(payload), rate)
    fre = np.asarray(fre)[0].astype(np.float32)
    fim = np.asarray(fim)[0].astype(np.float32)
    unit_re = np.concatenate([np.tile(fre, 8), np.zeros(2048, np.float32)])
    unit_im = np.concatenate([np.tile(fim, 8), np.zeros(2048, np.float32)])
    s_re = np.tile(unit_re, args.tiles)
    s_im = np.tile(unit_im, args.tiles)
    n_frames = 8 * args.tiles
    print(json.dumps({"stream_samples": int(s_re.size),
                      "frames": n_frames}), flush=True)

    def run(k, dtype, warm):
        from fun_ofdm_tpu.runtime.chain import INGEST_FORMATS
        chain = ReceiverChain(
            rates=(rate,), max_length=length,
            params=ChainParams(strides_per_step=k,
                               min_frame_samples=args.min_frame),
            ingest_dtype=dtype)
        if args.prequant and dtype != "float32":
            np_dtype, scale = INGEST_FORMATS[dtype]
            n_whole = s_re.size // chain.step * chain.step
            from fun_ofdm_tpu.runtime.chain import PACKED_FORMATS, _pack_np
            if dtype in PACKED_FORMATS:
                gb, gs = PACKED_FORMATS[dtype]
                f_re = _pack_np(s_re[:n_whole], dtype, scale)
                f_im = _pack_np(s_im[:n_whole], dtype, scale)
                cf = chain.step * gb // gs
            else:
                lim = float(np.iinfo(np_dtype).max)
                f_re = np.clip(np.rint(s_re[:n_whole] * scale),
                               -lim, lim).astype(np_dtype)
                f_im = np.clip(np.rint(s_im[:n_whole] * scale),
                               -lim, lim).astype(np_dtype)
                cf = chain.step
            exp = (n_whole // unit_re.size) * 8  # frames in complete tiles
            feed = (f_re, f_im)
            n_fed = n_whole
        else:
            feed, cf = (s_re, s_im), args.chunk_feed
            exp = n_frames
            n_fed = s_re.size
        t0 = time.perf_counter()
        got = 0
        for i in range(0, feed[0].size, cf):
            got += len(chain.process_samples(
                (feed[0][i:i + cf], feed[1][i:i + cf])))
        got += len(chain.flush())
        dt = time.perf_counter() - t0
        if warm and exp is not None and got < exp - 8:
            raise AssertionError(f"decoded {got}, expected ~{exp}")
        st = chain.stats
        return n_fed / dt, dt, st

    for spec in args.configs.split(","):
        kstr, dtype = spec.split(":")
        k = int(kstr)
        t0 = time.perf_counter()
        run(k, dtype, warm=False)       # compile
        compile_s = time.perf_counter() - t0
        sps, dt, st = run(k, dtype, warm=True)
        print(json.dumps({
            "k": k, "dtype": dtype, "samples_per_sec": sps,
            "wall_s": dt, "vs_5.22M": sps / 5.22e6,
            "compile_plus_first_s": compile_s,
            "sync_wait_headers_s": st.time_headers_s,
            "sync_wait_decode_s": st.time_decode_s,
            "supersteps": st.windows,
        }), flush=True)


if __name__ == "__main__":
    main()
