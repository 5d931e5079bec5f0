"""RX front-end: frame detection and timing sync as batched array ops.

Array-program recast of the reference's frame_detector + timing_sync stages
(src/frame_detector.cpp:41-92, src/timing_sync.cpp:51-139): instead of a
stateful per-sample walk, the whole capture is processed at once -
autocorrelation ratios, plateau events, LTS matched filtering and peak
pairing are all data-parallel; each detected STS end yields (at most) one
frame-start offset. Streams are planar (re, im); complex wrappers at the
bottom for host/test use.

Capacity model: detection output has a fixed `max_frames` slot count with a
validity mask (fixed shapes under jit). Slots are ordered by stream
position.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ChainParams, DEFAULT_PARAMS
from ..ops import correlate
from ..ops.cplx import CArr
from ..rates import Rate, params_for
from . import ppdu as ppdu_model
from . import rx as rx_model

#: preamble-start offset from the LTS CP start (P + 160 = lts CP)
LTS_CP_FROM_START = 160


def _first_k_true(mask: jnp.ndarray, k: int,
                  drop_count_limit: int | None = None):
    """Positions of the first k True values of a 1-D mask, in order.

    Returns (pos (k,) int32 with n as fill, valid (k,) bool, dropped ()
    int32 — events lost to the blocked extractor's per-block cap; always 0
    on the exact one-hot path). Equivalent to
    jnp.nonzero(mask, size=k, fill_value=n), without its sequential
    lowering; here slot positions come from one (k, n) one-hot-of-rank
    matmul (exact: positions < 2^24 in full f32). For large k*n (the
    streaming superstep: megasample windows with thousands of slots) the
    one-hot would materialize gigabytes, so a blocked two-level
    extraction takes over.
    """
    n = mask.shape[-1]
    if n > _BLOCKED_MIN_N:
        # the blocked two-level extractor is the default: the one-hot
        # form needs a full-stream prefix-sum scan and
        # a (k, n) one-hot product; events denser than the per-block cap
        # are dropped AND counted (the documented capacity - only noise
        # produces >16 LTS-reachable events per 512 samples). Tiny
        # streams keep the exact one-hot (cheap, no capacity caveat).
        blocked = _first_k_true_blocked(mask, k, drop_count_limit)
        if blocked is not None:
            return blocked
    rank = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - mask.astype(jnp.int32)
    slot = jnp.where(mask, rank, k)  # k = "no slot"
    onehot = (slot[None, :] == jnp.arange(k, dtype=jnp.int32)[:, None])
    idx = jnp.arange(n, dtype=jnp.float32)
    # full f32: positions up to ~2^24 must come back exact (TF32 keeps
    # 10 mantissa bits)
    pos = jnp.dot(onehot.astype(jnp.float32), idx,
                  precision=jax.lax.Precision.HIGHEST,
                  preferred_element_type=jnp.float32)
    count = jnp.sum(mask.astype(jnp.int32), axis=-1)
    valid = jnp.arange(k, dtype=jnp.int32) < count
    return (jnp.where(valid, pos.astype(jnp.int32), n), valid,
            jnp.zeros((), jnp.int32))


#: blocked first-k: events kept per block (events are plateau *ends* gated
#: by LTS-pair reachability, so >16 in any 512 samples means the input is
#: noise). Events beyond the cap are dropped and COUNTED: the per-block
#: overflow total is returned so the streaming chain can surface it
#: (ChainStats.detect_dropped).
_BLOCK = 512
_BLOCK_CAP = 16
#: stream length above which the blocked extractor takes over from the
#: exact one-hot (kept tiny-stream-exact for unit-scale inputs)
_BLOCKED_MIN_N = 1 << 13


def _first_k_true_blocked(mask: jnp.ndarray, k: int,
                          drop_count_limit: int | None = None):
    """Two-level first-k: per-512-block top-16 candidates, then a global
    top-k over the (n/32)-entry candidate list. Exact vs the one-hot form
    whenever no 512-sample block holds >16 events; the number of events
    lost to the cap is returned as `dropped`. Returns None when the
    candidate list cannot cover k (caller falls back to the one-hot).

    drop_count_limit: only blocks starting below this position contribute
    to `dropped` (static). The streaming chain re-scans the previous
    superstep's DETECT_LEAD tail every superstep; counting drops only in
    the owned [0, step) region keeps stats.detect_dropped exact instead
    of double-counting a dense burst in the overlap (ADVICE r4)."""
    n = mask.shape[-1]
    nb = -(-n // _BLOCK)
    if k > nb * _BLOCK_CAP:
        return None
    pad = nb * _BLOCK - n
    mb = jnp.pad(mask, (0, pad)).reshape(nb, _BLOCK)
    pos_in = jnp.where(mb, jnp.arange(_BLOCK, dtype=jnp.int32), _BLOCK)
    neg, _ = jax.lax.top_k(-pos_in, _BLOCK_CAP)   # ascending positions
    p = -neg                                      # (nb, cap)
    ok = p < _BLOCK
    gpos = jnp.where(
        ok, p + _BLOCK * jnp.arange(nb, dtype=jnp.int32)[:, None], n
    ).reshape(-1)
    negk, _ = jax.lax.top_k(-gpos, k)             # first k candidates
    pos = -negk                                   # (k,) ascending, n = fill
    count_b = jnp.sum(mb.astype(jnp.int32), axis=-1)      # per block
    over_b = jnp.maximum(count_b - _BLOCK_CAP, 0)
    if drop_count_limit is not None:
        counted = (jnp.arange(nb, dtype=jnp.int32) * _BLOCK
                   < drop_count_limit)
        over_b = jnp.where(counted, over_b, 0)
    dropped = jnp.sum(over_b)
    count = jnp.sum(count_b)
    valid = (jnp.arange(k, dtype=jnp.int32) < count) & (pos < n)
    return jnp.where(valid, pos, n), valid, dropped


def detect_frames_p(stream: CArr, max_frames: int,
                    params: ChainParams = DEFAULT_PARAMS,
                    return_dropped: bool = False,
                    drop_count_limit: int | None = None):
    """Find frame starts in a planar 1-D capture.

    stream: planar (re, im) of (n,) samples.
    Returns (starts (max_frames,) int32, valid (max_frames,) bool), ordered
    by position; invalid slots have start = n (sentinel). With
    return_dropped=True, also returns a () int32 count of detection events
    lost to the blocked extractor's per-block cap (0 on the exact path).

    Pipeline (mirroring the reference):
      1. normalized STS autocorrelation ratio per sample;
      2. STS_END events = first sub-threshold sample after a >=16 plateau
         (frame_detector.cpp:65-82);
      3. per event, LTS matched-filter peaks in the next params.lts_search
         positions (reference: 96, timing_sync.cpp:74-86; our default 128
         closes a window-boundary miss, see config.py); top-5 peaks
         searched for a pair exactly 64 apart (timing_sync.cpp:92-117);
      4. frame start P = min(pair) - 32 - 160.
    """
    n = stream[0].shape[-1]
    ratio = correlate.sts_ratio(stream, params.sts_length)
    ends = correlate.sts_end_events(
        ratio, params.plateau_threshold, params.sts_plateau_length)
    lts_norm = correlate.lts_correlation(stream, params.lts_segments)

    # Capacity guard: under noise the STS plateau fragments into several
    # STS_END events per frame; the reference simply searches (and fails)
    # on each, but here every event consumes one of max_frames slots. Keep
    # only events from which an LTS peak pair 64 apart is reachable:
    # pair positions (p, p+64) must both lie in [e, e+lts_search), i.e.
    # some p in [e, e + lts_search - 64) with peaks at p and p+64.
    peak = lts_norm > params.lts_corr_threshold
    pair = peak & jnp.concatenate(
        [peak[..., 64:], jnp.zeros(peak.shape[:-1] + (64,), bool)], axis=-1)
    reach = correlate.leading_window_any(pair, params.lts_search - 64)
    ends = ends & reach

    end_pos, end_valid, dropped = _first_k_true(ends, max_frames,
                                                drop_count_limit)

    search = params.lts_search
    lts_padded = jnp.concatenate([lts_norm, jnp.zeros(search, lts_norm.dtype)])

    def resolve_one(e, e_valid):
        # norm values in [e, e+lts_search), -inf outside threshold
        win = jax.lax.dynamic_slice(lts_padded, (e,), (search,))
        cand = jnp.where(win > params.lts_corr_threshold, win, -jnp.inf)
        vals, rel_pos = jax.lax.top_k(cand, 5)  # descending
        pos = e + rel_pos
        # reference pairing: compare peak 0 against peaks 1..4, first with
        # |pos0 - post| == 64 wins (timing_sync.cpp:92-106)
        d = jnp.abs(pos[0] - pos[1:])
        hit = (d == 64) & jnp.isfinite(vals[1:]) & jnp.isfinite(vals[0])
        any_hit = jnp.any(hit)
        t = jnp.argmax(hit)  # first hit index
        lts_offset = jnp.minimum(pos[0], pos[1:][t]) - 32
        start = lts_offset - LTS_CP_FROM_START
        ok = e_valid & any_hit & (lts_offset >= 0) & (start >= 0)
        return jnp.where(ok, start, n).astype(jnp.int32), ok

    starts, valid = jax.vmap(resolve_one)(end_pos, end_valid)
    if return_dropped:
        return starts, valid, dropped
    return starts, valid


def receive_capture_p(stream: CArr, rate: Rate, length: int,
                      max_frames: int,
                      params: ChainParams = DEFAULT_PARAMS,
                      viterbi_impl: str | None = None):
    """Detect and decode every frame of a known (rate, length) config.

    stream: planar (re, im) of an (n,) capture.
    Returns dict of per-slot arrays: starts, valid, payload
    (max_frames, length), crc_ok, header_ok - `valid & crc_ok` marks
    delivered packets (the reference chain's output contract).
    """
    n = stream[0].shape[-1]
    frame_len = params_for(rate).frame_samples(length)
    starts, valid = detect_frames_p(stream, max_frames, params)
    # frames must fit in the capture to decode with static shapes
    fits = starts + frame_len <= n
    safe_start = jnp.where(valid & fits, starts, 0)
    out = jax.vmap(
        lambda s: rx_model.decode_frame_p(stream, rate, length, start=s,
                                          viterbi_impl=viterbi_impl)
    )(safe_start)
    ok = valid & fits
    return {
        "starts": starts,
        "valid": ok,
        "payload": out["payload"],
        "crc_ok": out["crc_ok"] & ok,
        "header_ok": out["header_ok"] & ok,
    }


def decode_headers_p(stream: CArr, max_frames: int,
                     params: ChainParams = DEFAULT_PARAMS,
                     drop_count_limit: int | None = None,
                     cfo_correct: bool = False,
                     hdr_slots: int | None = None):
    """Detect frames and decode only their SIGNAL headers.

    Cheap and rate-independent (the header is always 1/2-BPSK,
    src/ppdu.cpp:81): the host runtime uses this to learn each frame's
    (rate_field, length) before dispatching a batched payload decode
    (reference analogue: frame_decoder's header pass,
    src/frame_decoder.cpp:72-78).

    Returns dict: starts, valid, rate_field, hdr_length, header_ok,
    detect_dropped (() int32: events lost to the blocked extractor's
    per-block cap — surfaced by the chain as stats.detect_dropped),
    n_detected (() int32: total detection events).

    hdr_slots: SIGNAL-decode only the first hdr_slots detection slots
    (None = all max_frames). Detection slots are ordered by position, so
    whenever n_detected <= hdr_slots nothing is lost - header compute
    then scales with expected frame density instead of worst-case slot
    capacity (VERDICT r4 #9); a caller seeing n_detected > hdr_slots
    must fall back to a full-capacity pass (runtime/chain.py does).
    """
    n = stream[0].shape[-1]
    starts, valid, dropped = detect_frames_p(stream, max_frames, params,
                                             return_dropped=True,
                                             drop_count_limit=drop_count_limit)
    n_detected = jnp.sum(valid.astype(jnp.int32))
    if hdr_slots is not None and hdr_slots < max_frames:
        starts = starts[:hdr_slots]
        valid = valid[:hdr_slots]
    # header needs preamble + SIGNAL symbol = 400 samples; pad so clamped
    # slices near the stream end stay aligned
    pad = jnp.zeros(stream[0].shape[:-1] + (400,), stream[0].dtype)
    padded = (jnp.concatenate([stream[0], pad], axis=-1),
              jnp.concatenate([stream[1], pad], axis=-1))
    safe = jnp.where(valid, starts, 0)

    def hdr_one(s):
        lts, syms = rx_model.extract_symbols_p(padded, s, 0)
        if cfo_correct:
            # a large CFO corrupts the SIGNAL symbol itself (3+ rad of
            # intra-symbol rotation at 8e-3 cycles/sample), so the
            # header pass needs the same coarse+fine cascade as the
            # payload decode
            w = rx_model.estimate_cfo_cascade_p(padded, s, lts)
            lts_idx, sym_idx = rx_model.derotation_indices(1)
            lts = rx_model._derotate_p(lts, w, lts_idx)
            syms = rx_model._derotate_p(syms, w, sym_idx)
        h_inv = rx_model.channel_estimate_p(lts)
        data = rx_model.equalize_and_track_p(syms, h_inv)
        sig = (data[0][..., 0, :], data[1][..., 0, :])
        return ppdu_model.decode_header_p(sig)

    rate_field, hdr_length, header_ok = jax.vmap(hdr_one)(safe)
    return {
        "starts": starts,
        "valid": valid,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "header_ok": header_ok & valid,
        "detect_dropped": dropped,
        "n_detected": n_detected,
    }


def receive_capture_dynamic_p(stream: CArr, rate: Rate, max_length: int,
                              max_frames: int,
                              params: ChainParams = DEFAULT_PARAMS):
    """Detect and decode frames with per-frame lengths from their headers.

    Like receive_capture_p but only the *rate* is static configuration;
    each frame's payload length is read from its SIGNAL field at runtime
    (frames at other rates report their header info with crc_ok=False).
    The stream is zero-padded by one max-frame extent so frames near the
    capture end decode from static-shape slices without clamping skew.

    Returns dict of per-slot arrays: starts, valid, payload
    (max_frames, max_length), hdr_length, rate_field, crc_ok, header_ok.
    """
    n = stream[0].shape[-1]
    frame_len_max = params_for(rate).frame_samples(max_length)
    starts, valid, dropped = detect_frames_p(stream, max_frames, params,
                                             return_dropped=True)
    pad = jnp.zeros(stream[0].shape[:-1] + (frame_len_max,),
                    stream[0].dtype)
    padded = (jnp.concatenate([stream[0], pad], axis=-1),
              jnp.concatenate([stream[1], pad], axis=-1))
    safe_start = jnp.where(valid, starts, 0)
    out = jax.vmap(
        lambda s: rx_model.decode_frame_dynamic_p(
            padded, rate, max_length, start=s)
    )(safe_start)
    # a frame truncated by the capture end reads zero padding and fails
    # CRC naturally, exactly like the reference fed a truncated stream
    ok = valid
    return {
        "starts": starts,
        "valid": ok,
        "payload": out["payload"],
        "hdr_length": out["hdr_length"],
        "rate_field": out["rate_field"],
        "crc_ok": out["crc_ok"] & ok,
        "header_ok": out["header_ok"] & ok,
        "detect_dropped": dropped,
    }


def receive_capture_anyrate_p(stream: CArr, rates: tuple[Rate, ...],
                              max_length: int, max_frames: int,
                              params: ChainParams = DEFAULT_PARAMS):
    """Detect and decode frames of ANY configured rate, zero-config.

    The fully dynamic receive: each detected frame's (rate, length) is
    read from its SIGNAL header and its payload decoded through the
    universal any-rate decoder (models/rx.decode_frame_anyrate_p) — the
    reference receiver's exact contract (src/frame_decoder.cpp:72-88).
    The stream is zero-padded by the slowest rate's max-frame extent so
    near-end frames decode from static-shape slices.

    Returns dict of per-slot arrays: starts, valid, payload
    (max_frames, max_length), hdr_length, rate_field, rate_match,
    crc_ok, header_ok.
    """
    rates = tuple(rates)
    n = stream[0].shape[-1]
    frame_len_max = max(params_for(r).frame_samples(max_length)
                        for r in rates)
    starts, valid, dropped = detect_frames_p(stream, max_frames, params,
                                             return_dropped=True)
    pad = jnp.zeros(stream[0].shape[:-1] + (frame_len_max,),
                    stream[0].dtype)
    padded = (jnp.concatenate([stream[0], pad], axis=-1),
              jnp.concatenate([stream[1], pad], axis=-1))
    safe_start = jnp.where(valid, starts, 0)
    out = jax.vmap(
        lambda s: rx_model.decode_frame_anyrate_p(
            padded, rates, max_length, start=s)
    )(safe_start)
    return {
        "starts": starts,
        "valid": valid,
        "payload": out["payload"],
        "hdr_length": out["hdr_length"],
        "rate_field": out["rate_field"],
        "rate_match": out["rate_match"],
        "crc_ok": out["crc_ok"] & valid,
        "header_ok": out["header_ok"] & valid,
        "detect_dropped": dropped,
    }


@functools.lru_cache(maxsize=None)
def receive_capture_p_jit(rate: Rate, length: int, max_frames: int,
                          params: ChainParams = DEFAULT_PARAMS):
    return jax.jit(functools.partial(
        receive_capture_p, rate=rate, length=length, max_frames=max_frames,
        params=params))


# --- complex wrappers (host/tests) ----------------------------------------

def detect_frames(stream: jnp.ndarray, max_frames: int,
                  params: ChainParams = DEFAULT_PARAMS):
    return detect_frames_p((jnp.real(stream), jnp.imag(stream)),
                           max_frames, params)


def receive_capture(stream: jnp.ndarray, rate: Rate, length: int,
                    max_frames: int,
                    params: ChainParams = DEFAULT_PARAMS):
    return receive_capture_p((jnp.real(stream), jnp.imag(stream)),
                             rate, length, max_frames, params)
