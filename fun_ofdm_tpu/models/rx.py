"""Frame-synchronous RX: decode a frame given its (detected) start offset.

This is the reference RX chain stages 3-6 (fft_symbols, channel_est,
phase_tracker, frame_decoder -> ppdu decode) recast as one pure batched
function over planar (re, im) sample streams (see ops/cplx.py). The
streaming front-end (frame detection / timing sync) lives in
models/frontend.py and produces the start offsets consumed here.

Geometry (see preamble.py): relative to the preamble start P the reference
extracts every 64-sample symbol body 8 samples early (inside its cyclic
prefix) - the constant 8-sample rotation appears as a linear phase that
the LTS channel estimate absorbs exactly (reference: timing_sync.cpp:36-44).

The reference timing_sync also derotates all post-LTS samples by a constant
phase e^{i*arg(x[P+319]*conj(LTS[63]))} (its CFO loop is dead code,
src/timing_sync.cpp:109-115). That constant multiplies LTS and data symbols
alike, so the zero-forcing equalizer cancels it exactly; we omit it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import preamble as pre
from ..ops import cplx, fft64, mapper
from ..ops.cplx import CArr
from ..rates import Rate, params_for
from . import ppdu


def extract_symbols_p(samples: CArr, start, num_symbols: int):
    """Slice LTS bodies and OFDM symbol bodies from a planar stream.

    samples: planar (re, im) of (..., n); start: (...,) int32 preamble-start
    offsets (traced OK); num_symbols: static data-symbol count (excl SIGNAL).
    Returns (lts (..., 2, 64), syms (..., 1+num_symbols, 64)), both planar.

    Uses batched `dynamic_slice` + pad/reshape (NOT an advanced gather):
    on the earlier accelerator, gather-based extraction was slower than
    the slice form in the fused capture megagraph (XLA fused the slice
    into its consumers but materialized the gather); the A/B on the GPU
    is ROADMAP Speed #4. The slice
    start is clamped, so callers pad their streams (a genuinely
    truncated frame reads edge garbage and fails CRC, same as the
    reference fed a truncated stream).
    """
    import os

    start = jnp.asarray(start, jnp.int32)
    nsym_total = 1 + num_symbols
    # the last symbol body ends 16 samples before a full 80-stride, so
    # slice exactly through it (slicing nsym_total*80 would run 8 samples
    # past the frame end and dynamic_slice would clamp, shifting everything)
    body_len = (nsym_total - 1) * 80 + 64

    if os.environ.get("FUN_OFDM_EXTRACT", "slice") == "gather":
        # A/B-only alternative (env FUN_OFDM_EXTRACT=gather): the
        # batched row-gather, slower than the slice form on the earlier
        # accelerator; to be measured once on the GPU and settled
        # (ROADMAP Design #4).
        lts_idx = (np.array([pre.LTS1_OFFSET, pre.LTS2_OFFSET])[:, None]
                   + np.arange(64)[None, :])
        sym_idx = (pre.SYMBOL0_OFFSET + 80 * np.arange(nsym_total)[:, None]
                   + np.arange(64)[None, :])
        n = samples[0].shape[-1]
        hi = n - 1

        def gather_one(x, p):
            pc = jnp.clip(p, 0, max(n - body_len - pre.SYMBOL0_OFFSET, 0))
            li = jnp.minimum(pc + jnp.asarray(lts_idx), hi)
            si = jnp.minimum(pc + jnp.asarray(sym_idx), hi)
            return x[li], x[si]

        fn = gather_one
        for _ in samples[0].shape[:-1]:
            fn = jax.vmap(fn)
        lts_re, syms_re = fn(samples[0], start)
        lts_im, syms_im = fn(samples[1], start)
        return (lts_re, lts_im), (syms_re, syms_im)

    def slice_one(x, p):
        lts1 = jax.lax.dynamic_slice(x, (p + pre.LTS1_OFFSET,), (64,))
        lts2 = jax.lax.dynamic_slice(x, (p + pre.LTS2_OFFSET,), (64,))
        body = jax.lax.dynamic_slice(x, (p + pre.SYMBOL0_OFFSET,), (body_len,))
        body = jnp.concatenate([body, jnp.zeros(16, x.dtype)])
        return jnp.stack([lts1, lts2]), body.reshape(nsym_total, 80)[:, :64]

    flat_batch = samples[0].shape[:-1]
    fn = slice_one
    for _ in flat_batch:
        fn = jax.vmap(fn)
    lts_re, syms_re = fn(samples[0], start)
    lts_im, syms_im = fn(samples[1], start)
    return (lts_re, lts_im), (syms_re, syms_im)


def estimate_cfo_p(lts_time: CArr) -> jnp.ndarray:
    """Carrier-frequency-offset estimate from the two LTS symbols.

    lts_time: planar (..., 2, 64). The second LTS body is the first delayed
    by exactly 64 samples, so x2[n] = x1[n] * e^{j*w*64} and
    w = angle(sum_n x2[n]*conj(x1[n])) / 64 radians/sample.

    The reference *intends* this (its per-sample derotation scaffolding,
    src/timing_sync.cpp:109-125) but the estimation loop is dead code
    (`for(k=LTS1; k<LTS1; k++)` never runs), so it effectively applies a
    constant phase only. This is the corrected, opt-in native-mode
    implementation; see decode_frame_p(cfo_correct=True).
    """
    l1 = (lts_time[0][..., 0, :], lts_time[1][..., 0, :])
    l2 = (lts_time[0][..., 1, :], lts_time[1][..., 1, :])
    acc_re = jnp.sum(l2[0] * l1[0] + l2[1] * l1[1], axis=-1)
    acc_im = jnp.sum(l2[1] * l1[0] - l2[0] * l1[1], axis=-1)
    return jnp.arctan2(acc_im, acc_re) / 64.0


def extract_sts_p(samples: CArr, start) -> CArr:
    """Slice the 160-sample STS region starting at the preamble start."""
    start = jnp.asarray(start, jnp.int32)

    def slice_one(x, p):
        return jax.lax.dynamic_slice(x, (p,), (160,))

    fn = slice_one
    for _ in samples[0].shape[:-1]:
        fn = jax.vmap(fn)
    return fn(samples[0], start), fn(samples[1], start)


def estimate_cfo_coarse_p(sts_time: CArr) -> jnp.ndarray:
    """Coarse CFO from the short training sequence (16-lag), rad/sample.

    sts_time: planar (..., 160). The STS repeats every 16 samples, so
    x[n+16] = x[n] * e^{j*w*16} and w = angle(sum x[n+16]*conj(x[n]))/16 -
    unambiguous out to +-pi/16 rad/sample = +-1/32 cycles/sample, covering
    a realistic oscillator error (+-20 ppm at 5.72 GHz / 5 MS/s is
    +-0.023), where the 64-lag LTS estimate aliases past +-1/128. Averaged
    over the 144 available products. (The reference has no STS-stage CFO
    at all; its LTS loop is dead code, src/timing_sync.cpp:109-112.)
    """
    re, im = sts_time
    a = (re[..., :-16], im[..., :-16])
    b = (re[..., 16:], im[..., 16:])
    acc_re = jnp.sum(b[0] * a[0] + b[1] * a[1], axis=-1)
    acc_im = jnp.sum(b[1] * a[0] - b[0] * a[1], axis=-1)
    return jnp.arctan2(acc_im, acc_re) / 16.0


def estimate_cfo_cascade_p(samples: CArr, start, lts_time: CArr
                           ) -> jnp.ndarray:
    """Coarse (STS) + fine (LTS) CFO estimate, rad/sample.

    The fine estimate is exact modulo 2*pi/64; the coarse one is
    unambiguous to +-pi/16 but noisy. The cascade keeps the fine
    accuracy over the coarse range: w = wf + round((wc - wf)/(2*pi/64))
    * 2*pi/64. At small true CFO the rounding term is zero and the
    result equals the plain fine estimate.
    """
    wf = estimate_cfo_p(lts_time)
    wc = estimate_cfo_coarse_p(extract_sts_p(samples, start))
    period = 2.0 * np.pi / 64.0
    k = jnp.round((wc - wf) / period)
    return wf + k * period


def derotation_indices(nsym_total: int):
    """(lts_idx (2, 64), sym_idx (nsym_total, 64)) sample indices relative
    to the LTS1 body start, for CFO derotation of the extracted symbol
    buffers (shared by every decode path and the streaming header pass -
    ONE definition of extract_symbols_p's layout)."""
    lts_idx = 64 * np.arange(2)[:, None] + np.arange(64)[None, :]
    sym_idx = ((pre.SYMBOL0_OFFSET - pre.LTS1_OFFSET)
               + 80 * np.arange(nsym_total)[:, None]
               + np.arange(64)[None, :])
    return lts_idx, sym_idx


def _derotate_p(x: CArr, w: jnp.ndarray, idx) -> CArr:
    """Multiply planar x by e^{-j * w * idx} (idx broadcast over x's tail)."""
    ang = w[..., None, None] * jnp.asarray(idx, x[0].dtype)
    c, s = jnp.cos(ang), jnp.sin(ang)
    return x[0] * c + x[1] * s, x[1] * c - x[0] * s


def channel_estimate_p(lts_time: CArr) -> CArr:
    """Zero-forcing inverse channel estimate from the two LTS symbols.

    lts_time: planar (..., 2, 64) time-domain LTS bodies.
    H_inv[j] = mean over both LTS of LTS_ref[j] / LTS_rx[j], zeroed on
    inactive bins (reference: src/channel_est.cpp:44-58; the reference
    produces NaN at null bins in noise-free loopback and never reads them -
    we zero them instead).
    """
    lts_f = fft64.forward_p(lts_time)  # planar (..., 2, 64)
    dtype = lts_f[0].dtype
    ref = (jnp.asarray(pre.LTS_FREQ_DOMAIN.real, dtype),
           jnp.asarray(pre.LTS_FREQ_DOMAIN.imag, dtype))
    active = jnp.asarray((pre.LTS_FREQ_DOMAIN != 0), dtype)
    inv = cplx.div(ref, lts_f, eps_guard=True)  # (..., 2, 64)
    inv = (jnp.mean(inv[0], axis=-2), jnp.mean(inv[1], axis=-2))
    return inv[0] * active, inv[1] * active


def equalize_and_track_p(sym_time: CArr, h_inv: CArr) -> CArr:
    """FFT, equalize, pilot phase-track, extract 48 data subcarriers.

    sym_time: planar (..., S, 64) time-domain symbol bodies (S = 1+nsym,
    index 0 = SIGNAL). Returns planar (..., S, 48) equalized data samples.
    (reference: src/channel_est.cpp:77-81, src/phase_tracker.cpp:70-105)
    """
    freq = fft64.forward_p(sym_time)
    h = (h_inv[0][..., None, :], h_inv[1][..., None, :])
    eq = cplx.mul(freq, h)
    nsym = sym_time[0].shape[-2]
    dtype = eq[0].dtype
    pol = mapper.polarity_for_symbols(nsym, 0)  # (S,) numpy
    pilot_ref = jnp.asarray(pol[:, None] * mapper.PILOT_VALUES[None, :], dtype)
    pidx = jnp.asarray(mapper.PILOT_IDX)
    rx_p = (eq[0][..., pidx], eq[1][..., pidx])  # (..., S, 4)
    # pilot refs are real: rx * conj(ref) = rx * ref
    pe = (jnp.mean(rx_p[0] * pilot_ref, axis=-1),
          jnp.mean(rx_p[1] * pilot_ref, axis=-1))  # (..., S)
    angle = cplx.angle(pe)
    rot = cplx.expi(-angle)
    data = (mapper.demap_symbols(eq[0]), mapper.demap_symbols(eq[1]))
    return cplx.mul(data, (rot[0][..., None], rot[1][..., None]))


def decode_frame_p(samples: CArr, rate: Rate, length: int, start=0,
                   cfo_correct: bool = False,
                   viterbi_impl: str | None = None):
    """Full frame decode from a raw planar sample stream.

    samples: planar (re, im) of (..., n) containing a frame whose preamble
    starts at `start` (static or traced ints, broadcast over batch).
    rate, length: static frame configuration.
    cfo_correct: estimate CFO from the LTS pair and derotate all symbols
    (native-mode improvement; the reference's CFO loop is dead code,
    src/timing_sync.cpp:109-112, so its effective correction is a constant
    phase that the equalizer absorbs anyway).

    Returns dict with payload (..., length), crc_ok, header_ok,
    rate_field, hdr_length, service.
    """
    rp = params_for(rate)
    nsym = rp.num_symbols(length)
    start = jnp.broadcast_to(jnp.asarray(start, jnp.int32),
                             samples[0].shape[:-1])
    lts, syms = extract_symbols_p(samples, start, nsym)
    if cfo_correct:
        w = estimate_cfo_cascade_p(samples, start, lts)
        # indices relative to the LTS1 body start; the leftover constant
        # phase e^{-j*w*(LTS1 abs offset)} is common to LTS and data
        # symbols, so the zero-forcing equalizer absorbs it
        lts_idx, sym_idx = derotation_indices(1 + nsym)
        lts = _derotate_p(lts, w, lts_idx)
        syms = _derotate_p(syms, w, sym_idx)
    h_inv = channel_estimate_p(lts)
    data = equalize_and_track_p(syms, h_inv)  # planar (..., 1+nsym, 48)

    sig = (data[0][..., 0, :], data[1][..., 0, :])
    rate_field, hdr_length, header_ok = ppdu.decode_header_p(sig)
    rest = (data[0][..., 1:, :].reshape(*data[0].shape[:-2], -1),
            data[1][..., 1:, :].reshape(*data[1].shape[:-2], -1))
    payload, crc_ok, service = ppdu.decode_data_p(
        rest, rate, length, viterbi_impl=viterbi_impl)
    return {
        "payload": payload,
        "crc_ok": crc_ok,
        "header_ok": header_ok,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "service": service,
    }


def decode_frame_dynamic_p(samples: CArr, rate: Rate, max_length: int,
                           start=0, cfo_correct: bool = False,
                           viterbi_impl: str | None = None):
    """Header-driven frame decode: payload length comes from the SIGNAL
    field at runtime (the reference receiver's contract - it knows nothing
    about a frame before decoding its header, src/frame_decoder.cpp:72-88).

    samples must cover max_length-frame extents from `start` (pad the
    stream); rate is static - a frame whose decoded header carries a
    different rate field (or an out-of-range length) gets crc_ok=False and
    its header fields reported, mirroring the reference's skip-and-report.

    Returns dict with payload (..., max_length) (first hdr_length bytes
    valid), crc_ok, header_ok, rate_field, hdr_length, service,
    rate_match, viterbi_exact (False only when a block-overlap Viterbi
    merge guard flagged the frame - the caller should re-decode it with
    an exact impl; always True for exact impls).
    """
    rp = params_for(rate)
    nsym_max = rp.num_symbols(max_length)
    start = jnp.broadcast_to(jnp.asarray(start, jnp.int32),
                             samples[0].shape[:-1])
    lts, syms = extract_symbols_p(samples, start, nsym_max)
    if cfo_correct:
        w = estimate_cfo_cascade_p(samples, start, lts)
        lts_idx, sym_idx = derotation_indices(1 + nsym_max)
        lts = _derotate_p(lts, w, lts_idx)
        syms = _derotate_p(syms, w, sym_idx)
    h_inv = channel_estimate_p(lts)
    data = equalize_and_track_p(syms, h_inv)

    sig = (data[0][..., 0, :], data[1][..., 0, :])
    rate_field, hdr_length, header_ok = ppdu.decode_header_p(sig)
    rate_match = rate_field == rp.rate_field
    rest = (data[0][..., 1:, :].reshape(*data[0].shape[:-2], -1),
            data[1][..., 1:, :].reshape(*data[1].shape[:-2], -1))
    payload, crc_ok, service, viterbi_exact = ppdu.decode_data_dynamic_p(
        rest, rate, hdr_length, max_length, viterbi_impl=viterbi_impl,
        return_exact=True)
    return {
        "payload": payload,
        "crc_ok": crc_ok & header_ok & rate_match,
        "header_ok": header_ok,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "service": service,
        "rate_match": rate_match,
        "viterbi_exact": viterbi_exact,
    }


def decode_frame_anyrate_p(samples: CArr, rates: tuple[Rate, ...],
                           max_length: int, start=0,
                           cfo_correct: bool = False,
                           viterbi_impl: str | None = None):
    """Universal header-driven decode: BOTH rate and length come from the
    frame's SIGNAL field at runtime.

    One jitted graph decodes a frame of any rate in `rates` (the
    reference's zero-configuration contract, src/frame_decoder.cpp:72-88):
    symbols are extracted at the slowest configured rate's geometry, the
    SIGNAL header selects the frame's rate index, and
    ppdu.decode_data_anyrate_p finishes the payload through per-rate
    fused gather tables + one dynamic-length Viterbi. samples must cover
    the slowest rate's max_length frame extent from `start` (pad the
    stream). A frame at an unconfigured rate reports its header with
    crc_ok=False.

    Returns dict with payload (..., max_length), crc_ok, header_ok,
    rate_field, hdr_length, service, rate_match (True iff the header
    rate is one of `rates`), viterbi_exact.
    """
    rates = tuple(rates)
    nsym_max = max(params_for(r).num_symbols(max_length) for r in rates)
    start = jnp.broadcast_to(jnp.asarray(start, jnp.int32),
                             samples[0].shape[:-1])
    lts, syms = extract_symbols_p(samples, start, nsym_max)
    if cfo_correct:
        w = estimate_cfo_cascade_p(samples, start, lts)
        lts_idx, sym_idx = derotation_indices(1 + nsym_max)
        lts = _derotate_p(lts, w, lts_idx)
        syms = _derotate_p(syms, w, sym_idx)
    h_inv = channel_estimate_p(lts)
    data = equalize_and_track_p(syms, h_inv)

    sig = (data[0][..., 0, :], data[1][..., 0, :])
    rate_field, hdr_length, header_ok = ppdu.decode_header_p(sig)
    # header rate field -> index into the configured rates tuple
    rate_idx = jnp.full_like(rate_field, -1)
    for i, r in enumerate(rates):
        rate_idx = jnp.where(rate_field == params_for(r).rate_field,
                             i, rate_idx)
    rate_match = rate_idx >= 0
    rest = (data[0][..., 1:, :].reshape(*data[0].shape[:-2], -1),
            data[1][..., 1:, :].reshape(*data[1].shape[:-2], -1))
    payload, crc_ok, service, viterbi_exact = ppdu.decode_data_anyrate_p(
        rest, rates, rate_idx, hdr_length, max_length,
        viterbi_impl=viterbi_impl)
    return {
        "payload": payload,
        "crc_ok": crc_ok & header_ok & rate_match,
        "header_ok": header_ok,
        "rate_field": rate_field,
        "hdr_length": hdr_length,
        "service": service,
        "rate_match": rate_match,
        "viterbi_exact": viterbi_exact,
    }


def decode_frame(samples: jnp.ndarray, rate: Rate, length: int, start=0,
                 cfo_correct: bool = False):
    """Complex wrapper of decode_frame_p (host/tests)."""
    return decode_frame_p((jnp.real(samples), jnp.imag(samples)),
                          rate, length, start, cfo_correct=cfo_correct)


@functools.lru_cache(maxsize=None)
def decode_frame_jit(rate: Rate, length: int, cfo_correct: bool = False):
    """Jitted complex decode_frame specialized for one (rate, length)."""
    return jax.jit(functools.partial(
        decode_frame, rate=rate, length=length, cfo_correct=cfo_correct))


@functools.lru_cache(maxsize=None)
def decode_frame_p_jit(rate: Rate, length: int, cfo_correct: bool = False):
    """Jitted planar decode_frame (device path)."""
    return jax.jit(functools.partial(
        decode_frame_p, rate=rate, length=length, cfo_correct=cfo_correct))
