"""PPDU codec: PLCP header + payload encode/decode.

Reimplements the reference ppdu class (src/ppdu.cpp) as pure batched
functions. Frame geometry (rate, payload length) is static configuration;
payload *content* is traced. The SIGNAL header depends only on (rate,
length), so its 48 BPSK samples are a trace-time numpy constant.

Reference quirks replicated (see SURVEY.md section 7):
  * header field layout: parity(1)|rate(4)|reserved(1)|length(12)|tail(6),
    transmitted MSB-first (src/ppdu.cpp:86-95);
  * byte-granular LSB-only scrambler, seed 93 (src/ppdu.cpp:140-148);
  * the 6 encoder tail bits are the next bits of the scrambled buffer,
    not forced zeros (src/ppdu.cpp:150-153);
  * CRC-32 little-endian over [service(2) | payload] (src/ppdu.cpp:134-137).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ..ops import convcode, crc32, interleave, puncture, qam, scramble, viterbi
from ..rates import Rate, VALID_RATE_FIELDS, params_for
from ..utils.bits import bits_to_bytes, bytes_to_bits, np_bytes_to_bits

HEADER_BITS = 18  # rate(4)+reserved(1)+length(12)+parity(1) data bits
SERVICE_BYTES = 2
CRC_BYTES = 4
TAIL_BITS = 6


def _parity_int(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=None)
def header_samples_np(rate: Rate, length: int) -> np.ndarray:
    """The 48 BPSK SIGNAL-symbol data samples for (rate, length).

    Static per configuration (reference: src/ppdu.cpp:81-110). Pure numpy
    so it is safe to call during jit tracing (it is a trace-time constant).
    """
    rp = params_for(rate)
    field = ((rp.rate_field & 0xF) << 13) | (length & 0xFFF)
    if _parity_int(field) == 1:
        field |= 1 << 17
    field <<= 6  # 24-bit word, 6 tail zeros
    header_bytes = np.array(
        [(field >> 16) & 0xFF, (field >> 8) & 0xFF, field & 0xFF, 0], np.int32)
    bits = np_bytes_to_bits(header_bytes)[: HEADER_BITS + TAIL_BITS]
    # serial K=7 conv encode (24 bits) + fixed 48-bit interleave, in numpy
    sr = 0
    coded = np.zeros(2 * len(bits), np.int32)
    for i, b in enumerate(bits):
        sr = ((sr << 1) | int(b)) & 0x7F
        coded[2 * i] = bin(sr & convcode.POLYS[0]).count("1") & 1
        coded[2 * i + 1] = bin(sr & convcode.POLYS[1]).count("1") & 1
    inter = np.zeros_like(coded)
    inter[interleave.PERM] = coded
    # BPSK values are exactly +-1
    return (2.0 * inter - 1.0).astype(np.complex128)


def encode_data_p(payload: jnp.ndarray, rate: Rate, dtype=jnp.float32):
    """Encode payload bytes to modulated data-subcarrier samples (planar).

    payload: (..., length) int bytes. Returns planar (re, im) of
    (..., num_symbols*48). (reference: src/ppdu.cpp:112-165)
    """
    rp = params_for(rate)
    length = payload.shape[-1]
    n_bits = rp.num_data_bits(length)
    n_bytes = rp.num_data_bytes(length)
    batch = payload.shape[:-1]

    payload = jnp.asarray(payload, jnp.int32)
    service = jnp.zeros(batch + (SERVICE_BYTES,), jnp.int32)
    crc = crc32.crc32(jnp.concatenate([service, payload], axis=-1))
    crc_le = jnp.stack(
        [(crc >> (8 * i)) & 0xFF for i in range(4)], axis=-1).astype(jnp.int32)
    pad = jnp.zeros(batch + (n_bytes + 1 - SERVICE_BYTES - length - CRC_BYTES,),
                    jnp.int32)
    data = jnp.concatenate([service, payload, crc_le, pad], axis=-1)

    # scramble the first n_bytes bytes; the +1 spill byte stays clear
    scrambled = scramble.scramble_bytes(data[..., :n_bytes])
    data = jnp.concatenate([scrambled, data[..., n_bytes:]], axis=-1)

    bits = bytes_to_bits(data)[..., :n_bits]  # data bits + in-buffer tail
    coded = convcode.conv_encode(bits)  # (..., 2*n_bits)
    punctured = puncture.puncture(coded, rate)
    inter = interleave.interleave(punctured)
    return qam.modulate_p(inter, rate, dtype=dtype)


def encode_p(payload: jnp.ndarray, rate: Rate, dtype=jnp.float32):
    """Header + data samples, planar: (re, im) of (..., (1+nsym)*48)."""
    length = payload.shape[-1]
    hdr_np = header_samples_np(rate, length)
    hdr_re = jnp.broadcast_to(jnp.asarray(hdr_np.real, dtype),
                              payload.shape[:-1] + (48,))
    hdr_im = jnp.zeros_like(hdr_re)
    data_re, data_im = encode_data_p(payload, rate, dtype)
    return (jnp.concatenate([hdr_re, data_re], axis=-1),
            jnp.concatenate([hdr_im, data_im], axis=-1))


def encode(payload: jnp.ndarray, rate: Rate, dtype=jnp.complex64) -> jnp.ndarray:
    """Complex wrapper of encode_p (host/tests)."""
    real_dtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    re, im = encode_p(payload, rate, dtype=real_dtype)
    return (re + 1j * im).astype(dtype)


def decode_header_p(samples):
    """Decode planar (re, im) 48 SIGNAL samples -> (rate_field, length, ok).

    All outputs are traced arrays; `ok` covers parity + valid-rate checks
    (reference: src/ppdu.cpp:168-218).
    """
    soft = qam.demodulate_p(samples, Rate.RATE_1_2_BPSK)
    deinter = interleave.deinterleave(soft)
    bits = viterbi.viterbi_decode(deinter, HEADER_BITS)
    pad = jnp.zeros(bits.shape[:-1] + (24 - HEADER_BITS,), jnp.int32)
    field_bytes = bits_to_bytes(jnp.concatenate([bits, pad], axis=-1))
    field = (field_bytes[..., 0] << 16) | (field_bytes[..., 1] << 8) | field_bytes[..., 2]

    # 24-bit even parity
    par = field
    for s in (16, 8, 4, 2, 1):
        par = par ^ (par >> s)
    parity_ok = (par & 1) == 0

    rate_field = (field >> 19) & 0xF
    length = (field >> 6) & 0xFFF
    valid = jnp.zeros_like(parity_ok)
    for v in VALID_RATE_FIELDS:
        valid = valid | (rate_field == v)
    return rate_field, length, parity_ok & valid


def decode_header(samples: jnp.ndarray):
    """Complex wrapper of decode_header_p (host/tests)."""
    return decode_header_p((jnp.real(samples), jnp.imag(samples)))


def decode_data_p(samples, rate: Rate, length: int,
                  viterbi_impl: str | None = None):
    """Decode planar (re, im) of (..., num_symbols*48) equalized samples.

    Returns (payload (..., length) int32, crc_ok (...,) bool, service).
    (reference: src/ppdu.cpp:223-295)
    """
    rp = params_for(rate)
    n_bits = rp.num_data_bits(length)
    n_bytes = rp.num_data_bytes(length)

    soft = qam.demodulate_p(samples, rate)
    deinter = interleave.deinterleave(soft)
    depunct = puncture.depuncture(deinter, rate)
    decoded_bits = viterbi.viterbi_decode(depunct, n_bits - TAIL_BITS,
                                          impl=viterbi_impl)
    pad = (-decoded_bits.shape[-1]) % 8
    if pad:
        decoded_bits = jnp.concatenate(
            [decoded_bits,
             jnp.zeros(decoded_bits.shape[:-1] + (pad,), jnp.int32)], axis=-1)
    decoded = bits_to_bytes(decoded_bits)  # (..., >= 2+length+4 bytes)

    descrambled = scramble.descramble_bytes(decoded[..., :n_bytes])

    service = (descrambled[..., 0].astype(jnp.int32)
               | (descrambled[..., 1].astype(jnp.int32) << 8))
    payload = descrambled[..., SERVICE_BYTES:SERVICE_BYTES + length]
    given_crc = descrambled[..., SERVICE_BYTES + length:SERVICE_BYTES + length + 4]
    given = (given_crc[..., 0].astype(jnp.uint32)
             | (given_crc[..., 1].astype(jnp.uint32) << 8)
             | (given_crc[..., 2].astype(jnp.uint32) << 16)
             | (given_crc[..., 3].astype(jnp.uint32) << 24))
    calc = crc32.crc32(descrambled[..., :SERVICE_BYTES + length])
    return payload, given == calc, service


def decode_data(samples: jnp.ndarray, rate: Rate, length: int):
    """Complex wrapper of decode_data_p (host/tests)."""
    return decode_data_p((jnp.real(samples), jnp.imag(samples)), rate, length)


def decode_data_dynamic_p(samples, rate: Rate, lengths, max_length: int,
                          viterbi_impl: str | None = None,
                          return_exact: bool = False):
    """Decode frames of traced per-frame byte lengths (static rate).

    samples: planar (re, im) of (..., max_nsym*48) equalized data samples,
    where max_nsym = num_symbols(max_length); samples past a frame's real
    extent are arbitrary garbage. lengths: (...,) traced payload byte
    counts (from the decoded SIGNAL header).

    Works because every per-position transform in the chain (demap,
    48-chunk interleaver, puncture pattern, scrambler keystream) is
    position-uniform, so a shorter frame occupies an exact prefix of the
    static buffers; the Viterbi masks trellis steps past each frame's end
    (zero decisions = reference tail semantics) and the CRC right-aligns.

    Returns (payload (..., max_length) int32 - first `lengths` bytes valid,
    crc_ok (...,) bool, service (...,) int32); with return_exact=True a
    fourth (...,) bool - the Viterbi backend's bit-exactness flag
    (ops/viterbi.viterbi_decode return_exact).
    (reference: src/ppdu.cpp:223-295 - where rate/length are runtime values)
    """
    rp = params_for(rate)
    n_bits_max = rp.num_data_bits(max_length)
    n_bytes_max = rp.num_data_bytes(max_length)

    lengths = jnp.asarray(lengths, jnp.int32)
    in_range = (lengths >= 1) & (lengths <= max_length)
    lengths_c = jnp.clip(lengths, 1, max_length)
    frame_bits = 16 + 8 * (lengths_c + CRC_BYTES) + TAIL_BITS
    nsym = (frame_bits + rp.dbps - 1) // rp.dbps
    nbits = nsym * rp.dbps  # per-frame data bits incl in-buffer tail

    soft = qam.demodulate_p(samples, rate)
    deinter = interleave.deinterleave(soft)
    depunct = puncture.depuncture(deinter, rate)
    decoded_bits = viterbi.viterbi_decode(
        depunct, n_bits_max - TAIL_BITS, nbits_dynamic=nbits - TAIL_BITS,
        impl=viterbi_impl, return_exact=return_exact)
    if return_exact:
        decoded_bits, exact_ok = decoded_bits
    pad = (-decoded_bits.shape[-1]) % 8
    if pad:
        decoded_bits = jnp.concatenate(
            [decoded_bits,
             jnp.zeros(decoded_bits.shape[:-1] + (pad,), jnp.int32)], axis=-1)
    decoded = bits_to_bytes(decoded_bits)
    descrambled = scramble.descramble_bytes(decoded[..., :n_bytes_max])

    service = (descrambled[..., 0].astype(jnp.int32)
               | (descrambled[..., 1].astype(jnp.int32) << 8))
    payload = descrambled[..., SERVICE_BYTES:SERVICE_BYTES + max_length]

    # given CRC: 4 bytes at dynamic offset 2 + length
    off = (SERVICE_BYTES + lengths_c)[..., None] + jnp.arange(4)
    flat = descrambled.reshape(-1, descrambled.shape[-1])
    given_b = jnp.take_along_axis(
        flat, jnp.clip(off.reshape(flat.shape[0], 4), 0, flat.shape[-1] - 1),
        axis=-1).reshape(lengths_c.shape + (4,))
    given = (given_b[..., 0].astype(jnp.uint32)
             | (given_b[..., 1].astype(jnp.uint32) << 8)
             | (given_b[..., 2].astype(jnp.uint32) << 16)
             | (given_b[..., 3].astype(jnp.uint32) << 24))
    calc = crc32.crc32_dynamic(
        descrambled[..., :SERVICE_BYTES + max_length],
        SERVICE_BYTES + lengths_c)
    crc_ok = (given == calc) & in_range
    if return_exact:
        return payload, crc_ok, service, exact_ok
    return payload, crc_ok, service


@functools.lru_cache(maxsize=None)
def _anyrate_tables(rates: tuple[Rate, ...], max_length: int):
    """Static per-rate gather tables for the universal any-rate decoder.

    For each configured rate, the demap -> deinterleave -> depuncture
    composition is a pure position permutation with erasure holes (every
    stage is position-uniform; see decode_data_dynamic_p), so it folds
    into ONE gather table: tab[r][m] = index into the flattened
    per-sample 13-wide all-modulation soft vector
    (ops/qam.demodulate_all_p) of depunctured coded bit m, or -1 for a
    depuncture erasure / past-end slot (reference transform chain:
    src/modulator.cpp:108-163, src/interleaver.cpp:15-37,
    src/puncturer.cpp:98-117).

    Returns (tabs (n_rates, 2*nbits_max) int32, dbps (n_rates,) int32,
    rate_fields (n_rates,) int32, nbits_max, n_bytes_max).
    """
    from ..ops.qam import ALL_SOFT_OFFSET, ALL_SOFT_WIDTH

    nbits_max = max(params_for(r).num_data_bits(max_length) for r in rates)
    n_bytes_max = max(params_for(r).num_data_bytes(max_length)
                      for r in rates)
    n_coded_max = 2 * nbits_max
    tabs = []
    for r in rates:
        rp = params_for(r)
        n_coded = 2 * rp.num_data_bits(max_length)
        pat = puncture._pattern(r)
        m_idx = np.arange(n_coded)
        if pat is None:
            k_of_m = m_idx
            valid = np.ones(n_coded, bool)
        else:
            group, keep = pat
            g, j = m_idx // group, m_idx % group
            valid = np.isin(j, keep)
            k_of_m = g * len(keep) + np.searchsorted(keep, j)
        kk = np.where(valid, k_of_m, 0)
        # deinterleave: punctured bit k reads demodulated soft position
        # 48*(k//48) + PERM[k%48] (fixed 48-chunk permutation)
        soft_j = 48 * (kk // 48) + interleave.PERM[kk % 48]
        # soft bit j of modulation bpsc lives at sample j//bpsc, lane
        # ALL_SOFT_OFFSET[bpsc] + j%bpsc of the 13-wide vector
        tab = (ALL_SOFT_WIDTH * (soft_j // rp.bpsc)
               + ALL_SOFT_OFFSET[rp.bpsc] + soft_j % rp.bpsc)
        full = np.full(n_coded_max, -1, np.int32)
        full[:n_coded] = np.where(valid, tab, -1)
        tabs.append(full)
    return (np.stack(tabs).astype(np.int32),
            np.array([params_for(r).dbps for r in rates], np.int32),
            np.array([params_for(r).rate_field for r in rates], np.int32),
            nbits_max, n_bytes_max)


def _anyrate_coded_select(samples, rates, ridx, n_coded_max):
    """Per-frame coded soft stream via STATIC per-rate pipelines + select.

    The gather-table strategy pays one ~2*nbits_max-index dynamic
    take_along_axis per frame (several times the per-symbol cost of the
    static single-rate pipeline on the earlier accelerator); here each
    configured rate's demod -> deinterleave -> depuncture runs as the SAME
    static ops the single-rate decoder uses (fixed permutations XLA folds
    into layouts), and an R-way elementwise select by the frame's header rate
    picks the stream. Output-identical to the gather table: coded slots
    past a frame's real extent differ only where the dynamic-length
    Viterbi masks them.
    """
    acc = None
    for i, r in enumerate(rates):
        soft = qam.demodulate_p(samples, r)
        de = interleave.deinterleave(soft)
        dp = puncture.depuncture(de, r).astype(jnp.int32)
        cur = dp[..., :n_coded_max]
        pad = n_coded_max - cur.shape[-1]
        if pad > 0:
            cur = jnp.concatenate(
                [cur, jnp.full(cur.shape[:-1] + (pad,),
                               int(puncture.ERASURE), jnp.int32)], axis=-1)
        if acc is None:
            acc = jnp.where((ridx == i)[..., None], cur,
                            jnp.full_like(cur, int(puncture.ERASURE)))
        else:
            acc = jnp.where((ridx == i)[..., None], cur, acc)
    return acc


def decode_data_anyrate_p(samples, rates: tuple[Rate, ...], rate_idx,
                          lengths, max_length: int,
                          viterbi_impl: str | None = None,
                          strategy: str | None = None):
    """Universal payload decode: BOTH rate and length are traced values.

    One jitted graph decodes a frame of any configured rate: every sample
    is soft-demodulated under all four modulations (cheap, elementwise),
    then one per-frame gather - through the rate's fused
    demap/deinterleave/depuncture table - assembles the coded soft
    stream, and a single dynamic-length Viterbi (data-bit count depends
    only on length, not rate) + descramble + right-aligned CRC finish the
    frame. This replaces up to 11 per-rate compiled variants (and up to
    11 device dispatches per streaming superstep) with one
    (reference: src/frame_decoder.cpp:72-88 decodes any-rate frames with
    zero configuration; src/ppdu.cpp:223-295).

    samples: planar (re, im) of (..., nsym_max*48) equalized data
    samples, where nsym_max = max over rates of num_symbols(max_length).
    rate_idx: (...,) traced index into `rates` (from the decoded SIGNAL
    rate field; out-of-range = unknown rate, reported crc_ok=False).
    lengths: (...,) traced payload byte counts.

    strategy: "select" (default) assembles each frame's coded stream by
    running every configured rate's STATIC demod/deinterleave/depuncture
    pipeline and selecting by header rate; "gather" uses the fused
    per-rate gather tables over the 13-wide all-modulation soft vector.
    Identical outputs; select was the faster one on the earlier
    accelerator, and the GPU A/B is ROADMAP Design #4.
    FUN_OFDM_ANYRATE overrides.

    Returns (payload (..., max_length), crc_ok, service, viterbi_exact).
    """
    import os
    if strategy is None:
        strategy = os.environ.get("FUN_OFDM_ANYRATE") or "select"
    tabs, dbps_tab, _, nbits_max, n_bytes_max = _anyrate_tables(
        tuple(rates), max_length)

    rate_idx = jnp.asarray(rate_idx, jnp.int32)
    known = (rate_idx >= 0) & (rate_idx < len(rates))
    ridx = jnp.clip(rate_idx, 0, len(rates) - 1)

    lengths = jnp.asarray(lengths, jnp.int32)
    in_range = (lengths >= 1) & (lengths <= max_length) & known
    lengths_c = jnp.clip(lengths, 1, max_length)
    frame_bits = 16 + 8 * (lengths_c + CRC_BYTES) + TAIL_BITS
    dbps = jnp.asarray(dbps_tab)[ridx]
    nsym = (frame_bits + dbps - 1) // dbps
    nbits = nsym * dbps  # per-frame data bits incl in-buffer tail

    if strategy == "select":
        coded = _anyrate_coded_select(samples, rates, ridx, 2 * nbits_max)
    else:
        soft_all = qam.demodulate_all_p(samples)   # (..., m, 13)
        flat13 = soft_all.reshape(*soft_all.shape[:-2], -1)
        tab = jnp.asarray(tabs)[ridx]              # (..., 2*nbits_max)
        idx = jnp.clip(tab, 0, flat13.shape[-1] - 1)
        coded = jnp.where(tab >= 0,
                          jnp.take_along_axis(flat13, idx, axis=-1),
                          jnp.uint8(puncture.ERASURE)).astype(jnp.int32)

    decoded_bits, exact_ok = viterbi.viterbi_decode(
        coded, nbits_max - TAIL_BITS, nbits_dynamic=nbits - TAIL_BITS,
        impl=viterbi_impl, return_exact=True)
    pad = (-decoded_bits.shape[-1]) % 8
    if pad:
        decoded_bits = jnp.concatenate(
            [decoded_bits,
             jnp.zeros(decoded_bits.shape[:-1] + (pad,), jnp.int32)],
            axis=-1)
    decoded = bits_to_bytes(decoded_bits)
    descrambled = scramble.descramble_bytes(decoded[..., :n_bytes_max])

    service = (descrambled[..., 0].astype(jnp.int32)
               | (descrambled[..., 1].astype(jnp.int32) << 8))
    payload = descrambled[..., SERVICE_BYTES:SERVICE_BYTES + max_length]
    off = (SERVICE_BYTES + lengths_c)[..., None] + jnp.arange(4)
    flat = descrambled.reshape(-1, descrambled.shape[-1])
    given_b = jnp.take_along_axis(
        flat, jnp.clip(off.reshape(flat.shape[0], 4), 0, flat.shape[-1] - 1),
        axis=-1).reshape(lengths_c.shape + (4,))
    given = (given_b[..., 0].astype(jnp.uint32)
             | (given_b[..., 1].astype(jnp.uint32) << 8)
             | (given_b[..., 2].astype(jnp.uint32) << 16)
             | (given_b[..., 3].astype(jnp.uint32) << 24))
    calc = crc32.crc32_dynamic(
        descrambled[..., :SERVICE_BYTES + max_length],
        SERVICE_BYTES + lengths_c)
    return payload, (given == calc) & in_range, service, exact_ok


def encode_data_dynamic_p(payload: jnp.ndarray, lengths, rate: Rate,
                          dtype=jnp.float32):
    """Encode zero-padded payload bytes with traced per-frame lengths.

    payload: (..., max_length) int bytes, zeros past each frame's real
    length; lengths: (...,) traced byte counts. Returns planar (re, im)
    of (..., nsym_max*48) modulated data samples whose first
    num_symbols(length)*48 samples are EXACTLY the static encoder's
    output for that length (every transform in the chain - scrambler
    keystream, conv encoder, puncture pattern, 48-chunk interleave, QAM
    grouping - is position-uniform/causal, so a shorter frame occupies an
    exact prefix of the max-shape buffers; the dual of
    decode_data_dynamic_p). Samples past a frame's true extent are
    well-defined garbage the caller slices away.

    This is the mixed-length batched TX path (reference transmitter takes
    arbitrary per-frame lengths one call at a time,
    src/transmitter.cpp:33-37; here a whole mixed burst encodes in ONE
    device dispatch).
    """
    rp = params_for(rate)
    max_length = payload.shape[-1]
    n_bits = rp.num_data_bits(max_length)
    n_bytes = rp.num_data_bytes(max_length)
    batch = payload.shape[:-1]

    payload = jnp.asarray(payload, jnp.int32)
    lengths = jnp.broadcast_to(jnp.asarray(lengths, jnp.int32), batch)
    lengths_c = jnp.clip(lengths, 1, max_length)

    service = jnp.zeros(batch + (SERVICE_BYTES,), jnp.int32)
    msg = jnp.concatenate([service, payload], axis=-1)
    crc = crc32.crc32_dynamic(msg, SERVICE_BYTES + lengths_c)
    crc_le = jnp.stack(
        [(crc >> (8 * i)) & 0xFF for i in range(4)],
        axis=-1).astype(jnp.int32)

    # data buffer: [service | payload[:len] | crc_le | zeros], the CRC at
    # its dynamic offset via an elementwise select (no scatter)
    buf_len = n_bytes + 1
    msg_pad = jnp.concatenate(
        [msg, jnp.zeros(batch + (buf_len - msg.shape[-1],), jnp.int32)],
        axis=-1)
    idx = jnp.arange(buf_len, dtype=jnp.int32)
    crc_off = idx - (SERVICE_BYTES + lengths_c)[..., None]
    crc_sel = jnp.take_along_axis(
        crc_le.reshape(-1, 4),
        jnp.clip(crc_off, 0, 3).reshape(-1, buf_len),
        axis=-1).reshape(batch + (buf_len,))
    data = jnp.where(idx < (SERVICE_BYTES + lengths_c)[..., None], msg_pad,
                     jnp.where((crc_off >= 0) & (crc_off < 4), crc_sel, 0))

    # scramble the whole static extent: the keystream is position-uniform,
    # so bytes inside each frame's real extent match the static encoder
    # exactly; bytes past it only feed untransmitted bits
    scrambled = scramble.scramble_bytes(data[..., :n_bytes])
    data = jnp.concatenate([scrambled, data[..., n_bytes:]], axis=-1)

    bits = bytes_to_bits(data)[..., :n_bits]
    coded = convcode.conv_encode(bits)
    punctured = puncture.puncture(coded, rate)
    inter = interleave.interleave(punctured)
    return qam.modulate_p(inter, rate, dtype=dtype)


def header_samples_dynamic_p(lengths, rate: Rate, dtype=jnp.float32):
    """Traced-length SIGNAL symbol samples (planar re, im of (..., 48)).

    The traced twin of header_samples_np (reference src/ppdu.cpp:81-110):
    field = parity(1)|rate(4)|reserved(1)|length(12), 6 tail zeros,
    conv-encoded + 48-bit interleave + BPSK.
    """
    rp = params_for(rate)
    lengths = jnp.asarray(lengths, jnp.int32)
    field = ((rp.rate_field & 0xF) << 13) | (lengths & 0xFFF)
    par = field
    for s_ in (16, 8, 4, 2, 1):
        par = par ^ (par >> s_)
    field = field | ((par & 1) << 17)
    field = field << 6  # 24-bit word, 6 tail zeros
    shifts = jnp.arange(23, -1, -1, dtype=jnp.int32)
    bits24 = (field[..., None] >> shifts) & 1
    coded = convcode.conv_encode(bits24)          # (..., 48)
    inter = interleave.interleave(coded)
    re = (2.0 * inter - 1.0).astype(dtype)
    return re, jnp.zeros_like(re)


def encode_dynamic_p(payload: jnp.ndarray, lengths, rate: Rate,
                     dtype=jnp.float32):
    """Traced-length header + data samples, planar (..., (1+nsym_max)*48).

    The first (1 + num_symbols(length))*48 samples of each frame equal
    encode_p's output for that length (see encode_data_dynamic_p)."""
    hdr_re, hdr_im = header_samples_dynamic_p(lengths, rate, dtype)
    data_re, data_im = encode_data_dynamic_p(payload, lengths, rate, dtype)
    return (jnp.concatenate([hdr_re, data_re], axis=-1),
            jnp.concatenate([hdr_im, data_im], axis=-1))
