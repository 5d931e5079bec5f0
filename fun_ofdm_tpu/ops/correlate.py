"""Sliding-window correlators for the RX front-end (planar complex).

Data-parallel replacements for the reference's per-sample loops:

  * STS autocorrelation + power (reference: src/frame_detector.cpp:47-63,
    src/circular_accumulator.h) -> windowed sums built from shifted adds
    (exact per-window arithmetic - no long cumsum error accumulation).
  * plateau detection (reference: src/frame_detector.cpp:65-82) -> a
    trailing-window count (a matmul) instead of a stateful counter.
  * 64-tap LTS cross-correlation (reference: src/timing_sync.cpp:74-86)
    -> 64 shifted scaled adds over the whole stream (fusable elementwise).

All functions take planar (re, im) streams, operate on the last axis, and
broadcast over leading dims.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import preamble as pre
from .cplx import CArr


#: matmul precision of the correlator banks: full f32. On a GPU a lower
#: precision runs f32 products in TF32 (10-bit mantissa, ~3 digits),
#: which is coarse for metrics compared against 0.9 thresholds and for
#: window sums over stream positions.
PRECISION = jax.lax.Precision.HIGHEST


def _trailing_window_sum(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """y[n] = sum_{k=n-w+1..n} x[k], zeros before the start. Shape-preserving.

    Polyphase matmul (same structure as the LTS correlator below): with
    n = w*q + r the window splits between row q (columns <= r) and row
    q-1 (columns > r), i.e. one (n/w, w) @ (w, w) product against each
    triangle of an all-ones matrix. Exact per-window sums (no cumsum
    drift); f32 accumulation at Precision.HIGHEST. Replaces w unrolled
    full-array shifted adds.
    """
    q = -(-x.shape[-1] // w)
    padlen = q * w - x.shape[-1]
    zrow = jnp.zeros(x.shape[:-1] + (w,), x.dtype)
    pad = jnp.zeros(x.shape[:-1] + (padlen,), x.dtype)
    rows = jnp.concatenate([zrow, x, pad], axis=-1).reshape(
        *x.shape[:-1], q + 1, w)
    c = np.arange(w)[:, None]
    r = np.arange(w)[None, :]
    tri_a = jnp.asarray((c <= r).astype(np.float32))   # row q
    tri_b = jnp.asarray((c > r).astype(np.float32))    # row q-1

    def mm(rr, m):
        return jax.lax.dot_general(
            rr, m, (((rr.ndim - 1,), (0,)), ((), ())),
            precision=PRECISION,
            preferred_element_type=jnp.float32)

    y = mm(rows[..., 1:, :], tri_a) + mm(rows[..., :-1, :], tri_b)
    return y.reshape(*x.shape[:-1], q * w)[..., : x.shape[-1]]


def sts_autocorrelation(x: CArr, lag: int = 16):
    """Schmidl&Cox-style lagged autocorrelation and power, per sample.

    corr[n] = sum over the last 16 samples of x[k]*conj(x[k-16]) (x[<0]=0),
    power[n] = sum of |x[k]|^2 over the same window - exactly the two
    circular accumulators in the reference detector.
    Returns (corr planar, power real), shapes of x.
    """
    re, im = x
    pad = jnp.zeros(re.shape[:-1] + (lag,), re.dtype)
    dre = jnp.concatenate([pad, re[..., :-lag]], axis=-1)
    dim = jnp.concatenate([pad, im[..., :-lag]], axis=-1)
    # x * conj(delayed)
    p_re = re * dre + im * dim
    p_im = im * dre - re * dim
    corr = (_trailing_window_sum(p_re, lag), _trailing_window_sum(p_im, lag))
    power = _trailing_window_sum(re * re + im * im, lag)
    return corr, power


def sts_ratio(x: CArr, lag: int = 16) -> jnp.ndarray:
    """Normalized |corr|/power with zero-power guarded to 0.

    (The reference computes NaN at zero power, and NaN > threshold is
    false - guarding to 0 gives identical comparisons.)
    """
    corr, power = sts_autocorrelation(x, lag)
    mag = jnp.sqrt(corr[0] * corr[0] + corr[1] * corr[1])
    return jnp.where(power > 0, mag / jnp.where(power > 0, power, 1), 0.0)


def sts_end_events(ratio: jnp.ndarray, threshold: float,
                   plateau_len: int) -> jnp.ndarray:
    """Boolean mask of STS_END positions.

    Matches the reference's stateful counter (frame_detector.cpp:65-82):
    an end fires at the first below-threshold sample following a run of at
    least `plateau_len` above-threshold samples.

    run_length[n-1] >= L is exactly "the L samples before n are all
    above", i.e. an L-trailing-window count equal to L - so the test
    rides the same polyphase window-sum matmul as the autocorrelator
    instead of a log-depth cummax scan over the whole stream.
    """
    above = ratio > threshold
    cnt = _trailing_window_sum(above.astype(jnp.float32), plateau_len)
    prev_full = jnp.concatenate(
        [jnp.zeros(above.shape[:-1] + (1,), above.dtype),
         cnt[..., :-1] >= plateau_len - 0.5], axis=-1)
    return (~above) & prev_full


def _leading_window_sum(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """y[n] = sum_{k=n..n+w-1} x[k], zeros past the end. Shape-preserving.

    Mirror of _trailing_window_sum: with n = w*q + r the window splits
    between row q (columns >= r) and row q+1 (columns < r) - two
    polyphase matmuls against complementary triangles.
    """
    q = -(-x.shape[-1] // w)
    padlen = (q + 1) * w - x.shape[-1]
    pad = jnp.zeros(x.shape[:-1] + (padlen,), x.dtype)
    rows = jnp.concatenate([x, pad], axis=-1).reshape(
        *x.shape[:-1], q + 1, w)
    c = np.arange(w)[:, None]
    r = np.arange(w)[None, :]
    tri_a = jnp.asarray((c >= r).astype(np.float32))   # row q
    tri_b = jnp.asarray((c < r).astype(np.float32))    # row q+1

    def mm(rr, m):
        return jax.lax.dot_general(
            rr, m, (((rr.ndim - 1,), (0,)), ((), ())),
            precision=PRECISION,
            preferred_element_type=jnp.float32)

    y = mm(rows[..., :q, :], tri_a) + mm(rows[..., 1:, :], tri_b)
    return y.reshape(*x.shape[:-1], q * w)[..., : x.shape[-1]]


def leading_window_any(mask: jnp.ndarray, w: int) -> jnp.ndarray:
    """out[n] = any(mask[n : n+w]) (False past the end). Shape-preserving.

    Polyphase matmul window count (exact: small integer counts in f32)
    instead of a log-depth cumsum scan over the whole stream.
    """
    return _leading_window_sum(mask.astype(jnp.float32), w) > 0.5


@functools.lru_cache(maxsize=None)
def _lts_polyphase_taps(segments: int = 1):
    """Static polyphase tap matrices for the matmul correlation.

    A[c, r] = taps[c - r] for c >= r (row q's contribution to output
    phase r), B[c, r] = taps[64 + c - r] for c < r (row q+1's); the
    all-ones masks compute the window power with the same split.

    segments > 1 splits the 64 taps into that many contiguous segments
    and block-stacks their tap matrices horizontally ((64, segments*64)),
    so ONE matmul yields every segment's partial correlation
    (out column k*64 + r = segment k's correlation at phase r). Used by
    the CFO-tolerant sync (see lts_correlation)."""
    taps = np.asarray(pre.LTS_TIME_DOMAIN_CONJ)
    c = np.arange(64)[:, None]
    r = np.arange(64)[None, :]
    lo_idx = np.where(c >= r, c - r, 0)
    hi_idx = np.where(c < r, 64 + c - r, 0)
    seg = 64 // segments
    a_blocks, b_blocks = [], []
    for k in range(segments):
        in_seg_lo = (c >= r) & (lo_idx // seg == k)
        in_seg_hi = (c < r) & (hi_idx // seg == k)
        a_blocks.append(np.where(in_seg_lo, taps[lo_idx], 0))
        b_blocks.append(np.where(in_seg_hi, taps[hi_idx], 0))
    a = np.concatenate(a_blocks, axis=1)     # (64, segments*64)
    b = np.concatenate(b_blocks, axis=1)
    return {
        "a_re": a.real.astype(np.float32),
        "a_im": a.imag.astype(np.float32),
        "b_re": b.real.astype(np.float32),
        "b_im": b.imag.astype(np.float32),
        "ones_a": (c >= r).astype(np.float32),
        "ones_b": (c < r).astype(np.float32),
    }


def lts_correlation(x: CArr, segments: int = 1) -> jnp.ndarray:
    """64-tap LTS matched filter over the whole stream.

    norm[p] = |sum_s x[p+s] * conj(LTS[s])| / sum_s |x[p+s]|^2
    (reference: timing_sync.cpp:77-84). Positions with p+63 beyond the end
    are zero. Returns (..., n) float.

    segments > 1 makes the metric CFO-tolerant: the 64 taps split into
    `segments` contiguous sub-correlations whose MAGNITUDES are summed
    (norm[p] = sum_k |corr_k[p]| / power[p]). A carrier offset w rotates
    a coherent 64-sample correlation through 2*pi*w*64 radians and
    collapses its peak (0.62 of nominal at w = 8e-3 cycles/sample - below
    the 0.9 threshold, so the frame is never found); 4x16-sample segments
    keep the peak >= 0.95 there and >= 0.9 out to ~ +-1/32, the coarse
    CFO estimator's full unambiguous range (models/rx.estimate_cfo_p).
    Noise raises the noncoherent floor ~2x, so this stays opt-in
    (ChainParams.lts_segments) for CFO-impaired deployments.

    Polyphase matmul formulation: with p = 64q + r, y[64q+r] splits into
    two (n/64, 64) @ (64, 64) matmuls (row q against a lower-triangular
    tap matrix, row q+1 against the complementary upper triangle) instead
    of 64 unrolled multiply-adds, and the window power uses the same split
    with all-ones taps. f32 accumulation at Precision.HIGHEST keeps
    threshold comparisons stable.
    """
    re, im = x
    n = re.shape[-1]
    if 64 % segments:
        raise ValueError("segments must divide 64")
    t = _lts_polyphase_taps(segments)
    q = -(-n // 64)                 # rows covering every start position
    padlen = (q + 1) * 64 - n       # +1 row so row q+1 always exists
    pad = jnp.zeros(re.shape[:-1] + (padlen,), re.dtype)
    xr = jnp.concatenate([re, pad], axis=-1).reshape(*re.shape[:-1], q + 1, 64)
    xi = jnp.concatenate([im, pad], axis=-1).reshape(*re.shape[:-1], q + 1, 64)
    xs = xr * xr + xi * xi

    def mm(rows, m):
        return jax.lax.dot_general(
            rows, jnp.asarray(m),
            (((rows.ndim - 1,), (0,)), ((), ())),
            precision=PRECISION,
            preferred_element_type=jnp.float32)

    r0_r, r1_r = xr[..., :q, :], xr[..., 1:, :]
    r0_i, r1_i = xi[..., :q, :], xi[..., 1:, :]
    # y = sum x*t with t = conj(LTS): c_re = xr*tr - xi*ti, c_im = xr*ti + xi*tr
    c_re = (mm(r0_r, t["a_re"]) + mm(r1_r, t["b_re"])
            - mm(r0_i, t["a_im"]) - mm(r1_i, t["b_im"]))
    c_im = (mm(r0_r, t["a_im"]) + mm(r1_r, t["b_im"])
            + mm(r0_i, t["a_re"]) + mm(r1_i, t["b_re"]))
    power = mm(xs[..., :q, :], t["ones_a"]) + mm(xs[..., 1:, :], t["ones_b"])

    shape = re.shape[:-1] + (q * 64,)
    if segments > 1:
        # (..., q, segments*64) -> per-segment magnitudes, summed
        seg_shape = re.shape[:-1] + (q, segments, 64)
        c_re = c_re.reshape(seg_shape)
        c_im = c_im.reshape(seg_shape)
        mag = jnp.sqrt(c_re * c_re + c_im * c_im).sum(axis=-2)
        mag = mag.reshape(shape)[..., :n]
    else:
        c_re = c_re.reshape(shape)[..., :n]
        c_im = c_im.reshape(shape)[..., :n]
        mag = jnp.sqrt(c_re * c_re + c_im * c_im)
    power = power.reshape(shape)[..., :n]
    valid = jnp.arange(n) <= n - 64
    norm = jnp.where(power > 0, mag / jnp.where(power > 0, power, 1), 0.0)
    return jnp.where(valid, norm, 0.0)
