"""Gray-coded QAM modulation and exact soft demodulation.

Replicates the reference's recursive per-axis PAM scheme
(reference: src/qam.h:83-125, src/modulator.cpp:29-163):

  encode: pt = 0; flip = 1; per bit b in {-1,+1}: pt = b*flip + 2*pt,
          flip *= -b; symbol-axis = pt * sf,
          sf = sqrt(power * nn / sum((2k+1)^2, k<nn)), nn = 2^(bits-1).
  decode: pt = trunc(sym * (1<<(8-bits))/sf)   [C truncation toward zero]
          per bit: conf = clamp(flip*pt + 128, 0, 255); s = sign(pt)
          (sign(0)=+1); pt -= s*amp; flip = -s; amp /= 2;
          amp starts at nn << (8-bits).

Per-rate mapping (reference: src/modulator.cpp:37-92):
  BPSK : QAM<1>(power=1.0), real axis only (imag = 0)
  QPSK : QAM<1>(0.5) per axis; bit 0 -> I, bit 1 -> Q
  QAM16: QAM<2>(0.5) per axis; bits 0,1 -> I, bits 2,3 -> Q
  QAM64: QAM<3>(0.5) per axis; bits 0..2 -> I, bits 3..5 -> Q

Soft outputs are uint8-range confidences (0..255, 128 = erasure midpoint)
carried as int32.
"""

from __future__ import annotations

import functools
import math

import jax.numpy as jnp
import numpy as np

from ..rates import Rate, params_for


def _axis_params(num_bits: int, power: float) -> tuple[float, float, int]:
    """(scale_e, scale_d, amp0) for one axis of a 2^num_bits-PAM."""
    nn = 1 << (num_bits - 1)
    sum2 = (4 * nn * nn * nn - nn) // 3
    sf = math.sqrt(power * nn / sum2)
    d_gain = 8 - num_bits
    return sf, (1 << d_gain) / sf, nn << d_gain


_MOD_CFG = {  # bpsc -> (axis_bits, power)
    1: (1, 1.0),
    2: (1, 0.5),
    4: (2, 0.5),
    6: (3, 0.5),
}


@functools.lru_cache(maxsize=None)
def _encode_lut(axis_bits: int, power: float) -> np.ndarray:
    """LUT: axis bit-group (MSB-first index) -> PAM amplitude."""
    sf, _, _ = _axis_params(axis_bits, power)
    out = np.zeros(1 << axis_bits)
    for idx in range(1 << axis_bits):
        pt, flip = 0, 1
        for i in range(axis_bits):
            b = 2 * ((idx >> (axis_bits - 1 - i)) & 1) - 1
            pt = b * flip + 2 * pt
            flip *= -b
        out[idx] = pt * sf
    return out


def modulate_p(bits: jnp.ndarray, rate: Rate, dtype=jnp.float32):
    """(..., n) coded bits -> planar (re, im) of (..., n/bpsc) symbols."""
    bpsc = params_for(rate).bpsc
    axis_bits, power = _MOD_CFG[bpsc]
    lut = jnp.asarray(_encode_lut(axis_bits, power), dtype)
    bits = jnp.asarray(bits, jnp.int32)
    n = bits.shape[-1]
    if bpsc == 1:  # BPSK: one bit -> real axis
        re = lut[bits]
        return re, jnp.zeros_like(re)
    groups = bits.reshape(*bits.shape[:-1], n // bpsc, bpsc)
    weights = jnp.asarray(2 ** np.arange(axis_bits - 1, -1, -1, dtype=np.int32))
    i_idx = jnp.sum(groups[..., :axis_bits] * weights, axis=-1)
    q_idx = jnp.sum(groups[..., axis_bits:] * weights, axis=-1)
    return lut[i_idx], lut[q_idx]


def modulate(bits: jnp.ndarray, rate: Rate, dtype=jnp.complex64) -> jnp.ndarray:
    """Complex wrapper of modulate_p (host/tests)."""
    real_dtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    re, im = modulate_p(bits, rate, dtype=real_dtype)
    return (re + 1j * im).astype(dtype)


def _axis_soft_decode(vals: jnp.ndarray, axis_bits: int, power: float) -> jnp.ndarray:
    """(...,) axis values -> (..., axis_bits) soft confidences 0..255."""
    _, scale_d, amp0 = _axis_params(axis_bits, power)
    # C double->int conversion truncates toward zero (reference: qam.h:112).
    # Precision follows the input dtype (f32 on the device path; f64 in
    # x64 CPU tests).
    pt = jnp.trunc(vals * scale_d).astype(jnp.int32)
    flip = jnp.ones_like(pt)
    amp = amp0
    outs = []
    for _ in range(axis_bits):
        outs.append(jnp.clip(flip * pt + 128, 0, 255))
        s = jnp.where(pt >= 0, 1, -1)
        pt = pt - s * amp
        flip = -s
        amp //= 2
    return jnp.stack(outs, axis=-1)


def demodulate_p(symbols, rate: Rate) -> jnp.ndarray:
    """Planar (re, im) of (..., m) symbols -> (..., m*bpsc) soft bits
    (int32, 0..255)."""
    sym_re, sym_im = symbols
    bpsc = params_for(rate).bpsc
    axis_bits, power = _MOD_CFG[bpsc]
    re = _axis_soft_decode(sym_re, axis_bits, power)
    if bpsc == 1:
        return re.reshape(*sym_re.shape[:-1], -1)
    im = _axis_soft_decode(sym_im, axis_bits, power)
    both = jnp.concatenate([re, im], axis=-1)  # (..., m, bpsc)
    return both.reshape(*sym_re.shape[:-1], -1)


def demodulate(symbols: jnp.ndarray, rate: Rate) -> jnp.ndarray:
    """Complex wrapper of demodulate_p (host/tests)."""
    return demodulate_p((jnp.real(symbols), jnp.imag(symbols)), rate)


#: layout of demodulate_all_p's per-sample soft vector: bpsc -> offset of
#: that modulation's soft bits within the 13-wide vector (bit j of sample
#: m at modulation bpsc lives at 13*m + ALL_SOFT_OFFSET[bpsc] + j)
ALL_SOFT_OFFSET = {1: 0, 2: 1, 4: 3, 6: 7}
ALL_SOFT_WIDTH = 13


def demodulate_all_p(symbols) -> jnp.ndarray:
    """Soft-demodulate every sample under ALL four 802.11a modulations.

    symbols: planar (re, im) of (..., m). Returns (..., m, 13) uint8 soft
    bits (uint8 keeps the materialized all-modulation tensor 4x smaller
    than int32 at large decode batches) - per sample:
    [BPSK(1) | QPSK I,Q(2) | 16-QAM I0,I1,Q0,Q1(4) |
    64-QAM I0..2,Q0..2(6)] (see ALL_SOFT_OFFSET). This is the
    rate-independent half of the universal any-rate payload decoder
    (models/ppdu.decode_data_anyrate_p): elementwise and cheap, it lets
    one jitted graph decode frames of any rate by gathering the right
    soft lanes per frame instead of compiling one graph per rate.
    Per-modulation semantics identical to demodulate_p (reference:
    src/modulator.cpp:108-163).
    """
    sym_re, sym_im = symbols
    parts = [_axis_soft_decode(sym_re, 1, 1.0)]           # BPSK (re only)
    for axis_bits in (1, 2, 3):                           # QPSK/16/64-QAM
        parts.append(_axis_soft_decode(sym_re, axis_bits, 0.5))
        parts.append(_axis_soft_decode(sym_im, axis_bits, 0.5))
    # per-modulation order is [I bits..., Q bits...], matching
    # demodulate_p's concatenate([re, im]) layout
    return jnp.concatenate(parts, axis=-1).astype(jnp.uint8)
