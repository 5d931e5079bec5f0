"""Batched 64-pt FFT/IFFT in the centered subcarrier convention.

The reference wraps FFTW3 with an fftshift index map so callers always see
symbols in centered order - index 0 is subcarrier -32
(reference: src/fft.cpp:20-96); the inverse scales by 1/64 (fft.cpp:92-95).

Formulation: a 64-pt DFT is tiny, so instead of an FFT butterfly (or
jnp.fft on complex dtypes, which the planar convention avoids - see
ops/cplx.py) each direction is a pair of real 64x64 matmuls on planar
(re, im) data, at full f32 precision, with the fftshift folded into the
matrices at construction, costing nothing.

  inverse:  time[n] = (1/64) * sum_k sym[k] e^{+2pi i n (k-32)/64}
  forward:  sym[k]  =          sum_n time[n] e^{-2pi i (k-32) n /64}

Complex-dtype wrappers (forward/inverse) are provided for host-side and
test use.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import CArr

PRECISION = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _matrices(inverse: bool, dtype_str: str):
    k = np.arange(64.0)  # centered index
    n = np.arange(64.0)
    if inverse:
        ang = 2.0 * np.pi * np.outer(k - 32.0, n) / 64.0  # [k, n]
        c = np.cos(ang) / 64.0
        s = np.sin(ang) / 64.0
    else:
        ang = -2.0 * np.pi * np.outer(n, k - 32.0) / 64.0  # [n, k]
        c = np.cos(ang)
        s = np.sin(ang)
    dt = np.dtype(dtype_str)
    return c.astype(dt), s.astype(dt)


def _apply(x: CArr, inverse: bool) -> CArr:
    re, im = x
    c, s = _matrices(inverse, str(re.dtype))
    cj = jnp.asarray(c)
    sj = jnp.asarray(s)
    # (a + ib)(C + iS) with row-vector convention: out = x @ M; full f32
    # (a lower precision is TF32 on a GPU: ~3 digits, too coarse for
    # 64-QAM soft decisions)
    def mm(a, m):
        return jnp.matmul(a, m, precision=PRECISION)

    out_re = mm(re, cj) - mm(im, sj)
    out_im = mm(re, sj) + mm(im, cj)
    return out_re, out_im


def inverse_p(symbols: CArr) -> CArr:
    """Planar (..., 64) centered-order freq symbols -> time samples."""
    return _apply(symbols, inverse=True)


def forward_p(samples: CArr) -> CArr:
    """Planar (..., 64) time samples -> centered-order freq symbols."""
    return _apply(samples, inverse=False)


# --- complex wrappers (host/tests; CPU backend only) ----------------------

def inverse(symbols: jnp.ndarray) -> jnp.ndarray:
    re, im = inverse_p((jnp.real(symbols), jnp.imag(symbols)))
    return re + 1j * im


def forward(samples: jnp.ndarray) -> jnp.ndarray:
    re, im = forward_p((jnp.real(samples), jnp.imag(samples)))
    return re + 1j * im
