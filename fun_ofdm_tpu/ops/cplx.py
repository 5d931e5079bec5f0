"""Planar complex arithmetic: (re, im) pairs of real arrays.

The device path never touches jnp.complex64: the convention dates from a
backend without complex dtypes, and it keeps the trailing axis a full
tile of samples / subcarriers instead of interleaved re/im, with DFTs as
real matmuls (see ops/fft64.py). Whether complex64 + jnp.fft beats it on
the GPU is ROADMAP Design #6.

Convention: a planar complex array is a plain tuple `(re, im)` of
equal-shaped float arrays. Host-side helpers convert to/from numpy/jnp
complex at API boundaries only.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

CArr = Tuple[jnp.ndarray, jnp.ndarray]


def from_complex(x) -> CArr:
    """Split a complex array into planar (re, im). Host/boundary use only."""
    return jnp.real(x), jnp.imag(x)


def to_complex(a: CArr):
    """Combine planar (re, im) into a complex array. Host/boundary only."""
    return a[0] + 1j * a[1]


def add(a: CArr, b: CArr) -> CArr:
    return a[0] + b[0], a[1] + b[1]


def mul(a: CArr, b: CArr) -> CArr:
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def mul_conj(a: CArr, b: CArr) -> CArr:
    """a * conj(b)."""
    return a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1]


def conj(a: CArr) -> CArr:
    return a[0], -a[1]


def scale(a: CArr, s) -> CArr:
    return a[0] * s, a[1] * s


def abs2(a: CArr) -> jnp.ndarray:
    return a[0] * a[0] + a[1] * a[1]


def abs_(a: CArr) -> jnp.ndarray:
    return jnp.sqrt(abs2(a))


def angle(a: CArr) -> jnp.ndarray:
    return jnp.arctan2(a[1], a[0])


def expi(theta: jnp.ndarray) -> CArr:
    """e^{i theta} as planar."""
    return jnp.cos(theta), jnp.sin(theta)


def div(a: CArr, b: CArr, eps_guard: bool = False) -> CArr:
    """a / b; with eps_guard, zero denominators yield 0 instead of inf."""
    d = abs2(b)
    if eps_guard:
        safe = jnp.where(d > 0, d, 1.0)
        num = mul_conj(a, b)
        return (jnp.where(d > 0, num[0] / safe, 0.0),
                jnp.where(d > 0, num[1] / safe, 0.0))
    num = mul_conj(a, b)
    return num[0] / d, num[1] / d


def zeros_like(a: CArr) -> CArr:
    return jnp.zeros_like(a[0]), jnp.zeros_like(a[1])


def concatenate(arrs, axis: int = -1) -> CArr:
    return (jnp.concatenate([a[0] for a in arrs], axis=axis),
            jnp.concatenate([a[1] for a in arrs], axis=axis))


def slice_last(a: CArr, sl) -> CArr:
    return a[0][..., sl], a[1][..., sl]


def np_split(x: np.ndarray):
    """numpy complex -> planar numpy float pair."""
    return np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag)
