"""TX frame builder: payload bytes -> baseband time-domain frame.

Device equivalent of the reference frame_builder
(src/frame_builder.cpp:53-82): ppdu encode -> subcarrier map -> batched
64-pt IFFT (planar DFT matmuls) -> cyclic-prefix insert ->
preamble prepend, as one pure jitted function over batched frames. All
shapes are static per (rate, payload length); batch via leading dims.

The device path is planar (re, im) float (ops/cplx.py). The complex
`build_frame` wrapper is for host-side/test use.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import preamble as pre
from ..ops import fft64, mapper
from ..rates import Rate, params_for
from . import ppdu


def _assemble_frame_p(sam_re: jnp.ndarray, sam_im: jnp.ndarray, dtype):
    """Shared TX tail: modulated data samples -> time-domain frame.

    map onto 48+4+12 subcarriers, batched 64-pt IFFT, cyclic-prefix
    insert, preamble prepend (reference: src/frame_builder.cpp:53-82).
    Used by both the static and the mixed-length builders so the frame
    assembly has a single definition."""
    batch = sam_re.shape[:-1]
    syms = (sam_re.reshape(*batch, -1, 48), sam_im.reshape(*batch, -1, 48))
    mapped = mapper.map_symbols_p(syms, start_symbol=0)  # (..., S, 64)
    t_re, t_im = fft64.inverse_p(mapped)

    def cp_and_flatten(t):
        prefixed = jnp.concatenate([t[..., 48:], t], axis=-1)  # (..., S, 80)
        return prefixed.reshape(*batch, -1)

    flat_re, flat_im = cp_and_flatten(t_re), cp_and_flatten(t_im)
    pre_re = jnp.broadcast_to(
        jnp.asarray(pre.PREAMBLE_SAMPLES.real, dtype), batch + (320,))
    pre_im = jnp.broadcast_to(
        jnp.asarray(pre.PREAMBLE_SAMPLES.imag, dtype), batch + (320,))
    return (jnp.concatenate([pre_re, flat_re], axis=-1),
            jnp.concatenate([pre_im, flat_im], axis=-1))


def build_frame_p(payload: jnp.ndarray, rate: Rate, dtype=jnp.float32):
    """payload (..., length) bytes -> planar (re, im) frame samples of
    (..., 320+80*(1+nsym))."""
    sam_re, sam_im = ppdu.encode_p(payload, rate, dtype=dtype)
    return _assemble_frame_p(sam_re, sam_im, dtype)


def build_frame(payload: jnp.ndarray, rate: Rate,
                dtype=jnp.complex64) -> jnp.ndarray:
    """Complex wrapper of build_frame_p (host/tests)."""
    real_dtype = jnp.float64 if dtype == jnp.complex128 else jnp.float32
    re, im = build_frame_p(payload, rate, dtype=real_dtype)
    return (re + 1j * im).astype(dtype)


@functools.lru_cache(maxsize=None)
def build_frame_jit(rate: Rate, dtype=jnp.complex64):
    """A jitted complex build_frame specialized for one rate."""
    return jax.jit(functools.partial(build_frame, rate=rate, dtype=dtype))


@functools.lru_cache(maxsize=None)
def build_frame_p_jit(rate: Rate, dtype=jnp.float32):
    """A jitted planar build_frame specialized for one rate (device path)."""
    return jax.jit(functools.partial(build_frame_p, rate=rate, dtype=dtype))


def build_frames_mixed_p(payload: jnp.ndarray, lengths, rate: Rate,
                         dtype=jnp.float32):
    """Mixed-length batched frame builder: ONE jitted graph builds a whole
    burst of frames with different payload lengths (reference transmitter
    flexibility, src/transmitter.cpp:33-37, at the batched path's cost).

    payload: (..., max_length) zero-padded bytes; lengths: (...,) traced
    true byte counts. Returns (re, im, n_samples): planar max-shape frame
    buffers whose first n_samples[i] = 320 + 80*(1+num_symbols(length_i))
    samples are exactly build_frame_p's output for that frame (the
    encoder is prefix-exact, see ppdu.encode_data_dynamic_p); the caller
    slices each frame's true extent.
    """
    rp = params_for(rate)
    lengths = jnp.asarray(lengths, jnp.int32)
    sam_re, sam_im = ppdu.encode_dynamic_p(payload, lengths, rate,
                                           dtype=dtype)
    out_re, out_im = _assemble_frame_p(sam_re, sam_im, dtype)
    frame_bits = 16 + 8 * (jnp.clip(lengths, 1, payload.shape[-1]) + 4) + 6
    nsym = (frame_bits + rp.dbps - 1) // rp.dbps
    n_samples = 320 + 80 * (1 + nsym)
    return out_re, out_im, n_samples


@functools.lru_cache(maxsize=None)
def build_frames_mixed_p_jit(rate: Rate, dtype=jnp.float32):
    """Jitted planar mixed-length builder for one rate (device path)."""
    return jax.jit(functools.partial(build_frames_mixed_p, rate=rate,
                                     dtype=dtype))
