"""Reference-compatible byte-granular scrambler.

The reference advances a 7-bit LFSR (x^7+x^4+1, seed 93) once per BYTE and
XORs the feedback bit into that byte's least-significant bit only
(reference: src/ppdu.cpp:140-148). This is nonstandard 802.11a (which
scrambles per bit) but self-inverse, and TX/RX agree.

Because the LFSR feedback never depends on the data, the whole operation is
an XOR with a precomputed keystream - O(1) depth, no scan needed.
The keystream has period 127.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

SEED = 93


@functools.lru_cache(maxsize=None)
def _keystream_period() -> np.ndarray:
    """One 127-byte period of per-byte feedback bits from seed 93."""
    state = SEED
    out = np.zeros(127, dtype=np.int32)
    for i in range(127):
        feedback = ((state >> 6) & 1) ^ ((state >> 3) & 1)
        out[i] = feedback
        state = ((state << 1) & 0x7E) | feedback
    return out


def keystream(n: int) -> np.ndarray:
    """First n per-byte feedback bits (numpy, host-side)."""
    period = _keystream_period()
    reps = -(-n // 127)
    return np.tile(period, reps)[:n]


def scramble_bytes(data: jnp.ndarray) -> jnp.ndarray:
    """XOR the keystream bit into the LSB of each byte. Self-inverse.

    data: (..., n) int32 bytes; n static.
    """
    n = data.shape[-1]
    ks = jnp.asarray(keystream(n))
    return jnp.asarray(data, jnp.int32) ^ ks


descramble_bytes = scramble_bytes  # self-inverse
