"""The reference's fixed 48-bit interleaver.

802.11a 17.3.5.6 defines a two-permutation interleaver over cbps bits, but
the reference always instantiates BitInterleave(48, 1) - a fixed 48-element
permutation applied in 48-bit chunks at every rate
(reference: src/interleaver.cpp:18,31, src/interleaver.h:66-75). Nonstandard
for cbps > 48, but TX and RX agree. With bpsc=1 the second permutation is
the identity, so: perm[k] = 3*(k % 16) + k // 16, out[perm[k]] = in[k].

A fixed 48-permutation is a static gather.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

CHUNK = 48

#: perm[k] = output position of input bit k within a 48-bit chunk.
PERM: np.ndarray = (3 * (np.arange(CHUNK) % 16) + np.arange(CHUNK) // 16).astype(np.int32)
#: inverse permutation: out[k] = in[INV_PERM[k]]
INV_PERM: np.ndarray = np.argsort(PERM).astype(np.int32)


def interleave(bits: jnp.ndarray) -> jnp.ndarray:
    """(..., n) -> (..., n), n divisible by 48. out[perm[k]] = in[k]."""
    shape = bits.shape
    chunks = bits.reshape(*shape[:-1], -1, CHUNK)
    out = chunks[..., jnp.asarray(INV_PERM)]
    return out.reshape(shape)


def deinterleave(bits: jnp.ndarray) -> jnp.ndarray:
    """Inverse of interleave: out[k] = in[perm[k]]."""
    shape = bits.shape
    chunks = bits.reshape(*shape[:-1], -1, CHUNK)
    out = chunks[..., jnp.asarray(PERM)]
    return out.reshape(shape)
