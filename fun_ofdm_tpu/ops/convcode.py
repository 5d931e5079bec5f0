"""K=7 rate-1/2 convolutional encoder, polynomials {121, 91} (0171/0133).

The reference encodes bit-serially through a shift register
(reference: src/viterbi.cpp:39-62): the register starts at 0, consumes
data bits MSB-first, and for each input bit emits
parity(sr & poly_k) for k in {0, 1}.

Array formulation: output bit pair at time i is the GF(2) inner product of the
last 7 input bits with the polynomial taps - i.e. a mod-2 convolution. We
compute it as an integer correlation against the tap patterns followed by
&1, which XLA vectorizes; no scan, no sequential dependency.

Note the reference's tail handling: `conv_encode(data, out, data_bits)`
reads data_bits+6 bits from the input array - the 6 "tail" bits are simply
the next 6 bits of the caller's buffer, NOT forced zeros
(reference: src/viterbi.cpp:48, src/ppdu.cpp:150-153). We replicate by
taking an input of exactly data_bits+6 bits.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

K = 7
POLYS = (121, 91)

# taps[k][m] = bit m of poly k; sr bit m holds input bit b_{i-m}
_TAPS = np.array(
    [[(p >> m) & 1 for m in range(K)] for p in POLYS], dtype=np.int32
)  # (2, 7)


def conv_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """Encode bits (..., n) -> coded (..., 2n), interleaved g0,g1 per step.

    The input must already include any tail bits the caller wants encoded
    (the reference passes data_bits+6 total). Output bit 2i is poly 121's
    output at step i, 2i+1 is poly 91's (reference: src/viterbi.cpp:55-60).
    """
    bits = jnp.asarray(bits, jnp.int32)
    n = bits.shape[-1]
    padded = jnp.concatenate(
        [jnp.zeros(bits.shape[:-1] + (K - 1,), jnp.int32), bits], axis=-1
    )  # sr starts at 0
    # windows[..., i, m] = b_{i-m} = padded[..., i + 6 - m]
    idx = (jnp.arange(n)[:, None] + (K - 1) - jnp.arange(K)[None, :])  # (n, 7)
    windows = padded[..., idx]  # (..., n, 7)
    taps = jnp.asarray(_TAPS)  # (2, 7)
    outs = jnp.einsum("...nm,km->...nk", windows, taps) & 1  # (..., n, 2)
    return outs.reshape(*bits.shape[:-1], 2 * n)
