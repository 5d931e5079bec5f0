"""Puncturing / depuncturing for coding rates 2/3 and 3/4.

Patterns replicated from the reference (src/puncturer.cpp:24-123):
  3/4: per 6 coded bits keep indices {0, 1, 3, 5}
  2/3: per 4 coded bits keep indices {0, 2, 3}   (nonstandard - standard
       802.11a keeps {0,1,2} - but TX and RX agree so it round-trips)
Depuncturing inserts the soft-erasure value 127 into the holes
(src/puncturer.cpp:98-117).

Both are static gathers/scatters.
"""

from __future__ import annotations

from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from ..rates import Rate, params_for

ERASURE = 127

_KEEP = {  # group_size -> kept indices
    6: np.array([0, 1, 3, 5]),  # rate-3/4 code
    4: np.array([0, 2, 3]),  # rate-2/3 code
}


def _pattern(rate: Rate) -> tuple[int, np.ndarray] | None:
    """(group_size, kept_indices) or None for rate-1/2."""
    rel = params_for(rate).rel_rate
    if rel == Fraction(1):
        return None
    if rel == Fraction(2, 3):  # rate-3/4 code
        return 6, _KEEP[6]
    if rel == Fraction(3, 4):  # rate-2/3 code
        return 4, _KEEP[4]
    raise ValueError(f"unsupported rel_rate {rel}")


def puncture(coded: jnp.ndarray, rate: Rate) -> jnp.ndarray:
    """(..., n) coded bits -> punctured bits; n divisible by the group size."""
    pat = _pattern(rate)
    if pat is None:
        return coded
    group, keep = pat
    n = coded.shape[-1]
    groups = coded[..., : n - n % group].reshape(*coded.shape[:-1], -1, group)
    return groups[..., keep].reshape(*coded.shape[:-1], -1)


def depuncture(soft: jnp.ndarray, rate: Rate) -> jnp.ndarray:
    """(..., m) soft bits -> (..., n) with ERASURE=127 in the holes.

    Built as a static per-column stack (the `.at[..., keep].set` form
    can lower to a sequential while-scatter; a stack of static
    columns is a pure layout op)."""
    pat = _pattern(rate)
    if pat is None:
        return soft
    group, keep = pat
    kept = len(keep)
    m = soft.shape[-1]
    groups = soft[..., : m - m % kept].reshape(*soft.shape[:-1], -1, kept)
    erase = jnp.full(groups.shape[:-1], ERASURE, dtype=soft.dtype)
    cols = []
    for j in range(group):
        if j in keep:
            cols.append(groups[..., list(keep).index(j)])
        else:
            cols.append(erase)
    out = jnp.stack(cols, axis=-1)
    return out.reshape(*soft.shape[:-1], -1)
