"""Soft-decision Viterbi decoder, K=7 rate-1/2, polys {121, 91}.

Bit-exact reimplementation of the reference's SPIRAL SSE kernel semantics
(reference: src/viterbi.cpp:166-459) as batched, state-vectorized JAX:

  * 64 states, path metrics are unsigned-8 semantics carried in int32:
    init all 63 with state 0 biased to 0 (viterbi.cpp:71-78);
    adds saturate at 255; when the *state-0* metric exceeds 210 after a
    step, the lane-minimum is subtracted from all metrics
    (viterbi.cpp:314-332).
  * branch metric for expected coded pair (e0, e1) against soft pair
    (s0, s1): t = ((s0 XOR E0) + (s1 XOR E1) + 1) >> 3 in 0..63, where
    Ek = 255 if ek else 0 and XOR-with-255 is complement
    (viterbi.cpp:242-251: _mm_avg_epu8 then >>2 & 63).
  * butterfly j in 0..31 pairs old states (j, j+32) -> new (2j, 2j+1):
      new[2j]   = min(old[j] + t_j,       old[j+32] + (63 - t_j))
      new[2j+1] = min(old[j] + (63-t_j),  old[j+32] + t_j)
    decision bit = 1 iff the j+32 path wins, ties -> 1
    (viterbi.cpp:252-267: _mm_min_epu8 + _mm_cmpeq_epi8 against the
    high-half candidate).
  * chainback from end state 0, skipping the first 6 decisions; decoded
    bit n = the decision bit read at trellis step n+6
    (viterbi.cpp:108-146).

The reference processes trellis steps in pairs and silently drops a final
odd step (viterbi.cpp:209: `i9 <= nbits/2-1`); we replicate by truncating
to an even step count. All 802.11a frame sizes are even so this never
triggers in practice.

Execution strategies (viterbi_decode dispatches):
  * `viterbi_decode_scan` - lax.scan over time, vectorized over (batch,
    32) butterflies. Exact, portable; the plain reference and the CPU
    path.
  * a GPU kernel through Pallas's Triton route (ops/viterbi_triton.py)
    that loops over time inside one launch - the GPU path.
  * `viterbi_decode_blocked` - the block-overlap time-parallel decode
    around either exact decoder, with a merge guard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

K = 7
NUMSTATES = 64
POLYS = (121, 91)


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=None)
def _branch_bits() -> tuple[np.ndarray, np.ndarray]:
    """(bt0, bt1): expected coded bits for butterfly j's j->2j transition.

    Branchtab[i][j] = parity((2j) & poly_i) (reference: viterbi.cpp:87-91).
    """
    bt0 = np.array([_parity((2 * j) & POLYS[0]) for j in range(32)], np.int32)
    bt1 = np.array([_parity((2 * j) & POLYS[1]) for j in range(32)], np.int32)
    return bt0, bt1


def _interleave_pairs(even: jnp.ndarray, odd: jnp.ndarray) -> jnp.ndarray:
    """(..., 32), (..., 32) -> (..., 64) with out[2j]=even[j], out[2j+1]=odd[j]."""
    stacked = jnp.stack([even, odd], axis=-1)  # (..., 32, 2)
    return stacked.reshape(*even.shape[:-1], 64)


def _acs_step(metrics: jnp.ndarray, s0: jnp.ndarray, s1: jnp.ndarray):
    """One trellis step.

    metrics: (..., 64) int32 path metrics (u8 semantics).
    s0, s1:  (...,) int32 soft symbol pair.
    Returns (new_metrics, decisions (..., 64) int32 0/1).
    """
    bt0, bt1 = _branch_bits()
    e0 = jnp.asarray(bt0, jnp.int32)  # (32,)
    e1 = jnp.asarray(bt1, jnp.int32)
    s0 = s0[..., None]
    s1 = s1[..., None]
    a = jnp.where(e0 == 1, 255 - s0, s0)  # (..., 32)
    b = jnp.where(e1 == 1, 255 - s1, s1)
    t = (a + b + 1) >> 3  # 0..63
    tc = 63 - t

    lo = metrics[..., :32]
    hi = metrics[..., 32:]
    m_even_lo = jnp.minimum(lo + t, 255)
    m_even_hi = jnp.minimum(hi + tc, 255)
    m_odd_lo = jnp.minimum(lo + tc, 255)
    m_odd_hi = jnp.minimum(hi + t, 255)

    new_even = jnp.minimum(m_even_lo, m_even_hi)
    dec_even = (m_even_hi <= m_even_lo).astype(jnp.int32)
    new_odd = jnp.minimum(m_odd_lo, m_odd_hi)
    dec_odd = (m_odd_hi <= m_odd_lo).astype(jnp.int32)

    new = _interleave_pairs(new_even, new_odd)
    dec = _interleave_pairs(dec_even, dec_odd)

    # renormalize when state 0's metric exceeds 210 (viterbi.cpp:314)
    need = new[..., 0:1] > 210
    new = jnp.where(need, new - jnp.min(new, axis=-1, keepdims=True), new)
    return new, dec


#: exact decoders (bit-exact with each other and the reference)
EXACT_IMPLS = ("scan", "triton")

#: merge-guard margin: bits excluded from each end of the doubly-decoded
#: cut region (each window's outermost bits are unreliable by design -
#: see viterbi_decode_blocked). 40 > the typical survivor-merge distance
#: of ~5 constraint lengths = 35 steps; the guarded overlap at the default
#: warmup=128 still leaves a 176-bit compared region.
_GUARD_TRIM = 40


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def viterbi_decode(soft: jnp.ndarray, nbits: int,
                   impl: str | None = None,
                   nbits_dynamic: jnp.ndarray | None = None,
                   return_exact: bool = False):
    """Decode soft symbols to bits.

    soft:  (..., 2*(nbits+6)) int32 soft coded bits (0..255; >=128 leans 1).
    nbits: number of data bits to output (static upper bound).
    impl:  'scan' | 'triton' | 'blocked' | None. None picks the exact
           decoder of the platform (utils/platform.exact_viterbi: the
           Triton kernel on a GPU, the scan elsewhere). 'scan' and
           'triton' are bit-exact; 'triton' raises where there is no GPU.
           'blocked' is the block-overlap time-parallel decode around the
           platform's exact decoder (viterbi_decode_blocked); its splices
           rely on survivor merges, so pass return_exact=True to get the
           per-element merge-agreement flag and re-decode flagged
           elements exactly.
    nbits_dynamic: optional traced (...,) per-element data-bit counts
           <= nbits. Trellis steps past an element's count produce zero
           decisions, so the chainback stays in state 0 until the element's
           real trellis end - exactly the reference semantics for a frame
           of that length (viterbi.cpp:193-194). Output bits past an
           element's count are unspecified.
    return_exact: also return a (...,) bool flag - True where the result
           carries the bit-exactness guarantee (always True for the exact
           impls; the blocked decode's merge guard otherwise).
    Returns (..., nbits) int32 decoded bits (plus the flag if requested).
    """
    from ..utils import platform

    impl = impl or platform.exact_viterbi()
    if impl not in EXACT_IMPLS + ("blocked",):
        raise ValueError(f"unknown Viterbi impl {impl!r}")
    if impl == "triton":
        platform.require_gpu("the Triton Viterbi kernel")
    if impl == "blocked":
        return viterbi_decode_blocked(soft, nbits,
                                      nbits_dynamic=nbits_dynamic,
                                      return_merge_ok=return_exact)
    if impl == "triton":
        from . import viterbi_triton

        bits = viterbi_triton.viterbi_decode_triton(
            soft, nbits, nbits_dynamic=nbits_dynamic)
    else:
        bits = viterbi_decode_scan(soft, nbits, nbits_dynamic=nbits_dynamic)
    if return_exact:
        return bits, jnp.ones(bits.shape[:-1], bool)
    return bits


def viterbi_decode_scan(soft: jnp.ndarray, nbits: int,
                        nbits_dynamic: jnp.ndarray | None = None,
                        unroll: int = 1) -> jnp.ndarray:
    """lax.scan trellis (exact, portable baseline impl).

    unroll: trellis steps per scan iteration (lax.scan's unroll)."""
    soft = jnp.asarray(soft, jnp.int32)
    steps_vec = None
    if nbits_dynamic is not None:
        nb = jnp.broadcast_to(jnp.asarray(nbits_dynamic, jnp.int32),
                              soft.shape[:-1])
        steps_vec = ((nb + (K - 1)) // 2) * 2
    return _scan_lanes(soft, steps_vec, None, nbits, unroll)


def _scan_lanes(soft: jnp.ndarray, steps_vec, init_vec, nbits: int,
                unroll: int = 1) -> jnp.ndarray:
    """The scan decoder over independent lanes.

    soft: (..., >= 2*(nbits+6)) int32. steps_vec: None (every lane runs
    the full even-truncated trellis) or (...,) even per-lane step counts.
    init_vec: None (exact frame-start init everywhere) or (...,) int32,
    1 = exact init, 0 = uniform init (a block-overlap window starting
    mid-trellis).
    """
    total_steps = nbits + (K - 1)
    steps = (total_steps // 2) * 2  # reference drops a trailing odd step
    batch_shape = soft.shape[:-1]

    state_idx = jnp.arange(NUMSTATES, dtype=jnp.int32)
    if init_vec is None:
        metrics0 = jnp.where(state_idx == 0, 0, 63)
        metrics0 = jnp.broadcast_to(metrics0, batch_shape + (NUMSTATES,))
    else:
        exact = jnp.asarray(init_vec)[..., None] == 1
        metrics0 = jnp.where(exact & (state_idx == 0), 0, 63)
    metrics0 = metrics0.astype(jnp.int32)

    pairs = soft[..., : 2 * steps].reshape(*batch_shape, steps, 2)
    pairs = jnp.moveaxis(pairs, -2, 0)  # (steps, ..., 2)
    if steps_vec is None:
        def fwd(metrics, pair):
            return _acs_step(metrics, pair[..., 0], pair[..., 1])

        _, decisions = jax.lax.scan(fwd, metrics0, pairs, unroll=unroll)
    else:
        # masked steps leave the metrics untouched and record zero
        # decisions
        t_idx = jnp.arange(steps, dtype=jnp.int32)

        def fwd(metrics, xs):
            t, pair = xs
            new, dec = _acs_step(metrics, pair[..., 0], pair[..., 1])
            live = (t < steps_vec)[..., None]
            return (jnp.where(live, new, metrics),
                    jnp.where(live, dec, 0))

        _, decisions = jax.lax.scan(fwd, metrics0, (t_idx, pairs),
                                    unroll=unroll)

    # decisions for steps in [steps, total_steps) were never computed;
    # the reference leaves them zeroed (viterbi.cpp:193-194)
    if steps < total_steps:
        pad = jnp.zeros((total_steps - steps,) + batch_shape + (64,), jnp.int32)
        decisions = jnp.concatenate([decisions, pad], axis=0)

    # chainback from end state 0 over t = total_steps-1 .. 0; decoded
    # bit n (= t-6) is the decision bit read at step t
    rev = decisions[::-1]  # t = total-1 first

    def back(state, dec_t):
        k = jnp.take_along_axis(dec_t, state[..., None], axis=-1)[..., 0]
        new_state = (state >> 1) | (k << 5)
        return new_state, k

    state0 = jnp.zeros(batch_shape, jnp.int32)
    _, ks = jax.lax.scan(back, state0, rev, unroll=unroll)
    ks = ks[::-1]  # ks[t] = decision bit at step t
    return jnp.moveaxis(ks[K - 1 : K - 1 + nbits], 0, -1)


def decode_lanes(soft: jnp.ndarray, steps_vec: jnp.ndarray,
                 init_vec: jnp.ndarray, nbits: int, impl: str,
                 interpret: bool = False) -> jnp.ndarray:
    """Exact decode of independent trellis lanes with per-lane step
    counts and init (the block-overlap decode's building block).

    soft (..., >= 2*(nbits+6)), steps_vec/init_vec (...,) int32 ->
    (..., nbits); bits at or past a lane's step count are zero.
    impl: 'scan' or 'triton' (interpret: the Pallas interpreter)."""
    if impl == "triton":
        from . import viterbi_triton

        return viterbi_triton.decode(soft, steps_vec, init_vec, nbits,
                                     interpret=interpret)
    steps_vec = jnp.asarray(steps_vec, jnp.int32)
    bits = _scan_lanes(jnp.asarray(soft, jnp.int32), steps_vec, init_vec,
                       nbits)
    t_idx = jnp.arange(K - 1, K - 1 + nbits, dtype=jnp.int32)
    return jnp.where(t_idx < steps_vec[..., None], bits, 0)


def viterbi_decode_blocked(soft: jnp.ndarray, nbits: int,
                           n_blocks: int = 16, warmup: int = 128,
                           nbits_dynamic: jnp.ndarray | None = None,
                           return_merge_ok: bool = False,
                           impl: str | None = None,
                           interpret: bool = False):
    """Block-overlap time-parallel decode (SURVEY.md section 7 hard part
    #1) around an exact lane decoder.

    Same contract as viterbi_decode (soft (..., 2*(nbits+6)) -> (...,
    nbits) bits). The trellis is split into n_blocks time blocks decoded
    as independent lanes; each block decodes its span plus a
    `warmup`-step lead-in (uniform metric init - the path metrics merge
    to the true survivor within ~5 constraint lengths) and a
    `warmup`-step tail (a truncated chainback from an arbitrary state
    merges the same way). Block 0 keeps the exact frame-start init; the
    last live block inherits the exact end-of-frame chainback. The
    sequential depth drops ~n_blocks-fold at 2*warmup/span extra work.

    Splice exactness is guarded, not assumed: around every block cut the
    2*warmup-step region [b*tb - wf, b*tb + wc) is decoded independently
    by both adjacent blocks, and with return_merge_ok=True the per-frame
    agreement over all cut regions is returned. A forward (warm-up) merge
    failure corrupts a block's lead-in; a reverse (truncated-chainback)
    merge failure corrupts a block's tail - both land inside a compared
    region, so a single-block merge failure flags the frame unless its
    neighbor independently fails onto identical wrong bits across the
    2*warmup-bit window (vanishing at warmup=128; constructible only at
    degenerate warmups). Callers (runtime/chain.py) re-decode flagged
    frames exactly, restoring a bit-exact end-to-end contract.

    impl: the exact lane decoder, 'scan' or 'triton' (None: the
    platform's, utils/platform.exact_viterbi). interpret: run the Triton
    kernel in the Pallas interpreter (CPU tests).
    """
    from ..utils import platform

    impl = impl or platform.exact_viterbi()
    if impl == "triton" and not interpret:
        platform.require_gpu("the Triton Viterbi kernel")
    soft = jnp.asarray(soft, jnp.int32)
    batch_shape = soft.shape[:-1]
    if nbits_dynamic is None:
        nb = jnp.full(batch_shape, nbits, jnp.int32)
    else:
        nb = jnp.broadcast_to(jnp.asarray(nbits_dynamic, jnp.int32),
                              batch_shape)
    steps_vec = ((nb + (K - 1)) // 2) * 2
    total_steps = nbits + (K - 1)
    n_blocks = max(1, min(n_blocks, total_steps // max(2 * warmup, 2)))

    flat = soft.reshape(-1, soft.shape[-1])
    nf = flat.shape[0]
    tb = _cdiv(total_steps, 2 * n_blocks) * 2     # even block span
    wf = _cdiv(warmup, 2) * 2
    wc = wf
    win = wf + tb + wc                            # window trellis steps
    # emit the FULL window (lead-in + span + tail): the tail bits cost
    # nothing (the chainback computes every window step anyway) and give
    # the merge guard a 2*warmup-wide doubly-decoded region at each cut
    nbits_win = win

    # per-block window offsets into the trellis (block 0 starts exact);
    # + (K-1) steps of padding: the decoded-bit slice for nbits_win = win
    # reads K-1 steps past the window (dead, zero-decision steps)
    offs = np.maximum(0, np.arange(n_blocks) * tb - wf).astype(np.int32)
    lane_len = 2 * (win + K - 1)
    flat_pad = jnp.pad(flat, ((0, 0), (0, lane_len)))
    wins = jnp.stack([
        jax.lax.dynamic_slice_in_dim(flat_pad, 2 * int(o), lane_len, axis=1)
        for o in offs], axis=1)                   # (F, n_blocks, lane_len)

    steps_w = jnp.clip(steps_vec.reshape(-1)[:, None] - offs[None, :],
                       0, win)                    # (F, n_blocks) even
    init_w = jnp.zeros((nf, n_blocks), jnp.int32).at[:, 0].set(1)

    bits = decode_lanes(wins, steps_w, init_w, nbits_win, impl,
                        interpret=interpret)      # (F, n_blocks, win)

    # splice: frame bit n lives in block b = n // tb at local index
    # n - b*tb (+wf lead for blocks after the first)
    n_idx = np.arange(nbits)
    b_idx = (n_idx // tb).astype(np.int32)
    m_idx = (n_idx - b_idx * tb + np.where(b_idx > 0, wf, 0)).astype(np.int32)
    out = bits[:, b_idx, m_idx].reshape(*batch_shape, nbits)
    if not return_merge_ok:
        return out

    # merge guard: compare the two independent decodes of the
    # doubly-decoded region around every cut, [b*tb - wf, b*tb + wc)
    # (block b-1's span end + truncation tail vs block b's lead-in +
    # span start). The outermost `trim` bits on each side are each
    # block's by-construction-unreliable margins (block b's first bits
    # sit right after its uniform metric init; block b-1's last bits are
    # its chainback truncation start, garbage until the backward merge
    # settles, typically within ~5K = 35 steps) — comparing them would
    # flag healthy frames constantly, so they are excluded. Masked to
    # each frame's real bit extent.
    ov = wf + wc
    trim = min(_GUARD_TRIM, ov // 4)
    nb_f = jnp.maximum(steps_vec.reshape(-1) - (K - 1), 0)  # real data bits
    live_hi = jnp.minimum(nb_f, nbits)[:, None]
    mism = jnp.zeros((nf,), bool)
    for b in range(1, n_blocks):
        lo = b * tb - wf                       # overlap start (trellis bit)
        prev_start = lo - int(offs[b - 1])     # local index in block b-1
        sl = slice(trim, ov - trim)
        prev = bits[:, b - 1, prev_start:prev_start + ov][:, sl]
        cur = bits[:, b, :ov][:, sl]
        live = (lo + np.arange(ov)[sl])[None, :] < live_hi
        mism = mism | jnp.any((prev != cur) & live, axis=-1)
    return out, (~mism).reshape(batch_shape)


def conv_decode_bytes(soft: jnp.ndarray, nbits: int) -> jnp.ndarray:
    """Decode and pack to bytes like the reference conv_decode.

    Returns (..., ceil(nbits/8)... ) - actually floor((nbits+7)/8) bytes with
    trailing partial-byte bits from the chainback register, matching
    viterbi_chainback's byte packing (MSB-first; the final partial byte is
    the low bits of the sliding register - callers only consume whole bytes
    of payload so exactness is preserved for them).
    """
    from ..utils.bits import bits_to_bytes

    bits = viterbi_decode(soft, nbits)
    pad = (-nbits) % 8
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros(bits.shape[:-1] + (pad,), jnp.int32)], axis=-1)
    return bits_to_bytes(bits)
