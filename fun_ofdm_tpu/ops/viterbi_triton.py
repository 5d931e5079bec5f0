"""Viterbi trellis (K=7, rate 1/2, 64 states) as a GPU kernel, through
Pallas's Triton route.

Bit-exact with ops/viterbi.viterbi_decode_scan, whose u8 semantics follow
the reference's SPIRAL SSE kernel (reference: src/viterbi.cpp:166-459).

Why a kernel: the trellis is sequential in time. Left to XLA it is a
while loop of one tiny step per trellis step (about 12k forward and 12k
chainback iterations for a 1500-byte frame). Here each pass is one launch
that loops over time inside the program, with the path metrics in
registers.

Layout: one thread owns one frame (TILE frames per program, one warp).
The 64 path metrics of a frame are 64 separate (TILE,) vectors, so the
butterfly (j, j+32) -> (2j, 2j+1) is a relabeling of which vector holds
which state, fixed at trace time: no lane moves data to another lane,
and the kernel needs no shuffle, shared memory or barrier. The four
distinct branch metrics of a step are computed once and shared by the 32
butterflies.

  * forward pass: per step, the 64 decision bits are packed into two
    uint32 words per frame (bit j of `even` = decision at state 2j, bit j
    of `odd` = decision at state 2j+1) and streamed out.
  * chainback pass: per step, one word per frame is selected by the
    state's low bit and shifted by the state's upper bits; no gather.

Both passes loop only to the tile's longest live trellis and prefetch the
next loop iteration's rows before computing the current ones.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .viterbi import K, NUMSTATES, _branch_bits, _cdiv

#: frames per program: one warp, one frame per thread
TILE = 32
#: trellis steps per forward loop iteration (steps are even)
FWD_UNROLL = 2
#: trellis steps per chainback loop iteration; the chainback's step is a
#: short dependent chain, so its loads are issued this many steps ahead
BACK_UNROLL = 16

_HALF = NUMSTATES // 2


def _fwd_kernel(steps_ref, init_ref, s0_ref, s1_ref, even_ref, odd_ref):
    """Forward add-compare-select over one tile of frames.

    steps_ref: (1, TILE) int32 per-frame even trellis-step counts.
    init_ref: (1, TILE) int32 - 1 = exact init (state 0 biased, the
        reference's frame start, viterbi.cpp:71-78); 0 = uniform init
        (a block-overlap window starting mid-trellis).
    s0_ref/s1_ref: (T, TILE) int32 soft pairs, time-major.
    even_ref/odd_ref: (T, TILE) uint32 packed decisions; rows at or past
        a frame's step count are zero, rows past the tile's longest
        trellis are not written.
    """
    t_rows = s0_ref.shape[0]
    steps = steps_ref[0, :]
    exact = init_ref[0, :] == 1
    bt0, bt1 = _branch_bits()
    codes = [int(bt0[j]) * 2 + int(bt1[j]) for j in range(_HALF)]
    bits = [jnp.uint32(1 << j) for j in range(_HALF)]
    zero_w = jnp.uint32(0)

    def or_tree(xs):
        while len(xs) > 1:
            xs = [xs[i] | xs[i + 1] if i + 1 < len(xs) else xs[i]
                  for i in range(0, len(xs), 2)]
        return xs[0]

    def min_tree(xs):
        while len(xs) > 1:
            xs = [jnp.minimum(xs[i], xs[i + 1]) if i + 1 < len(xs) else xs[i]
                  for i in range(0, len(xs), 2)]
        return xs[0]

    def step(m, s0, s1, t):
        # the four distinct branch metrics t = ((s0^E0)+(s1^E1)+1)>>3,
        # indexed by E0*2 + E1 (viterbi.cpp:242-251)
        p, q = s0 + s1, s0 - s1
        bm = [(p + 1) >> 3, (256 + q) >> 3, (256 - q) >> 3, (511 - p) >> 3]
        bmc = [63 - b for b in bm]
        new = [None] * NUMSTATES
        dec_e, dec_o = [], []
        for j in range(_HALF):
            tj, tcj = bm[codes[j]], bmc[codes[j]]
            lo, hi = m[j], m[j + _HALF]
            a_e = jnp.minimum(lo + tj, 255)
            b_e = jnp.minimum(hi + tcj, 255)
            a_o = jnp.minimum(lo + tcj, 255)
            b_o = jnp.minimum(hi + tj, 255)
            new[2 * j] = jnp.minimum(a_e, b_e)
            new[2 * j + 1] = jnp.minimum(a_o, b_o)
            # ties go to the high-half predecessor (viterbi.cpp:252-267)
            dec_e.append(jnp.where(b_e <= a_e, bits[j], zero_w))
            dec_o.append(jnp.where(b_o <= a_o, bits[j], zero_w))
        # renormalize when state 0 exceeds 210 (viterbi.cpp:314-332)
        sub = jnp.where(new[0] > 210, min_tree(new), 0)
        new = [x - sub for x in new]
        live = t < steps
        even_ref[t, :] = jnp.where(live, or_tree(dec_e), zero_w)
        odd_ref[t, :] = jnp.where(live, or_tree(dec_o), zero_w)
        return new

    def rows(i):
        out = []
        for k in range(FWD_UNROLL):
            r = jnp.minimum(i * FWD_UNROLL + k, t_rows - 1)
            out.append((s0_ref[r, :], s1_ref[r, :]))
        return out

    def body(i, carry):
        m, cur = carry
        nxt = rows(i + 1)                 # prefetch the next iteration
        for k, (s0, s1) in enumerate(cur):
            m = step(m, s0, s1, i * FWD_UNROLL + k)
        return m, nxt

    m0 = [jnp.where(exact, 0, 63)] + [jnp.full((TILE,), 63, jnp.int32)
                                      for _ in range(NUMSTATES - 1)]
    n_iter = _cdiv(jnp.max(steps), FWD_UNROLL)
    jax.lax.fori_loop(0, n_iter, body, (m0, rows(0)))


def _back_kernel(steps_ref, even_ref, odd_ref, out_ref):
    """Survivor chainback from state 0 at each frame's trellis end.

    out_ref: (T, TILE) int32 - the decision bit read at each step; rows
    past the tile's longest trellis are not written (the wrapper masks
    every row at or past a frame's step count).
    """
    steps = steps_ref[0, :]
    n_blk = _cdiv(jnp.max(steps), BACK_UNROLL)

    def rows(blk):
        out = []
        for k in range(BACK_UNROLL):
            r = jnp.maximum(blk * BACK_UNROLL + k, 0)
            out.append((even_ref[r, :], odd_ref[r, :]))
        return out

    def body(i, carry):
        state, cur = carry
        blk = n_blk - 1 - i
        nxt = rows(blk - 1)               # prefetch the next (older) block
        for k in range(BACK_UNROLL - 1, -1, -1):
            t = blk * BACK_UNROLL + k
            we, wo = cur[k]
            word = jnp.where((state & 1) == 1, wo, we)
            bit = ((word >> (state >> 1).astype(jnp.uint32)) & 1
                   ).astype(jnp.int32)
            bit = jnp.where(t < steps, bit, 0)
            out_ref[t, :] = bit
            state = (state >> 1) | (bit << 5)
        return state, nxt

    state0 = jnp.zeros((TILE,), jnp.int32)
    jax.lax.fori_loop(0, n_blk, body, (state0, rows(n_blk - 1)))


def _lanes(soft, steps_vec, init_vec, nbits: int):
    """Pad (B, 2*S) soft pairs to whole tiles: time-major (T, B) s0/s1
    rows and (1, B) step counts / init flags."""
    bsz = soft.shape[0]
    total = nbits + (K - 1)
    b_pad = _cdiv(max(bsz, 1), TILE) * TILE
    t_pad = _cdiv(total, BACK_UNROLL) * BACK_UNROLL
    pairs = jnp.zeros((b_pad, 2 * t_pad), jnp.int32)
    pairs = pairs.at[:bsz, : 2 * total].set(
        jnp.asarray(soft, jnp.int32)[:, : 2 * total])
    sv = jnp.zeros((1, b_pad), jnp.int32).at[0, :bsz].set(steps_vec)
    iv = jnp.zeros((1, b_pad), jnp.int32).at[0, :bsz].set(init_vec)
    return pairs[:, 0::2].T, pairs[:, 1::2].T, sv, iv


def _specs(t_pad: int):
    lane = pl.BlockSpec((1, TILE), lambda b: (0, b))
    rows = pl.BlockSpec((t_pad, TILE), lambda b: (0, b))
    return lane, rows, plgpu.CompilerParams(num_warps=1, num_stages=1)


def _forward(s0, s1, sv, iv, interpret: bool):
    t_pad, b_pad = s0.shape
    lane, rows, params = _specs(t_pad)
    return pl.pallas_call(
        _fwd_kernel, grid=(b_pad // TILE,),
        in_specs=[lane, lane, rows, rows],
        out_specs=[rows, rows],
        out_shape=[jax.ShapeDtypeStruct((t_pad, b_pad), jnp.uint32)] * 2,
        compiler_params=params, interpret=interpret,
        name="viterbi_acs",
    )(sv, iv, s0, s1)


def _chainback(sv, even, odd, interpret: bool):
    t_pad, b_pad = even.shape
    lane, rows, params = _specs(t_pad)
    return pl.pallas_call(
        _back_kernel, grid=(b_pad // TILE,),
        in_specs=[lane, rows, rows],
        out_specs=rows,
        out_shape=jax.ShapeDtypeStruct((t_pad, b_pad), jnp.int32),
        compiler_params=params, interpret=interpret,
        name="viterbi_chainback",
    )(sv, even, odd)


@functools.partial(jax.jit, static_argnames=("nbits", "interpret"))
def decode_lanes(soft: jnp.ndarray, steps_vec: jnp.ndarray,
                 init_vec: jnp.ndarray, nbits: int,
                 interpret: bool = False) -> jnp.ndarray:
    """Decode independent trellis lanes.

    soft: (B, 2*S) int soft pairs with S >= nbits + K - 1.
    steps_vec: (B,) int32 even trellis-step counts (<= S).
    init_vec: (B,) int32 - 1 = exact frame-start init, 0 = uniform.
    Returns (B, nbits) int32: the decision bit read at trellis step n + 6,
    zero where n + 6 is at or past the lane's step count.
    """
    s0, s1, sv, iv = _lanes(soft, steps_vec, init_vec, nbits)
    even, odd = _forward(s0, s1, sv, iv, interpret)
    ks = _chainback(sv, even, odd, interpret)
    # decoded bit n is the decision bit read at trellis step n + 6; rows
    # at or past a lane's step count were not (all) written
    t_idx = jnp.arange(K - 1, K - 1 + nbits, dtype=jnp.int32)[:, None]
    bits = jnp.where(t_idx < sv[0][None, :], ks[K - 1: K - 1 + nbits], 0)
    return bits[:, :soft.shape[0]].T


@functools.partial(jax.jit, static_argnames=("nbits",))
def forward_lanes(soft, steps_vec, init_vec, nbits: int):
    """The forward pass of decode_lanes alone: its packed (T, B) decision
    words (tools/viterbi_ab.py times it beside the whole decode)."""
    return _forward(*_lanes(soft, steps_vec, init_vec, nbits), False)


@functools.lru_cache(maxsize=None)
def _decoder(nbits: int, interpret: bool):
    """custom_vmap'd lane decoder: every vmap level (frames, channels,
    blocks) collapses into the kernel's flat frame axis instead of going
    through Pallas's default rule, which would add grid dimensions of
    mostly empty tiles."""
    @jax.custom_batching.custom_vmap
    def f(soft, steps_vec, init_vec):
        bits = decode_lanes(soft.reshape(-1, soft.shape[-1]),
                            steps_vec.reshape(-1), init_vec.reshape(-1),
                            nbits, interpret=interpret)
        return bits.reshape(*soft.shape[:-1], nbits)

    @f.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a[None], (axis_size,) + a.shape)
                for a, b in zip(args, in_batched)]
        return f(*args), True

    return f


def decode(soft: jnp.ndarray, steps_vec: jnp.ndarray, init_vec: jnp.ndarray,
           nbits: int, interpret: bool = False) -> jnp.ndarray:
    """decode_lanes over any leading batch shape: soft (..., 2*S),
    steps_vec/init_vec (...,) -> (..., nbits)."""
    soft = jnp.asarray(soft, jnp.int32)
    shape = soft.shape[:-1]
    return _decoder(nbits, interpret)(
        soft, jnp.broadcast_to(jnp.asarray(steps_vec, jnp.int32), shape),
        jnp.broadcast_to(jnp.asarray(init_vec, jnp.int32), shape))


def viterbi_decode_triton(soft: jnp.ndarray, nbits: int,
                          nbits_dynamic: jnp.ndarray | None = None,
                          interpret: bool = False) -> jnp.ndarray:
    """Drop-in kernel version of ops.viterbi.viterbi_decode_scan.

    soft: (..., 2*(nbits+6)) int soft coded bits (0..255; >=128 leans 1).
    nbits: number of data bits to output (static upper bound).
    nbits_dynamic: optional traced (...,) per-element bit counts <= nbits.
    interpret: run the kernel in the Pallas interpreter (CPU tests).
    Returns (..., nbits) int32 decoded bits, bit-exact with the scan.
    """
    soft = jnp.asarray(soft, jnp.int32)
    if nbits_dynamic is None:
        nb = jnp.full(soft.shape[:-1], nbits, jnp.int32)
    else:
        nb = jnp.broadcast_to(jnp.asarray(nbits_dynamic, jnp.int32),
                              soft.shape[:-1])
    steps_vec = ((nb + (K - 1)) // 2) * 2   # reference drops an odd step
    return decode(soft, steps_vec, 1, nbits, interpret=interpret)
