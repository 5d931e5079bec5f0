"""IEEE CRC-32 as a jittable, batched block scan.

The reference uses boost::crc_32_type (poly 0x04C11DB7 reflected, init/final
0xFFFFFFFF - identical to zlib.crc32) over [service|payload] and appends the
checksum little-endian (reference: src/ppdu.cpp:134-137, 266-279).

A byte-serial CRC is a terrible fit for an accelerator (one tiny gather
per scan step), so we exploit GF(2) linearity: the state update for one byte,
``s' = T[(s ^ b) & 0xFF] ^ (s >> 8)``, is affine in (s, b). We precompute,
for a block of W bytes, per-position tables ``BLK[j][b] = L^(8*(W-1-j))(c(b))``
plus shift tables for the state, turning the whole CRC into a
``ceil(n/W)``-step lax.scan whose steps are W independent 256-entry gathers -
fully vectorized over the batch dimension.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_POLY = 0xEDB88320  # reflected 0x04C11DB7
#: the bit-matrix products have 0/1 operands and integer sums < 2^24, so
#: they are exact at any matmul precision (TF32 and bf16 hold 0 and 1
#: exactly and accumulate in f32); the cheapest one is asked for
_PRECISION = jax.lax.Precision.DEFAULT
BLOCK = 32  # bytes folded per scan step


@functools.lru_cache(maxsize=None)
def _byte_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        c = np.uint32(b)
        for _ in range(8):
            c = np.uint32((c >> np.uint32(1)) ^ (_POLY * (c & np.uint32(1))))
        t[b] = c
    return t


def _crc_serial_u32(data: np.ndarray) -> int:
    t = _byte_table()
    crc = np.uint32(0xFFFFFFFF)
    for b in np.asarray(data, np.uint8):
        crc = np.uint32(t[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8)))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def crc32_np(data: np.ndarray) -> int:
    """Host-side serial CRC-32 (zlib-compatible); reference for tests."""
    return _crc_serial_u32(data)


@functools.lru_cache(maxsize=None)
def _shift8_matrix() -> np.ndarray:
    """32x32 GF(2) matrix of s -> crc-shift of state by one zero byte."""
    # column i = update of basis state (1<<i) with byte 0
    t = _byte_table()
    cols = []
    for i in range(32):
        s = np.uint32(1 << i)
        s2 = np.uint32(t[s & np.uint32(0xFF)] ^ (s >> np.uint32(8)))
        cols.append(int(s2))
    return np.array(cols, dtype=np.uint64)  # cols[i] = L(e_i)


def _apply_cols(cols: np.ndarray, x: int) -> int:
    y = 0
    for i in range(32):
        if (x >> i) & 1:
            y ^= int(cols[i])
    return y


@functools.lru_cache(maxsize=None)
def _block_tables(block: int = BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """(state_tables, byte_tables) for folding `block` bytes at once.

    state_tables: (4, 256) uint32 - L^(8*block) applied to a state, indexed
                  by each of the state's 4 bytes.
    byte_tables:  (block, 256) uint32 - contribution of byte j of the block.
    """
    cols = _shift8_matrix()
    # cols_k[i] = L^k(e_i)
    cols_k = np.zeros((block + 1, 32), dtype=np.uint64)
    cols_k[0] = [1 << i for i in range(32)]
    for k in range(1, block + 1):
        cols_k[k] = [_apply_cols(cols, int(cols_k[k - 1][i])) for i in range(32)]

    t = _byte_table()
    byte_tables = np.zeros((block, 256), dtype=np.uint32)
    for j in range(block):
        shift = block - 1 - j
        for b in range(256):
            # c(b): state contribution of byte b entering a zero state
            c = np.uint32(t[b])
            byte_tables[j, b] = _apply_cols(cols_k[shift], int(c))

    state_tables = np.zeros((4, 256), dtype=np.uint32)
    for byte_pos in range(4):
        for b in range(256):
            x = b << (8 * byte_pos)
            state_tables[byte_pos, b] = _apply_cols(cols_k[block], x)
    return state_tables, byte_tables


@functools.lru_cache(maxsize=None)
def _bit_matrix(n: int) -> np.ndarray:
    """(8n, 32) float 0/1: row 8j+i = L^(8(n-1-j))(T[1<<i]) bit-expanded.

    CRC-32 is GF(2)-linear in the message bits, so the whole checksum is
    one 0/1 matmul mod 2 instead of a byte-serial gather scan.
    Bit i here is the i-th LSB of byte j.
    """
    cols = _shift8_matrix()
    t = _byte_table()
    w = np.zeros((8 * n, 32), dtype=np.float32)
    # c_j = L^(8(n-1-j)) applied to T[1<<i]; build from the last byte back
    cur = np.array([int(t[1 << i]) for i in range(8)], dtype=np.uint64)
    for j in range(n - 1, -1, -1):
        for i in range(8):
            w[8 * j + i, :] = [(int(cur[i]) >> k) & 1 for k in range(32)]
        if j:
            cur = np.array([_apply_cols(cols, int(c)) for c in cur],
                           dtype=np.uint64)
    return w


def crc32(data: jnp.ndarray) -> jnp.ndarray:
    """Batched CRC-32. data: (..., n) int32/uint8 bytes -> (...,) uint32.

    n is static. One (batch, 8n) x (8n, 32) 0/1 matmul mod 2 (exact in f32
    for n < 2M bits), plus the init/final-xor constants folded in at trace
    time. Matches zlib.crc32 / boost::crc_32_type (reference:
    src/ppdu.cpp:134-137).
    """
    data = jnp.asarray(data, jnp.int32)
    n = data.shape[-1]
    batch_shape = data.shape[:-1]

    # bits (..., 8n), bit i = i-th LSB of byte j at column 8j+i
    bits = jnp.stack([(data >> i) & 1 for i in range(8)], axis=-1)
    bits = bits.reshape(batch_shape + (8 * n,)).astype(jnp.float32)

    w = jnp.asarray(_bit_matrix(n))
    acc = jnp.dot(bits, w, precision=_PRECISION,
                  preferred_element_type=jnp.float32)
    state_bits = jnp.mod(acc, 2.0).astype(jnp.uint32)  # (..., 32)

    weights = jnp.asarray(
        np.array([1 << k for k in range(32)], dtype=np.uint32))
    state = jnp.sum(state_bits * weights, axis=-1, dtype=jnp.uint32)

    # init-state contribution: L^(8n)(0xFFFFFFFF), a trace-time constant
    t = _byte_table()
    init_contrib = np.uint32(0xFFFFFFFF)
    for _ in range(n):
        init_contrib = np.uint32(
            t[init_contrib & np.uint32(0xFF)] ^ (init_contrib >> np.uint32(8)))
    return state ^ jnp.uint32(init_contrib) ^ jnp.uint32(0xFFFFFFFF)


@functools.lru_cache(maxsize=None)
def _init_contrib_table(n_max: int) -> np.ndarray:
    """(n_max+1,) uint32: L^(8n)(0xFFFFFFFF) for n = 0..n_max."""
    t = _byte_table()
    out = np.zeros(n_max + 1, np.uint32)
    cur = np.uint32(0xFFFFFFFF)
    out[0] = cur
    for n in range(1, n_max + 1):
        cur = np.uint32(t[cur & np.uint32(0xFF)] ^ (cur >> np.uint32(8)))
        out[n] = cur
    return out


def crc32_dynamic(data: jnp.ndarray, n_valid: jnp.ndarray) -> jnp.ndarray:
    """CRC-32 of the first n_valid bytes of each row.

    data: (..., n_max) int bytes; n_valid: (...,) traced lengths <= n_max.
    Right-aligns each message into the static buffer (leading zero bytes
    from a zero state stay at zero state, so the same (8*n_max, 32) bit
    matrix applies) and folds in the length-dependent init contribution
    from a precomputed table.
    """
    data = jnp.asarray(data, jnp.int32)
    n_max = data.shape[-1]
    n_valid = jnp.broadcast_to(jnp.asarray(n_valid, jnp.int32),
                               data.shape[:-1])

    # right-align: out[..., p] = data[..., p - (n_max - n_valid)] or 0
    idx = jnp.arange(n_max, dtype=jnp.int32)
    src = idx[None] - (n_max - n_valid)[..., None]
    shifted = jnp.take_along_axis(
        data.reshape(-1, n_max), jnp.clip(src.reshape(-1, n_max), 0, n_max - 1),
        axis=-1).reshape(data.shape)
    shifted = jnp.where(src >= 0, shifted, 0)

    bits = jnp.stack([(shifted >> i) & 1 for i in range(8)], axis=-1)
    bits = bits.reshape(data.shape[:-1] + (8 * n_max,)).astype(jnp.float32)
    w = jnp.asarray(_bit_matrix(n_max))
    state_bits = jnp.mod(
        jnp.dot(bits, w, precision=_PRECISION,
                preferred_element_type=jnp.float32), 2.0
    ).astype(jnp.uint32)
    weights = jnp.asarray(
        np.array([1 << k for k in range(32)], dtype=np.uint32))
    state = jnp.sum(state_bits * weights, axis=-1, dtype=jnp.uint32)

    init_tbl = jnp.asarray(_init_contrib_table(n_max))
    return state ^ init_tbl[n_valid] ^ jnp.uint32(0xFFFFFFFF)


def crc32_scan(data: jnp.ndarray) -> jnp.ndarray:
    """Batched CRC-32 as a block scan (portable baseline; same contract)."""
    data = jnp.asarray(data)
    n = data.shape[-1]
    batch_shape = data.shape[:-1]
    pad = (-n) % BLOCK
    nblocks = (n + pad) // BLOCK

    state_t_np, byte_t_np = _block_tables(BLOCK)
    state_t = jnp.asarray(state_t_np)
    byte_t = jnp.asarray(byte_t_np)

    # GF(2) linearity: state(M, init) = state(M, 0) XOR L^n(init), and
    # leading zero bytes leave a zero state at zero. So we zero-pad at the
    # FRONT, scan from state 0, and fold in the init contribution
    # L^(8n)(0xFFFFFFFF) as a trace-time numpy constant.
    t = _byte_table()
    init_contrib = np.uint32(0xFFFFFFFF)
    for _ in range(n):
        init_contrib = np.uint32(
            t[init_contrib & np.uint32(0xFF)] ^ (init_contrib >> np.uint32(8)))
    init_state = jnp.zeros(batch_shape, dtype=jnp.uint32)

    padded = jnp.concatenate(
        [jnp.zeros(batch_shape + (pad,), dtype=jnp.uint8),
         data.astype(jnp.uint8)], axis=-1)
    blocks = padded.reshape(batch_shape + (nblocks, BLOCK))
    blocks = jnp.moveaxis(blocks, -2, 0)  # (nblocks, ..., BLOCK)

    def step(state, blk):
        # advance state by BLOCK zero bytes via its 4 bytes
        new = (
            state_t[0, (state & 0xFF).astype(jnp.int32)]
            ^ state_t[1, ((state >> 8) & 0xFF).astype(jnp.int32)]
            ^ state_t[2, ((state >> 16) & 0xFF).astype(jnp.int32)]
            ^ state_t[3, ((state >> 24) & 0xFF).astype(jnp.int32)]
        )
        contrib = byte_t[0, blk[..., 0].astype(jnp.int32)]
        for j in range(1, BLOCK):
            contrib = contrib ^ byte_t[j, blk[..., j].astype(jnp.int32)]
        return new ^ contrib, None

    final, _ = jax.lax.scan(step, init_state, blocks)
    return final ^ jnp.uint32(init_contrib) ^ jnp.uint32(0xFFFFFFFF)
