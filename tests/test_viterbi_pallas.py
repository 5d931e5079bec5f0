"""Pallas (Triton route) Viterbi kernel: bit-exactness vs the lax.scan
trellis.

Runs the kernel in interpreter mode (tests run on CPU; the compiled path
is checked bit-exact on the GPU by chip_smoke.py, and
test_viterbi_lowering.py lowers it for CUDA here). The scan path is itself
validated bit-exactly against the compiled reference decoder in
test_golden_reference.py, so transitivity gives kernel == reference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fun_ofdm_tpu.ops import convcode, viterbi, viterbi_triton


def _noisy_soft(rng, batch, nbits):
    bits = rng.integers(0, 2, size=batch + (nbits + 6,))
    coded = np.asarray(convcode.conv_encode(jnp.asarray(bits)))
    return np.clip(coded * 255 + rng.integers(-120, 120, coded.shape), 0, 255)


@pytest.mark.parametrize("nbits", [18, 100, 337, 811])
def test_pallas_matches_scan(nbits):
    rng = np.random.default_rng(nbits)
    soft = jnp.asarray(_noisy_soft(rng, (3,), nbits))
    ref = np.asarray(viterbi.viterbi_decode_scan(soft, nbits))
    got = np.asarray(
        viterbi_triton.viterbi_decode_triton(soft, nbits, interpret=True))
    np.testing.assert_array_equal(ref, got)


def test_pallas_erasure_and_extremes():
    # all-erasure (127/128 midpoints) and hard 0/255 inputs
    rng = np.random.default_rng(7)
    nbits = 90
    soft_h = _noisy_soft(rng, (2,), nbits)
    soft_e = np.full_like(soft_h, 127)
    for soft in (soft_h, soft_e):
        s = jnp.asarray(soft)
        ref = np.asarray(viterbi.viterbi_decode_scan(s, nbits))
        got = np.asarray(
            viterbi_triton.viterbi_decode_triton(s, nbits, interpret=True))
        np.testing.assert_array_equal(ref, got)


def test_pallas_custom_vmap_collapses_batch():
    """Nested vmaps must flatten into the kernel batch, stay exact."""
    rng = np.random.default_rng(3)
    nbits = 130
    soft = jnp.asarray(_noisy_soft(rng, (2, 3), nbits))

    ref = np.asarray(viterbi.viterbi_decode_scan(soft, nbits))
    fn = jax.vmap(jax.vmap(
        lambda s: viterbi_triton.viterbi_decode_triton(
            s, nbits, interpret=True)))
    got = np.asarray(fn(soft))
    np.testing.assert_array_equal(ref, got)


def test_dispatcher_selects_scan_on_cpu():
    from fun_ofdm_tpu.utils import platform

    assert platform.exact_viterbi() == "scan"
    rng = np.random.default_rng(5)
    soft = jnp.asarray(_noisy_soft(rng, (1,), 100))
    np.testing.assert_array_equal(
        np.asarray(viterbi.viterbi_decode(soft, 100)),
        np.asarray(viterbi.viterbi_decode_scan(soft, 100)))


@pytest.mark.parametrize("nbits,n_blocks", [(700, 4), (1200, 8)])
def test_blocked_matches_scan_clean_and_noisy(nbits, n_blocks):
    """Block-overlap decode == sequential decode on clean and moderately
    noisy frames (survivor merge within the warmup overlap)."""
    rng = np.random.default_rng(nbits)
    bits = rng.integers(0, 2, size=(2, nbits + 6))
    coded = np.asarray(convcode.conv_encode(jnp.asarray(bits)))
    for noise in (0, 60):
        soft = np.clip(coded * 255
                       + rng.integers(-noise, noise + 1, coded.shape),
                       0, 255)
        s = jnp.asarray(soft)
        ref = np.asarray(viterbi.viterbi_decode_scan(s, nbits))
        got = np.asarray(viterbi.viterbi_decode_blocked(
            s, nbits, n_blocks=n_blocks, warmup=96, impl="triton",
            interpret=True))
        np.testing.assert_array_equal(ref, got)


def test_blocked_merge_guard_flags_every_mismatch():
    """The merge guard's contract: any frame whose blocked decode differs
    from the sequential decode MUST carry merge_ok=False (no silent
    splice failure). Forced failures via a pathologically short warmup
    on heavy noise; with the production warmup the same frames decode
    exactly and report merge_ok=True."""
    rng = np.random.default_rng(99)
    nbits = 1200
    bits = rng.integers(0, 2, size=(8, nbits + 6))
    coded = np.asarray(convcode.conv_encode(jnp.asarray(bits)))
    # near-erasure noise: soft values pulled hard toward the midpoint so
    # a 2-step overlap cannot merge survivors reliably
    soft = np.clip(coded * 255 + rng.integers(-127, 128, coded.shape),
                   0, 255)
    s = jnp.asarray(soft)
    ref = np.asarray(viterbi.viterbi_decode_scan(s, nbits))
    got, ok = viterbi.viterbi_decode_blocked(
        s, nbits, n_blocks=8, warmup=2, impl="triton", interpret=True,
        return_merge_ok=True)
    got, ok = np.asarray(got), np.asarray(ok)
    differs = (got != ref).any(axis=-1)
    # the guard must catch every differing frame (it may over-flag):
    # a frame that differs yet reports merge_ok would be a silent failure
    assert not (differs & ok).any(), "silent splice failure"
    assert differs.any(), "test vector failed to force any mismatch"

    # production warmup at working-SNR noise: exact and unflagged (the
    # near-erasure vector above keeps over-flagging at any warmup, which
    # is the guard being conservative where merges genuinely don't settle)
    soft2 = np.clip(coded * 255 + rng.integers(-60, 61, coded.shape), 0, 255)
    s2 = jnp.asarray(soft2)
    ref2 = np.asarray(viterbi.viterbi_decode_scan(s2, nbits))
    got2, ok2 = viterbi.viterbi_decode_blocked(
        s2, nbits, n_blocks=8, warmup=96, impl="triton", interpret=True,
        return_merge_ok=True)
    np.testing.assert_array_equal(np.asarray(got2), ref2)
    assert np.asarray(ok2).all()


def test_blocked_dynamic_lengths():
    """Per-frame dynamic bit counts: frames shorter than the static bound
    decode exactly (their final block chains back from the true frame
    end, not the window end)."""
    rng = np.random.default_rng(42)
    nbits = 900
    lens = np.asarray([900, 520, 244])
    bits = rng.integers(0, 2, size=(3, nbits + 6))
    # zero the tail beyond each frame's length so conv encoding matches a
    # genuinely shorter frame followed by flush zeros
    for i, ln in enumerate(lens):
        bits[i, ln:] = 0
    coded = np.asarray(convcode.conv_encode(jnp.asarray(bits)))
    soft = np.clip(coded * 255 + rng.integers(-50, 51, coded.shape), 0, 255)
    s = jnp.asarray(soft)
    ref = np.asarray(viterbi.viterbi_decode_scan(
        s, nbits, nbits_dynamic=jnp.asarray(lens)))
    got = np.asarray(viterbi.viterbi_decode_blocked(
        s, nbits, n_blocks=6, warmup=96, impl="triton", interpret=True,
        nbits_dynamic=jnp.asarray(lens)))
    for i, ln in enumerate(lens):
        np.testing.assert_array_equal(ref[i, :ln], got[i, :ln])
