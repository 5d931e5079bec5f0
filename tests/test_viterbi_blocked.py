"""The block-overlap decode (ops/viterbi.viterbi_decode_blocked) around
the scan, the per-lane decoders it is built from, and the scan's unroll.

The wrapper is plain JAX around an exact lane decoder; these tests run it
around the scan (the CPU's exact decoder). test_viterbi_pallas.py runs it
around the Triton kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fun_ofdm_tpu.ops import convcode, viterbi, viterbi_triton


def _coded(rng, batch, nbits, noise, lens=None):
    bits = rng.integers(0, 2, size=(batch, nbits + 6))
    if lens is not None:
        for i, ln in enumerate(lens):
            bits[i, ln:] = 0
    coded = np.asarray(convcode.conv_encode(jnp.asarray(bits)))
    return jnp.asarray(np.clip(
        coded * 255 + rng.integers(-noise, noise + 1, coded.shape), 0, 255))


@pytest.mark.parametrize("noise", [0, 60])
def test_blocked_scan_matches_scan(noise):
    rng = np.random.default_rng(noise)
    nbits = 1500
    s = _coded(rng, 3, nbits, noise)
    ref = np.asarray(viterbi.viterbi_decode_scan(s, nbits))
    got, ok = viterbi.viterbi_decode_blocked(
        s, nbits, n_blocks=5, warmup=96, impl="scan", return_merge_ok=True)
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert np.asarray(ok).all()


def test_blocked_scan_merge_guard_flags_every_mismatch():
    rng = np.random.default_rng(5)
    nbits = 1200
    s = _coded(rng, 8, nbits, 127)
    ref = np.asarray(viterbi.viterbi_decode_scan(s, nbits))
    got, ok = viterbi.viterbi_decode_blocked(
        s, nbits, n_blocks=8, warmup=2, impl="scan", return_merge_ok=True)
    differs = (np.asarray(got) != ref).any(axis=-1)
    assert differs.any(), "test vector failed to force any mismatch"
    assert not (differs & np.asarray(ok)).any(), "silent splice failure"


def test_blocked_scan_dynamic_lengths():
    rng = np.random.default_rng(8)
    nbits = 900
    lens = np.asarray([900, 433, 250])
    s = _coded(rng, 3, nbits, 50, lens)
    nb = jnp.asarray(lens)
    ref = np.asarray(viterbi.viterbi_decode_scan(s, nbits, nbits_dynamic=nb))
    got = np.asarray(viterbi.viterbi_decode_blocked(
        s, nbits, n_blocks=4, warmup=96, impl="scan", nbits_dynamic=nb))
    for i, ln in enumerate(lens):
        np.testing.assert_array_equal(ref[i, :ln], got[i, :ln])


def test_blocked_scan_under_vmap():
    """The chain vmaps the decode over frames; the wrapper's static
    splice indices must survive it."""
    rng = np.random.default_rng(9)
    nbits = 800
    s = _coded(rng, 4, nbits, 40)
    ref = np.asarray(viterbi.viterbi_decode_scan(s, nbits))
    fn = jax.vmap(lambda x: viterbi.viterbi_decode_blocked(
        x, nbits, n_blocks=3, warmup=64, impl="scan"))
    np.testing.assert_array_equal(np.asarray(fn(s)), ref)


def test_blocked_is_a_dispatcher_impl():
    """viterbi_decode(impl='blocked') runs the blocked decode around the
    platform's exact decoder (the scan here) and returns its flag."""
    rng = np.random.default_rng(10)
    nbits = 600
    s = _coded(rng, 2, nbits, 30)
    bits, ok = viterbi.viterbi_decode(s, nbits, impl="blocked",
                                      return_exact=True)
    np.testing.assert_array_equal(
        np.asarray(bits), np.asarray(viterbi.viterbi_decode_scan(s, nbits)))
    assert np.asarray(ok).shape == (2,)


@pytest.mark.parametrize("unroll", [4, 16])
def test_scan_unroll_is_exact(unroll):
    rng = np.random.default_rng(unroll)
    nbits = 301
    s = _coded(rng, 2, nbits, 90)
    np.testing.assert_array_equal(
        np.asarray(viterbi.viterbi_decode_scan(s, nbits, unroll=unroll)),
        np.asarray(viterbi.viterbi_decode_scan(s, nbits)))


def test_lane_decoders_agree_on_uniform_init():
    """decode_lanes' per-lane init and step counts mean the same for the
    scan and the kernel (interpret mode): lanes starting mid-trellis with
    uniform metrics, lanes cut short, and zero bits past each lane's end."""
    rng = np.random.default_rng(11)
    nbits = 200
    s = _coded(rng, 4, nbits, 70)
    steps = jnp.asarray([206, 120, 206, 0], jnp.int32)
    init = jnp.asarray([1, 0, 0, 1], jnp.int32)
    ref = np.asarray(viterbi.decode_lanes(s, steps, init, nbits, "scan"))
    got = np.asarray(viterbi_triton.decode(s, steps, init, nbits,
                                           interpret=True))
    np.testing.assert_array_equal(got, ref)
    assert not ref[3].any() and not ref[1, 120 - 6:].any()
