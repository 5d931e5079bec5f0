"""The GPU Viterbi path lowers for CUDA without a card.

`jit(f).trace(...).lower(lowering_platforms=("cuda",))` runs the Pallas
-> Triton lowering on the CPU, so a primitive the Triton route does not
support fails here rather than on the card. Shapes are chip_smoke.py's.
"""

import functools

import jax
import jax.numpy as jnp
import pytest

from fun_ofdm_tpu.ops import viterbi, viterbi_triton
from fun_ofdm_tpu.rates import ALL_RATES, Rate, params_for

_QAM16 = params_for(Rate.RATE_3_4_QAM16).num_data_bits(1500) - 6
_NBITS = sorted(params_for(r).num_data_bits(1500) - 6 for r in ALL_RATES)


def _lower(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.int32) for s in shapes]
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in text, "no Triton kernel in the lowered module"
    return text


@pytest.fixture
def on_gpu(monkeypatch):
    """Make the platform decision see a GPU (lowering only: nothing runs)."""
    from fun_ofdm_tpu.utils import platform

    monkeypatch.setattr(platform, "default_platform", lambda: "gpu")


@pytest.mark.parametrize("batch,nbits", [
    (1, _QAM16), (4, _QAM16), (16, _QAM16), (64, _QAM16), (512, _QAM16),
    (16, _NBITS[0]), (16, _NBITS[-1]), (2, 3600)])
def test_kernel_lowers_for_cuda(batch, nbits):
    _lower(functools.partial(viterbi_triton.viterbi_decode_triton,
                             nbits=nbits), (batch, 2 * (nbits + 6)))


def test_kernel_lowers_under_nested_vmap():
    nbits = 1200
    fn = jax.vmap(jax.vmap(functools.partial(
        viterbi_triton.viterbi_decode_triton, nbits=nbits)))
    text = _lower(fn, (3, 5, 2 * (nbits + 6)))
    # the batch collapses into one kernel launch per pass, not a grid
    # dimension per vmap level
    assert text.count("viterbi_acs") >= 1


def test_kernel_lowers_for_ragged_batch_and_dynamic_lengths():
    nbits = 700

    def fn(soft, nb):
        return viterbi_triton.viterbi_decode_triton(
            soft, nbits, nbits_dynamic=nb)

    _lower(fn, (33, 2 * (nbits + 6)), (33,))


def test_blocked_decode_lowers_for_cuda(on_gpu):
    nbits = _QAM16
    fn = functools.partial(viterbi.viterbi_decode, nbits=nbits,
                           impl="blocked", return_exact=True)
    _lower(fn, (4, 2 * (nbits + 6)))


def test_chain_decode_lowers_for_cuda(on_gpu):
    """A streaming chain's payload pass (universal decoder, blocked
    Viterbi bucket) lowers for CUDA as one program."""
    from fun_ofdm_tpu.runtime import chain

    build = chain._build_decode_anyrate_fn
    try:
        fn = build((Rate.RATE_1_2_QPSK, Rate.RATE_3_4_QAM16), 4, 200,
                   False, "auto")
        text = jax.jit(fn).trace(
            jax.ShapeDtypeStruct((20000,), jnp.float32),
            jax.ShapeDtypeStruct((20000,), jnp.float32),
            jax.ShapeDtypeStruct((4,), jnp.int32)).lower(
            lowering_platforms=("cuda",)).as_text()
    finally:
        build.cache_clear()    # the cached entry resolved "auto" for a GPU
    assert "triton" in text
