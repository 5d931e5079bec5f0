"""End-to-end TX -> frame-synchronous RX loopback (the test_sim oracle).

The reference's only hardware-free verification is examples/test_sim.cpp: a
digital loopback where the decoded payload must match bit for bit. Here the
same contract is enforced per-rate, batched, plus cross-checks of the TX
samples against the serial golden model.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import golden_model as gm
from fun_ofdm_tpu.models import rx, tx
from fun_ofdm_tpu.rates import Rate, params_for

TEAPOT = (b"I'm a little tea pot, short and stout....."
          b"here is my handle.....blah blah blah.....this rhyme sucks!")


def _payload(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=length, dtype=np.uint8)


@pytest.mark.parametrize("rate", list(Rate))
def test_tx_matches_golden_model(rate):
    payload = _payload(100)
    ours = np.asarray(tx.build_frame(jnp.asarray(payload), rate,
                                     dtype=jnp.complex128))
    want = gm.build_frame(payload, int(rate))
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, atol=1e-9)


@pytest.mark.parametrize("rate", list(Rate))
def test_loopback_all_rates(rate):
    payload = _payload(120, seed=int(rate))
    frame = tx.build_frame(jnp.asarray(payload), rate, dtype=jnp.complex128)
    # embed with leading/trailing zeros like the sim stream
    stream = jnp.concatenate([
        jnp.zeros(57, frame.dtype), frame, jnp.zeros(200, frame.dtype)])
    out = rx.decode_frame(stream, rate, len(payload), start=57)
    assert bool(out["header_ok"])
    assert int(out["rate_field"]) == params_for(rate).rate_field
    assert int(out["hdr_length"]) == len(payload)
    assert bool(out["crc_ok"])
    np.testing.assert_array_equal(np.asarray(out["payload"]), payload)
    assert int(out["service"]) == 0


def test_loopback_teapot_1500B():
    """The test_sim configuration: 1500-byte payload at RATE_3_4_QAM16."""
    payload = np.frombuffer(TEAPOT * 15, dtype=np.uint8).copy()
    assert len(payload) == 1500
    rate = Rate.RATE_3_4_QAM16
    frame = tx.build_frame(jnp.asarray(payload), rate, dtype=jnp.complex128)
    assert frame.shape == (params_for(rate).frame_samples(1500),)
    out = rx.decode_frame(frame, rate, 1500, start=0)
    assert bool(out["crc_ok"]) and bool(out["header_ok"])
    np.testing.assert_array_equal(np.asarray(out["payload"]), payload)


def test_loopback_batched():
    rate = Rate.RATE_1_2_QPSK
    payloads = np.stack([_payload(64, seed=s) for s in range(4)])
    frames = tx.build_frame(jnp.asarray(payloads), rate, dtype=jnp.complex128)
    out = rx.decode_frame(frames, rate, 64, start=0)
    assert np.asarray(out["crc_ok"]).all()
    np.testing.assert_array_equal(np.asarray(out["payload"]), payloads)


def test_loopback_complex64():
    """The device path (f32) must still decode cleanly."""
    rate = Rate.RATE_3_4_QAM64
    payload = _payload(500, seed=7)
    frame = tx.build_frame(jnp.asarray(payload), rate, dtype=jnp.complex64)
    out = rx.decode_frame(frame, rate, 500, start=0)
    assert bool(out["crc_ok"])
    np.testing.assert_array_equal(np.asarray(out["payload"]), payload)
