"""Frame detection + capture receive: the test_sim contract.

The reference's sim pushes 100 identical frames + zero pad through the
full RX chain and must deliver 100 CRC-valid payloads. Same here, plus
detection-position checks against known frame placements.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fun_ofdm_tpu.models import frontend, tx
from fun_ofdm_tpu.rates import Rate, params_for


def _frame(payload, rate):
    return np.asarray(tx.build_frame(jnp.asarray(payload), rate,
                                     dtype=jnp.complex128))


def test_detect_single_frame():
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 256, 80, dtype=np.uint8)
    frame = _frame(payload, Rate.RATE_1_2_BPSK)
    stream = np.concatenate([np.zeros(500, np.complex128), frame,
                             np.zeros(900, np.complex128)])
    starts, valid = frontend.detect_frames(jnp.asarray(stream), 4)
    starts, valid = np.asarray(starts), np.asarray(valid)
    assert valid[0] and not valid[1:].any()
    assert starts[0] == 500


def test_detect_multiple_frames_positions():
    rng = np.random.default_rng(4)
    rate = Rate.RATE_3_4_QAM16
    payload = rng.integers(0, 256, 60, dtype=np.uint8)
    frame = _frame(payload, rate)
    gap = np.zeros(777, np.complex128)
    stream = np.concatenate([gap, frame, gap, frame, gap, frame, gap])
    starts, valid = frontend.detect_frames(jnp.asarray(stream), 6)
    starts, valid = np.asarray(starts), np.asarray(valid)
    want = [777, 777 * 2 + len(frame), 777 * 3 + 2 * len(frame)]
    assert list(starts[valid]) == want


def test_receive_capture_decodes_all():
    rng = np.random.default_rng(5)
    rate = Rate.RATE_2_3_QAM64
    payload = rng.integers(0, 256, 200, dtype=np.uint8)
    frame = _frame(payload, rate)
    pieces = [np.zeros(333, np.complex128)]
    for _ in range(5):
        pieces += [frame, np.zeros(421, np.complex128)]
    stream = np.concatenate(pieces)
    out = frontend.receive_capture(jnp.asarray(stream), rate, 200, 8)
    crc_ok = np.asarray(out["crc_ok"])
    assert crc_ok.sum() == 5
    for i in np.nonzero(crc_ok)[0]:
        np.testing.assert_array_equal(np.asarray(out["payload"])[i], payload)


def test_sim_loopback_100_frames():
    """examples/test_sim.cpp semantics: 100 back-to-back frames, all decoded.

    (Back-to-back: the next frame's STS follows the previous frame's last
    sample immediately, like the reference's concatenated stream.)
    """
    TEAPOT = (b"I'm a little tea pot, short and stout....."
              b"here is my handle.....blah blah blah.....this rhyme sucks!")
    payload = np.frombuffer(TEAPOT * 15, dtype=np.uint8).copy()
    rate = Rate.RATE_3_4_QAM16
    frame = _frame(payload, rate)
    stream = np.concatenate([np.tile(frame, 100),
                             np.zeros(len(frame), np.complex128)])
    out = frontend.receive_capture(jnp.asarray(stream, jnp.complex64),
                                   rate, 1500, 128)
    crc_ok = np.asarray(out["crc_ok"])
    assert crc_ok.sum() == 100, f"decoded {crc_ok.sum()}/100"
    dec = np.asarray(out["payload"])[crc_ok]
    assert (dec == payload[None, :]).all()


def test_first_k_true_blocked_matches_onehot():
    """The blocked two-level first-k (large k*n path) is exact vs the
    one-hot matmul form, including: sparse events, events in adjacent
    blocks, empty tails, and the k > count validity edge."""
    from fun_ofdm_tpu.models.frontend import (_first_k_true,
                                              _first_k_true_blocked)
    rng = np.random.default_rng(11)
    n = 1 << 16
    for density in (0, 5, 200):
        mask = np.zeros(n, bool)
        if density:
            mask[rng.choice(n, density, replace=False)] = True
        mask[:3] = True  # block-edge events
        for k in (4, 64, 300):
            got_p, got_v, dropped = _first_k_true_blocked(jnp.asarray(mask), k)
            # reference: plain numpy first-k
            want = np.flatnonzero(mask)[:k]
            got_p, got_v = np.asarray(got_p), np.asarray(got_v)
            assert got_v.sum() == want.size
            assert list(got_p[got_v]) == list(want)
            assert (got_p[~got_v] == n).all()
            assert int(dropped) == 0  # no block exceeds the cap here


def test_first_k_true_blocked_caps_dense_block():
    """>16 events inside one 512-sample block: the excess is dropped (the
    documented capacity) AND counted — the dropped total is what the chain
    surfaces as stats.detect_dropped (VERDICT r3 weak #5)."""
    from fun_ofdm_tpu.models.frontend import _first_k_true_blocked
    n = 4096
    mask = np.zeros(n, bool)
    mask[100:130] = True  # 30 events in one block, cap is 16
    mask[600:620] = True  # 20 events in the next block
    pos, valid, dropped = _first_k_true_blocked(jnp.asarray(mask), 64)
    pos, valid = np.asarray(pos), np.asarray(valid)
    kept = pos[pos < n]
    assert list(kept) == list(range(100, 116)) + list(range(600, 616))
    assert int(dropped) == (30 - 16) + (20 - 16)


def test_detect_dropped_reaches_chain_stats(monkeypatch):
    """End-to-end wiring of the device-side drop counter: shrink the
    blocked extractor's geometry so two real preamble events land in one
    block with cap 1; the chain must count the dropped event (the old
    behavior lost it silently — ADVICE r3 medium)."""
    from fun_ofdm_tpu.models import frontend as fe
    from fun_ofdm_tpu.config import ChainParams
    from fun_ofdm_tpu.runtime.chain import ReceiverChain
    from fun_ofdm_tpu.rates import Rate

    monkeypatch.setattr(fe, "_BLOCKED_MIN_N", 0)
    monkeypatch.setattr(fe, "_BLOCK", 4096)
    monkeypatch.setattr(fe, "_BLOCK_CAP", 1)

    rng = np.random.default_rng(21)
    payload = rng.integers(0, 256, 16, dtype=np.uint8)
    frame = _frame(payload, Rate.RATE_1_2_BPSK).astype(np.complex64)
    stream = np.zeros(12288, np.complex64)
    stream[100:100 + frame.size] = frame
    stream[100 + frame.size:100 + 2 * frame.size] = frame  # same block event

    # unique params so the lru-cached step fn re-traces under the patched
    # extractor geometry; capacity 2 <= nb*cap keeps the blocked path alive
    params = ChainParams(chunk_size=6144, strides_per_step=1,
                         max_frames_per_chunk=2)
    chain = ReceiverChain(rates=(Rate.RATE_1_2_BPSK,), max_length=16,
                          params=params)
    pkts = chain.process_samples(stream) + chain.flush()
    assert chain.stats.detect_dropped >= 1
    # the first frame survives the cap; the second event was dropped
    assert [p.start for p in pkts] == [100]


def test_anyrate_capture_reports_detect_dropped():
    """receive_capture_anyrate_p surfaces the blocked extractor's dropped
    event count instead of discarding it (ADVICE r4)."""
    import jax.numpy as jnp
    from fun_ofdm_tpu.models import frontend, tx as tx_model
    from fun_ofdm_tpu.rates import Rate

    payload = np.arange(30, dtype=np.uint8)
    f = np.asarray(tx_model.build_frame(jnp.asarray(payload),
                                        Rate.RATE_1_2_BPSK))
    stream = np.zeros(6000, np.complex64)
    stream[100:100 + f.size] = f
    out = frontend.receive_capture_anyrate_p(
        (jnp.asarray(stream.real), jnp.asarray(stream.imag)),
        (Rate.RATE_1_2_BPSK,), max_length=40, max_frames=4)
    assert int(out["detect_dropped"]) == 0
    assert int((out["crc_ok"]).sum()) == 1
