"""Header-driven dynamic-rate/length receive.

The reference receiver learns each frame's (rate, length) from its SIGNAL
header at runtime (src/frame_decoder.cpp:72-88); these tests cover the
JAX equivalent: per-frame dynamic lengths via masked Viterbi
trellises, right-aligned dynamic CRC, and the full detect -> header ->
payload path. Dynamic decodes must be bit-identical to the static decode
specialized at each frame's true length.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fun_ofdm_tpu import Rate
from fun_ofdm_tpu.models import frontend, ppdu, rx, tx
from fun_ofdm_tpu.ops import convcode, crc32, viterbi, viterbi_triton
from fun_ofdm_tpu.rates import params_for


def test_crc32_dynamic_matches_zlib():
    rng = np.random.default_rng(0)
    n_max = 96
    data = rng.integers(0, 256, (6, n_max), dtype=np.uint8)
    n_valid = np.array([1, 5, 40, 96, 96, 17], np.int32)
    got = np.asarray(jax.jit(crc32.crc32_dynamic)(
        jnp.asarray(data), jnp.asarray(n_valid)))
    want = np.array([zlib.crc32(bytes(d[:n])) for d, n in zip(data, n_valid)],
                    np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_viterbi_dynamic_matches_per_length_static(impl):
    """Masked trellis == per-element static decode at each length."""
    rng = np.random.default_rng(1)
    nbits_max = 120
    lengths = np.array([120, 37, 80, 5], np.int32)
    bits = rng.integers(0, 2, size=(4, nbits_max + 6))
    coded = np.asarray(convcode.conv_encode(jnp.asarray(bits)))
    soft = np.clip(coded * 255 + rng.integers(-120, 120, coded.shape), 0, 255)
    soft_j = jnp.asarray(soft)

    if impl == "pallas":
        got = np.asarray(viterbi_triton.viterbi_decode_triton(
            soft_j, nbits_max, interpret=True,
            nbits_dynamic=jnp.asarray(lengths)))
    else:
        got = np.asarray(viterbi.viterbi_decode_scan(
            soft_j, nbits_max, nbits_dynamic=jnp.asarray(lengths)))

    for i, nb in enumerate(lengths):
        # static decode of the same row truncated to its real trellis
        want = np.asarray(viterbi.viterbi_decode_scan(
            soft_j[i, : 2 * (nb + 6)], int(nb)))
        np.testing.assert_array_equal(got[i, :nb], want, err_msg=f"row {i}")


@pytest.mark.parametrize("rate", [Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16])
def test_decode_data_dynamic_matches_static(rate):
    """Dynamic decode == static decode specialized per length."""
    rng = np.random.default_rng(2)
    max_len = 64
    rp = params_for(rate)
    nsym_max = rp.num_symbols(max_len)
    for length in (1, 23, 64):
        payload = rng.integers(0, 256, length, dtype=np.uint8)
        sam = ppdu.encode(jnp.asarray(payload), rate)
        data = sam[48:]  # drop header symbol samples
        # pad data-subcarrier samples to the max-geometry with garbage
        pad = (rng.standard_normal(nsym_max * 48 - data.shape[-1])
               + 1j * rng.standard_normal(nsym_max * 48 - data.shape[-1]))
        full = jnp.concatenate([data, jnp.asarray(pad, data.dtype)])
        got_p, got_ok, got_srv = ppdu.decode_data_dynamic_p(
            (jnp.real(full), jnp.imag(full)), rate,
            jnp.asarray(length), max_len)
        want_p, want_ok, want_srv = ppdu.decode_data(data, rate, length)
        assert bool(got_ok) and bool(want_ok)
        np.testing.assert_array_equal(
            np.asarray(got_p)[:length], np.asarray(want_p))
        assert int(got_srv) == int(want_srv)


def test_receive_capture_dynamic_mixed_lengths():
    rate = Rate.RATE_1_2_QPSK
    max_len = 120
    rng = np.random.default_rng(3)
    lens = [120, 3, 57]
    stream = np.zeros(8000, np.complex64)
    pos, positions, payloads = 90, [], []
    for L in lens:
        p = rng.integers(0, 256, L, dtype=np.uint8)
        f = np.asarray(tx.build_frame(jnp.asarray(p), rate))
        stream[pos:pos + len(f)] = f
        positions.append(pos)
        payloads.append(p)
        pos += len(f) + 300
    out = frontend.receive_capture_dynamic_p(
        (jnp.asarray(stream.real), jnp.asarray(stream.imag)),
        rate, max_len, max_frames=5)
    for k, (p0, p) in enumerate(zip(positions, payloads)):
        assert int(np.asarray(out["starts"])[k]) == p0
        assert bool(np.asarray(out["crc_ok"])[k])
        assert int(np.asarray(out["hdr_length"])[k]) == len(p)
        np.testing.assert_array_equal(
            np.asarray(out["payload"])[k, :len(p)], p)
    assert not np.asarray(out["crc_ok"])[len(lens):].any()


def test_dynamic_rejects_other_rate():
    """A frame at a different rate reports its header, crc_ok=False."""
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, 40, dtype=np.uint8)
    frame = np.asarray(tx.build_frame(jnp.asarray(payload),
                                      Rate.RATE_3_4_QAM16))
    stream = np.zeros(3000, np.complex64)
    stream[100:100 + len(frame)] = frame
    out = frontend.receive_capture_dynamic_p(
        (jnp.asarray(stream.real), jnp.asarray(stream.imag)),
        Rate.RATE_1_2_BPSK, 64, max_frames=2)
    assert bool(np.asarray(out["header_ok"])[0])
    assert int(np.asarray(out["hdr_length"])[0]) == 40
    assert int(np.asarray(out["rate_field"])[0]) == 0xB  # 3/4-QAM16
    assert not np.asarray(out["crc_ok"])[0]


def test_decode_headers_only():
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 25, dtype=np.uint8)
    frame = np.asarray(tx.build_frame(jnp.asarray(payload),
                                      Rate.RATE_2_3_QAM64))
    stream = np.zeros(2500, np.complex64)
    stream[64:64 + len(frame)] = frame
    out = frontend.decode_headers_p(
        (jnp.asarray(stream.real), jnp.asarray(stream.imag)), max_frames=3)
    assert bool(np.asarray(out["header_ok"])[0])
    assert int(np.asarray(out["starts"])[0]) == 64
    assert int(np.asarray(out["hdr_length"])[0]) == 25
    assert int(np.asarray(out["rate_field"])[0]) == 0x1  # 2/3-QAM64


def test_anyrate_decode_all_rates_one_graph():
    """The universal any-rate decoder: ONE jitted graph decodes frames of
    every configured rate, selecting demap/deinterleave/depuncture via
    per-frame gather tables from the decoded SIGNAL field (VERDICT r3
    items 3/5: replaces one compiled variant + device dispatch per rate).
    Must be bit-identical to the per-rate dynamic decode."""
    from fun_ofdm_tpu.rates import ALL_RATES

    rng = np.random.default_rng(77)
    max_length = 48
    lengths = {r: int(ln) for r, ln in
               zip(ALL_RATES, rng.integers(8, max_length + 1,
                                           len(ALL_RATES)))}
    fn = jax.jit(lambda s, st: rx.decode_frame_anyrate_p(
        s, ALL_RATES, max_length, start=st))
    pad_len = max(params_for(r).frame_samples(max_length)
                  for r in ALL_RATES)
    for r in ALL_RATES:
        payload = rng.integers(0, 256, lengths[r], dtype=np.uint8)
        frame = np.asarray(tx.build_frame(jnp.asarray(payload), r))
        stream = np.zeros(37 + frame.size + pad_len, np.complex64)
        stream[37:37 + frame.size] = frame
        out = fn((jnp.asarray(stream.real), jnp.asarray(stream.imag)),
                 jnp.asarray(37))
        assert bool(np.asarray(out["crc_ok"])), f"rate {r}"
        assert int(np.asarray(out["hdr_length"])) == lengths[r]
        assert int(np.asarray(out["rate_field"])) \
            == params_for(r).rate_field
        got = np.asarray(out["payload"])[:lengths[r]].astype(np.uint8)
        np.testing.assert_array_equal(got, payload)


def test_anyrate_unknown_rate_reports_header_only():
    """A frame at a rate outside the configured tuple: header fields are
    reported, crc_ok is False (the reference's skip-and-report path)."""
    rng = np.random.default_rng(78)
    payload = rng.integers(0, 256, 20, dtype=np.uint8)
    frame = np.asarray(tx.build_frame(jnp.asarray(payload),
                                      Rate.RATE_2_3_QAM64))
    rates = (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16)
    pad_len = max(params_for(r).frame_samples(40) for r in rates)
    stream = np.zeros(frame.size + pad_len, np.complex64)
    stream[:frame.size] = frame
    out = rx.decode_frame_anyrate_p(
        (jnp.asarray(stream.real), jnp.asarray(stream.imag)), rates, 40)
    assert bool(np.asarray(out["header_ok"]))
    assert not bool(np.asarray(out["rate_match"]))
    assert not bool(np.asarray(out["crc_ok"]))
    assert int(np.asarray(out["hdr_length"])) == 20


def test_sharded_receive_dynamic_mixed_rates_cpu_mesh():
    """Any-rate sharded receive on the 8-virtual-device CPU mesh: mixed-
    rate frames (one straddling a time cut) decode from their headers
    with exactly-once global delivery (VERDICT r3 item 3)."""
    from fun_ofdm_tpu.parallel import stream_shard
    from fun_ofdm_tpu.parallel.mesh import make_mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(jax.devices("cpu"), channel=2, time=4)
    rates = (Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16)
    max_length = 20
    flens = {r: params_for(r).frame_samples(max_length) for r in rates}
    block, channels = 4096, 2
    n = block * 4

    rng = np.random.default_rng(55)
    plan = [(300, rates[0]),
            (block - flens[rates[1]] // 2, rates[1]),   # straddles cut 1
            (2 * block + 77, rates[1]),
            (3 * block - flens[rates[0]] + 40, rates[0])]  # straddles cut 3
    s_re = np.zeros((channels, n), np.float32)
    s_im = np.zeros((channels, n), np.float32)
    payloads = {}
    for c in range(channels):
        for pos, r in plan:
            payload = rng.integers(0, 256, max_length, dtype=np.uint8)
            payloads[(c, pos)] = (r, payload)
            fre, fim = tx.build_frame_p(jnp.asarray(payload), r)
            s_re[c, pos:pos + flens[r]] = np.asarray(fre)
            s_im[c, pos:pos + flens[r]] = np.asarray(fim)

    sharding = NamedSharding(mesh, P("channel", "time"))
    dev = (jax.device_put(jnp.asarray(s_re), sharding),
           jax.device_put(jnp.asarray(s_im), sharding))
    out = jax.jit(lambda s: stream_shard.sharded_receive_dynamic(
        s, rates, max_length, mesh, max_frames_per_block=4))(dev)
    crc_ok = np.asarray(out["crc_ok"])
    gstarts = np.asarray(out["starts"])
    rfield = np.asarray(out["rate_field"])
    pl_out = np.asarray(out["payload"])
    want = sorted(pos for pos, _ in plan)
    for c in range(channels):
        got = sorted(int(s) for s in gstarts[c][crc_ok[c]])
        assert got == want
        for k in np.nonzero(crc_ok[c])[0]:
            r, payload = payloads[(c, int(gstarts[c][k]))]
            assert int(rfield[c][k]) == params_for(r).rate_field
            np.testing.assert_array_equal(
                pl_out[c, k, :max_length].astype(np.uint8), payload)
