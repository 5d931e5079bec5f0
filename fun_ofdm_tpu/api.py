"""Top-level API: Transmitter and Receiver facades.

The public surface of the framework, mirroring the reference's two
exported classes (src/transmitter.h:49-73, src/receiver.h:58-83) with the
same ergonomics — `Transmitter.send_frame(payload, rate)` and
`Receiver(callback)` with `pause()`/`resume()` — over the device
stack: jitted batched frame building (models/tx), the streaming
ReceiverChain runtime (runtime/chain), and pluggable sample I/O backends
(runtime/io) in place of the USRP.

Extension beyond the reference: `send_burst(payloads, rate)`
builds a whole batch of frames in one device call (the efficient
path — per-frame calls exist for parity, batched calls for throughput).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np

from .config import ChainParams, DEFAULT_PARAMS
from .rates import ALL_RATES, Rate
from .runtime.chain import DecodedPacket, ReceiverChain
from .runtime.io import LoopbackRadio, RadioParams


class Transmitter:
    """Builds 802.11a frames and sends them to a sample sink.

    Reference equivalent: transmitter (src/transmitter.cpp:15-37) —
    build_frame + send_burst_sync composition. The sink is any object with
    `send_burst(samples)` (LoopbackRadio, FileSink, or user code).
    """

    def __init__(self, sink=None, params: RadioParams = RadioParams()):
        self.sink = sink if sink is not None else LoopbackRadio(params)
        self.params = params
        from .utils.cache import enable_persistent_cache
        enable_persistent_cache()

    def _send(self, re, im) -> None:
        # reference transmitter::send_frame uses the SYNC burst
        # (src/transmitter.cpp:33-37); fall back for sinks without one
        send = getattr(self.sink, "send_burst_sync", self.sink.send_burst)
        send((re, im))

    def send_frame(self, payload, rate: Rate = Rate.RATE_1_2_BPSK) -> int:
        """Build one frame and send it; returns the sample count sent
        (reference: src/transmitter.cpp:33-37)."""
        import jax.numpy as jnp
        from .models import tx

        data = np.frombuffer(bytes(payload), dtype=np.uint8)
        re, im = tx.build_frame_p_jit(Rate(rate))(jnp.asarray(data))
        self._send(np.asarray(re), np.asarray(im))
        return int(re.shape[-1])

    #: send_burst shape buckets: batch sizes and payload-length caps the
    #: mixed-length builder pads to, so arbitrary bursts reuse a small set
    #: of compiled graphs instead of minting one per (count, max-length)
    BURST_BATCH_BUCKETS = (4, 16, 64, 256)
    BURST_LEN_BUCKETS = (64, 256, 1024, 2000)

    def send_burst(self, payloads: Sequence, rate) -> int:
        """Build a whole burst of frames in ONE batched device call per
        rate and send them back-to-back in order (the batched device
        path). Payload lengths may differ (the reference transmitter's
        per-frame flexibility, src/transmitter.cpp:33-37): equal-length
        bursts take the static builder; mixed bursts take the
        dynamic-length builder (models/tx.build_frames_mixed_p), padded
        to shape buckets so the jit cache stays bounded. `rate` may also
        be a sequence of per-frame Rates (one build per distinct rate,
        frames sent in the original order). Returns samples sent."""
        import jax.numpy as jnp
        from .models import tx

        mats = [np.frombuffer(bytes(p), dtype=np.uint8) for p in payloads]
        if not mats:
            return 0
        if not isinstance(rate, (Rate, int)):
            rates = [Rate(r) for r in rate]
            if len(rates) != len(mats):
                raise ValueError("per-frame rates must match payloads")
            if len(set(rates)) > 1:
                # group by rate, build each group batched, then emit the
                # frames in their original burst order
                frames: dict[int, tuple] = {}
                for r in set(rates):
                    idx = [i for i, ri in enumerate(rates) if ri == r]
                    group = [payloads[i] for i in idx]
                    sink = _CaptureSink()
                    orig_sink, self.sink = self.sink, sink
                    try:
                        self.send_burst(group, r)
                    finally:
                        self.sink = orig_sink
                    off = 0
                    lens = [tx_len(self, payloads[i], r) for i in idx]
                    for i, ln in zip(idx, lens):
                        frames[i] = (sink.re[off:off + ln],
                                     sink.im[off:off + ln])
                        off += ln
                out_re = np.concatenate([frames[i][0]
                                         for i in range(len(mats))])
                out_im = np.concatenate([frames[i][1]
                                         for i in range(len(mats))])
                self._send(out_re, out_im)
                return int(out_re.size)
            rate = rates[0]
        sizes = {m.size for m in mats}
        if len(sizes) == 1:
            batch = np.stack(mats)
            re, im = tx.build_frame_p_jit(Rate(rate))(jnp.asarray(batch))
            re = np.asarray(re).reshape(-1)
            im = np.asarray(im).reshape(-1)
            self._send(re, im)
            return int(re.size)

        # mixed lengths: zero-pad payloads to a bucketed max length and
        # the batch to a bucketed count (extra rows repeat frame 0 and
        # are never sliced out), then slice each frame's true extent
        lmax = max(sizes)
        lb = next((b for b in self.BURST_LEN_BUCKETS if b >= lmax), lmax)
        nb = next((b for b in self.BURST_BATCH_BUCKETS
                   if b >= len(mats)), len(mats))
        pay = np.zeros((nb, lb), np.uint8)
        lens = np.full(nb, mats[0].size, np.int32)
        for i, m in enumerate(mats):
            pay[i, :m.size] = m
            lens[i] = m.size
        re, im, ns = tx.build_frames_mixed_p_jit(Rate(rate))(
            jnp.asarray(pay), jnp.asarray(lens))
        re, im, ns = np.asarray(re), np.asarray(im), np.asarray(ns)
        out_re = np.concatenate(
            [re[i, :ns[i]] for i in range(len(mats))])
        out_im = np.concatenate(
            [im[i, :ns[i]] for i in range(len(mats))])
        self._send(out_re, out_im)
        return int(out_re.size)


class _CaptureSink:
    """Internal: collect a burst's samples instead of sending them."""

    def __init__(self):
        self.re = np.zeros(0, np.float32)
        self.im = np.zeros(0, np.float32)

    def send_burst(self, samples):
        re, im = samples
        self.re = np.concatenate([self.re, np.asarray(re, np.float32)])
        self.im = np.concatenate([self.im, np.asarray(im, np.float32)])

    send_burst_sync = send_burst


def tx_len(txr, payload, rate: Rate) -> int:
    """Sample count of one frame (320 + 80*(1+num_symbols))."""
    from .rates import params_for

    return params_for(Rate(rate)).frame_samples(len(bytes(payload)))


class Receiver:
    """Continuously pulls sample chunks from a source, runs the streaming
    receiver chain, and delivers CRC-valid packets to a callback.

    Reference equivalent: receiver (src/receiver.cpp:16-77) — spawns its
    own RX thread running get_samples → process_samples → callback, with
    semaphore pause/resume. Here the thread is std-library, the chain is
    the jitted ReceiverChain, and the source is any object with
    `get_samples(n) -> (re, im)` (LoopbackRadio, FileSource, user code).

    callback: fn(list[DecodedPacket]) — called from the RX thread with
    every batch of packets a chunk completes (reference callback contract,
    src/receiver.h:58: vector of payloads per processed chunk).
    """

    def __init__(self, callback: Callable[[list], None],
                 source=None,
                 params: RadioParams = RadioParams(),
                 chain_params: ChainParams = DEFAULT_PARAMS,
                 rates: tuple[Rate, ...] = ALL_RATES,
                 max_length: int = 1500,
                 cfo_correct: bool = False,
                 start: bool = True,
                 ingest_dtype: str = "float32",
                 viterbi_impl: str = "auto",
                 decode_mode: str = "auto"):
        self.callback = callback
        self.source = source if source is not None else LoopbackRadio(params)
        self.chain = ReceiverChain(rates=rates, max_length=max_length,
                                   params=chain_params,
                                   cfo_correct=cfo_correct,
                                   ingest_dtype=ingest_dtype,
                                   viterbi_impl=viterbi_impl,
                                   decode_mode=decode_mode)
        self._chunk = chain_params.chunk_size
        self._running = threading.Event()   # set = not paused
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._running.set()
        if start:
            self.start()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._rx_loop, name="fun_ofdm_rx", daemon=True)
        self._thread.start()

    def _rx_loop(self) -> None:
        # reference receiver_chain_loop (src/receiver.cpp:42-58)
        while not self._stop.is_set():
            self._running.wait()        # sem_wait(m_pause) equivalent
            if self._stop.is_set():
                break
            re, im = self.source.get_samples(self._chunk)
            packets = self.chain.process_samples((re, im))
            if packets:
                self.callback(packets)

    def pause(self) -> None:
        """Pause the receiver chain (reference: src/receiver.cpp:64-70)."""
        self._running.clear()

    def resume(self) -> None:
        """Resume the receiver chain (reference: src/receiver.cpp:72-77)."""
        self._running.set()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the RX thread and drain buffered samples to the callback."""
        self._stop.set()
        self._running.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        packets = self.chain.flush()
        if packets:
            self.callback(packets)
