"""Sample I/O backends: the reference usrp wrapper's role, radio-free.

The reference's usrp class (src/usrp.cpp:20-130) does three jobs: carry
radio configuration (usrp_params, src/usrp.h:25-52), push TX bursts
(send_burst_sync, src/usrp.cpp:91-114), and pull RX sample chunks
(get_samples, src/usrp.cpp:125-130). With no radio hardware attached,
those roles map to:

  * RadioParams       — the usrp_params equivalent (kept field-for-field so
                        reference users find their knobs; frequencies/gains
                        are metadata for file/loopback backends).
  * LoopbackRadio     — an in-process radio bus over the native sample ring
                        (csrc/stream_runtime.cpp): TX bursts go in, RX
                        chunks come out, optionally through a channel
                        impairment function (AWGN/CFO/multipath from
                        sim/channel.py). This is the hardware-free
                        transceiver path (reference examples run two
                        processes on two USRPs; here one process, one bus).
  * FileSource/FileSink — capture replay and recording (interleaved
                        complex64, the common SDR file format).
  * UdpSink/UdpSource — networked sample transport: TX and RX as two OS
                        processes (or machines) streaming quantized
                        samples over UDP, the radio-free equivalent of
                        the reference's two-USRP air link
                        (src/usrp.cpp:91-130, README.md:299-311). The
                        wire speaks the same sc16/sc12/sc8 formats as
                        the chain's ingest path, with per-datagram
                        sample-index sequencing: lost datagrams become
                        zero gaps (a real radio's dropped samples), so
                        stream positions stay aligned and the chain just
                        loses those frames.

All sources yield planar (re, im) float32 numpy arrays; get_samples always
returns exactly n samples (zero/noise-filled when the bus runs dry, like a
real radio's constant sample clock).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .native import SampleRing, _planar_f32


@dataclass(frozen=True)
class RadioParams:
    """Radio configuration (reference usrp_params, src/usrp.h:25-52).

    freq/sample_rate/gains are carried for API parity and used where they
    matter (tx_amp scales TX bursts exactly like usrp::send_burst,
    src/usrp.cpp:94; sample_rate paces idle loopback reads).
    """

    freq: float = 5.72e9
    sample_rate: float = 5e6
    tx_gain: float = 20.0
    rx_gain: float = 20.0
    tx_amp: float = 1.0
    device_addr: str = ""


@dataclass
class RadioStats:
    """Overflow/underflow accounting (the reference surfaces UHD overflow
    as on-screen 'D's and waits on BURST_ACK, src/usrp.cpp:99-123; these
    are the structured equivalent)."""

    #: bursts that found the ring full under the drop policy
    overruns: int = 0
    #: TX samples discarded by overruns
    dropped_samples: int = 0
    #: get_samples calls that ran dry and were noise/zero-filled
    underruns: int = 0
    #: RX samples synthesized as idle fill
    fill_samples: int = 0
    #: UDP: datagrams that arrived out of order/duplicated and were dropped
    reordered: int = 0
    #: UDP: samples lost to datagram gaps (zero-filled to keep alignment)
    lost_samples: int = 0
    #: UDP: malformed/truncated datagrams dropped
    malformed: int = 0
    #: UDP: stream restarts detected (sender seq reset) and re-locked
    resyncs: int = 0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class LoopbackRadio:
    """In-process TX→RX radio bus (native ring buffer transport).

    channel: optional host-side impairment applied per burst —
      fn(re, im) -> (re, im), e.g. an AWGN/CFO composition built from
      sim/channel.py (jitted JAX or plain numpy both work).
    noise_floor: std-dev of gaussian fill when the bus is idle (0 = zeros).
    block_on_full: True (default) = send_burst blocks until the whole
      burst fits (the reference's BURST_ACK wait, src/usrp.cpp:99-114);
      False = a burst that doesn't fit is dropped whole and counted in
      stats (a real radio's overflow 'D').
    pace_idle: emulate the radio sample clock — get_samples waits up to
      n/sample_rate for samples before synthesizing idle fill, so an idle
      RX loop blocks instead of busy-spinning the device on zero windows.
    """

    def __init__(self, params: RadioParams = RadioParams(),
                 channel: Optional[Callable] = None,
                 noise_floor: float = 0.0,
                 capacity: int = 1 << 22,
                 pace_idle: bool = True,
                 block_on_full: bool = True):
        self.params = params
        self._channel = channel
        self._noise_floor = noise_floor
        self._pace_idle = pace_idle
        self._block_on_full = block_on_full
        self._ring = SampleRing(capacity)
        self._rng = np.random.default_rng(0)
        self._lock = threading.Lock()
        self._tx_q = None
        self._tx_thread: Optional[threading.Thread] = None
        self._closed = False
        self.stats = RadioStats()

    # --- TX side (reference usrp::send_burst / send_burst_sync,
    # src/usrp.cpp:91-123: _sync blocks on the BURST_ACK, the plain
    # variant is fire-and-forget) ------------------------------------------

    def _tx_push(self, re: np.ndarray, im: np.ndarray) -> None:
        """Apply amp/channel and push one whole burst onto the air."""
        amp = np.float32(self.params.tx_amp)
        re, im = re * amp, im * amp
        if self._channel is not None:
            re, im = self._channel(re, im)
            re = np.ascontiguousarray(re, np.float32)
            im = np.ascontiguousarray(im, np.float32)
        if self._block_on_full:
            self._ring.push((re, im), blocking=True)
            return
        # drop policy: all-or-nothing per burst, so a partial frame never
        # reaches the air (the native ring reserves whole blocking bursts;
        # non-blocking we pre-check capacity ourselves)
        with self._lock:
            if self._ring.capacity - len(self._ring) < re.size:
                self.stats.overruns += 1
                self.stats.dropped_samples += int(re.size)
                return
            self._ring.push((re, im), blocking=False)

    def _tx_worker(self) -> None:
        while True:
            item = self._tx_q.get()
            if item is None:
                return
            re, im, done = item
            try:
                self._tx_push(re, im)
            finally:
                if done is not None:
                    done.set()

    def _enqueue(self, samples, wait: bool) -> None:
        if self._closed:
            raise RuntimeError("LoopbackRadio is closed (ADVICE r2: "
                               "post-close sends would block forever)")
        if self._tx_q is None:
            with self._lock:
                if self._tx_q is None:
                    self._tx_q = queue.SimpleQueue()
                    self._tx_thread = threading.Thread(
                        target=self._tx_worker, name="fun_ofdm_tx",
                        daemon=True)
                    self._tx_thread.start()
        re, im = _planar_f32(samples)
        done = threading.Event() if wait else None
        self._tx_q.put((re, im, done))
        if done is not None:
            done.wait()

    def send_burst(self, samples) -> None:
        """Fire-and-forget: queue the burst to the TX worker and return
        (reference usrp::send_burst, src/usrp.cpp:116-123). Order is
        preserved with send_burst_sync (same queue)."""
        self._enqueue(samples, wait=False)

    def send_burst_sync(self, samples) -> None:
        """Send one burst and wait until it is fully on the air
        (reference usrp::send_burst_sync BURST_ACK wait,
        src/usrp.cpp:91-114)."""
        self._enqueue(samples, wait=True)

    # --- RX side (reference usrp::get_samples, src/usrp.cpp:125) ---------

    def get_samples(self, n: int):
        """Exactly n planar samples; idle bus yields noise-floor fill."""
        if self._pace_idle:
            # radio sample clock: block up to the time n samples take on
            # the air before declaring the bus idle
            re, im = self._ring.pop(n, timeout=n / self.params.sample_rate)
        else:
            re, im = self._ring.pop(n, blocking=False)
        pad = n - re.size
        if pad:
            self.stats.underruns += 1
            self.stats.fill_samples += int(pad)
            if self._noise_floor > 0.0:
                with self._lock:
                    fre = self._rng.normal(0, self._noise_floor, pad)
                    fim = self._rng.normal(0, self._noise_floor, pad)
                fre = fre.astype(np.float32)
                fim = fim.astype(np.float32)
            else:
                fre = np.zeros(pad, np.float32)
                fim = np.zeros(pad, np.float32)
            re = np.concatenate([re, fre])
            im = np.concatenate([im, fim])
        return re, im

    @property
    def pending(self) -> int:
        return len(self._ring)

    def wait_tx(self) -> None:
        """Block until every queued async burst is on the air."""
        if self._closed:
            return  # close() already drained the worker
        if self._tx_q is not None:
            self._enqueue((np.zeros(0, np.float32),
                           np.zeros(0, np.float32)), wait=True)

    def close(self) -> None:
        # close the ring first so a TX worker blocked on a full ring
        # unblocks (closed pushes return early), then drain the worker
        self._closed = True
        self._ring.close()
        if self._tx_thread is not None:
            self._tx_q.put(None)
            self._tx_thread.join(timeout=10)
            self._tx_thread = None


#: UDP datagram header: magic, version, wire-format id, sample count,
#: stream sample index of the first sample
_UDP_HDR = struct.Struct("<4sBBHQ")
_UDP_MAGIC = b"FOFD"
_UDP_FMT = {"int16": 0, "int12": 1, "int8": 2, "int10": 3}
_UDP_FMT_INV = {v: k for k, v in _UDP_FMT.items()}
#: bytes per sample per planar component on the wire
_WIRE_BYTES = {"int16": 2, "int12": 1.5, "int10": 1.25, "int8": 1}
#: samples-per-packet alignment per format (pack-group size)
_WIRE_ALIGN = {"int16": 2, "int12": 2, "int10": 4, "int8": 2}


def _quantize_wire(re: np.ndarray, im: np.ndarray, fmt: str):
    from .chain import INGEST_FORMATS, PACKED_FORMATS, _pack_np

    np_dtype, scale = INGEST_FORMATS[fmt]
    if fmt in PACKED_FORMATS:
        return (_pack_np(re, fmt, scale), _pack_np(im, fmt, scale))
    lim = float(np.iinfo(np_dtype).max)
    return (np.clip(np.rint(re * scale), -lim, lim).astype(np_dtype),
            np.clip(np.rint(im * scale), -lim, lim).astype(np_dtype))


def _dequantize_bytes(buf: bytes, n: int, fmt: str):
    from .chain import INGEST_FORMATS, PACKED_FORMATS, _unpack_np

    np_dtype, scale = INGEST_FORMATS[fmt]
    if fmt in PACKED_FORMATS:
        gb, gs = PACKED_FORMATS[fmt]
        comp = n * gb // gs
        re = _unpack_np(np.frombuffer(buf[:comp], np.uint8), fmt, scale)
        im = _unpack_np(np.frombuffer(buf[comp:2 * comp], np.uint8),
                        fmt, scale)
        return re, im
    comp = n * np.dtype(np_dtype).itemsize
    re = np.frombuffer(buf[:comp], np_dtype).astype(np.float32)
    im = np.frombuffer(buf[comp:2 * comp], np_dtype).astype(np.float32)
    inv = np.float32(1.0 / scale)
    return re * inv, im * inv


class UdpSink:
    """Send TX bursts to a UdpSource over the network (radio-free
    two-process transceiver; reference analogue: usrp::send_burst pushing
    samples up the Ethernet link to the radio, src/usrp.cpp:91-123).

    wire: over-the-wire sample format ("int16" = UHD sc16 default,
    "int12", "int8"); samples_per_packet defaults to an MTU-safe
    datagram (<= 1472 bytes with the 16-byte header). Sample indices in
    the headers let the receiver zero-fill datagram loss so stream
    alignment survives.
    """

    def __init__(self, addr: tuple[str, int],
                 params: RadioParams = RadioParams(),
                 wire: str = "int16",
                 samples_per_packet: int | None = None):
        if wire not in _UDP_FMT:
            raise ValueError(f"wire must be one of {sorted(_UDP_FMT)}")
        self.params = params
        self.wire = wire
        align = _WIRE_ALIGN[wire]
        if samples_per_packet is None:
            samples_per_packet = int((1472 - _UDP_HDR.size)
                                     // (2 * _WIRE_BYTES[wire]))
            samples_per_packet -= samples_per_packet % align
        if samples_per_packet % align:
            raise ValueError(
                f"samples_per_packet must be a multiple of {align}")
        if not 0 < samples_per_packet <= 0xFFFF:
            raise ValueError("samples_per_packet must fit the uint16 "
                             "datagram header (1..65535)")
        if int(2 * samples_per_packet * _WIRE_BYTES[wire]) \
                + _UDP_HDR.size > 65507:
            raise ValueError("samples_per_packet exceeds the maximum "
                             "UDP datagram payload")
        self.spp = samples_per_packet
        self._addr = (addr[0], int(addr[1]))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._seq = 0            # stream sample index of the next sample
        self._res_re = np.zeros(0, np.float32)
        self._res_im = np.zeros(0, np.float32)
        self._lock = threading.Lock()

    def _send_packet(self, re: np.ndarray, im: np.ndarray) -> None:
        qre, qim = _quantize_wire(re, im, self.wire)
        hdr = _UDP_HDR.pack(_UDP_MAGIC, 1, _UDP_FMT[self.wire],
                            re.size, self._seq)
        self._sock.sendto(hdr + qre.tobytes() + qim.tobytes(), self._addr)
        self._seq += re.size

    def send_burst(self, samples) -> None:
        re, im = _planar_f32(samples)
        amp = np.float32(self.params.tx_amp)
        with self._lock:
            re = np.concatenate([self._res_re, re * amp])
            im = np.concatenate([self._res_im, im * amp])
            n_full = re.size // self.spp * self.spp
            for i in range(0, n_full, self.spp):
                self._send_packet(re[i:i + self.spp], im[i:i + self.spp])
            self._res_re, self._res_im = re[n_full:], im[n_full:]

    send_burst_sync = send_burst

    def flush(self) -> None:
        """Send any buffered sub-packet residue (padded to alignment)."""
        with self._lock:
            if self._res_re.size:
                align = _WIRE_ALIGN[self.wire]
                pad = (-self._res_re.size) % align
                re = np.concatenate(
                    [self._res_re, np.zeros(pad, np.float32)])
                im = np.concatenate(
                    [self._res_im, np.zeros(pad, np.float32)])
                self._send_packet(re, im)
                self._res_re = np.zeros(0, np.float32)
                self._res_im = np.zeros(0, np.float32)

    def close(self) -> None:
        self.flush()
        self._sock.close()


class UdpSource:
    """Receive a sample stream from a UdpSink (reference analogue:
    usrp::get_samples pulling from the radio's Ethernet link,
    src/usrp.cpp:125-130).

    A background thread reassembles datagrams by their sample index:
    gaps (lost datagrams) are zero-filled and counted
    (stats.lost_samples), late/duplicate datagrams are dropped
    (stats.reordered) - stream positions stay aligned, so the receiver
    chain loses exactly the frames the network lost, like a radio
    dropping samples. get_samples blocks up to the radio-clock time for
    n samples, then zero-fills (stats.underruns), matching LoopbackRadio.
    """

    def __init__(self, addr: tuple[str, int] = ("0.0.0.0", 0),
                 params: RadioParams = RadioParams(),
                 capacity: int = 1 << 22):
        self.params = params
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((addr[0], int(addr[1])))
        self._sock.settimeout(0.25)
        self.addr = self._sock.getsockname()
        self._ring = SampleRing(capacity)
        self._next_seq: int | None = None   # lock onto the first datagram
        self._below_streak = 0              # consecutive below-lock drops
        self._closed = False
        self.stats = RadioStats()
        self._thread = threading.Thread(
            target=self._rx_loop, name="fun_ofdm_udp_rx", daemon=True)
        self._thread.start()

    #: forward gaps beyond this many samples are treated as a corrupt
    #: sequence field / new stream rather than loss to zero-fill (at
    #: 5 MS/s this is ~13 s of air time)
    MAX_GAP = 1 << 26

    def _rx_loop(self) -> None:
        while not self._closed:
            try:
                pkt, _ = self._sock.recvfrom(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                self._handle_packet(pkt)
            except Exception:
                # a malformed datagram (truncated payload, stray traffic
                # with a valid-looking header) must never kill the RX
                # daemon - drop it and keep receiving
                self.stats.malformed += 1

    def _handle_packet(self, pkt: bytes) -> None:
        if len(pkt) < _UDP_HDR.size:
            self.stats.malformed += 1
            return
        magic, ver, fmt, n, seq = _UDP_HDR.unpack_from(pkt)
        if magic != _UDP_MAGIC or ver != 1 or fmt not in _UDP_FMT_INV:
            self.stats.malformed += 1
            return
        fmt_name = _UDP_FMT_INV[fmt]
        want = int(2 * n * _WIRE_BYTES[fmt_name])
        if n == 0 or len(pkt) - _UDP_HDR.size < want:
            self.stats.malformed += 1
            return
        if self._next_seq is None:
            self._next_seq = seq
        if seq < self._next_seq:
            # a RESTARTED sender begins again at a low sample index; a
            # hard lock on the first stream would drop its traffic
            # forever (each datagram counted 'reordered'). Genuine
            # out-of-order delivery is a few packets deep and CLOSE to
            # the lock; a RUN of below-lock datagrams far below it is a
            # new stream - re-lock onto it. Both conditions: a streak
            # alone would re-lock on a burst of merely-reordered
            # datagrams and duplicate an already-delivered span.
            self._below_streak += 1
            if self._below_streak > 8 and self._next_seq - seq > 8 * n:
                self.stats.resyncs += 1
                self._next_seq = seq
                self._below_streak = 0
            else:
                self.stats.reordered += 1
                return
        if seq > self._next_seq:
            gap = int(seq - self._next_seq)
            if gap > self.MAX_GAP:
                # corrupt sequence field or a different stream epoch:
                # zero-filling gigabytes would block the thread and
                # desync everything after - re-lock instead
                self.stats.resyncs += 1
            else:
                self.stats.lost_samples += gap
                while gap > 0:       # fill the WHOLE gap (alignment)
                    z = np.zeros(min(gap, 1 << 20), np.float32)
                    self._ring.push((z, z), blocking=True)
                    gap -= z.size
        re, im = _dequantize_bytes(pkt[_UDP_HDR.size:], n, fmt_name)
        self._ring.push((re, im), blocking=True)
        self._next_seq = seq + n
        self._below_streak = 0

    def get_samples(self, n: int):
        re, im = self._ring.pop(n, timeout=n / self.params.sample_rate)
        pad = n - re.size
        if pad:
            self.stats.underruns += 1
            self.stats.fill_samples += int(pad)
            re = np.concatenate([re, np.zeros(pad, np.float32)])
            im = np.concatenate([im, np.zeros(pad, np.float32)])
        return re, im

    @property
    def pending(self) -> int:
        return len(self._ring)

    def close(self) -> None:
        self._closed = True
        self._ring.close()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5)


class FileSource:
    """Replay a recorded capture file.

    fmt: "complex64" (default - interleaved c64, the common SDR float
    format) or "int16" (interleaved sc16 I/Q, the other standard SDR
    interchange format; samples scale by the chain's canonical sc16
    wire scale).
    """

    def __init__(self, path: str, params: RadioParams = RadioParams(),
                 fmt: str = "complex64"):
        if fmt not in ("complex64", "int16"):
            raise ValueError("fmt must be 'complex64' or 'int16'")
        self.params = params
        self.fmt = fmt
        self._f = open(path, "rb")
        self.exhausted = False

    def get_samples(self, n: int):
        if self.fmt == "int16":
            buf = self._f.read(n * 4)  # interleaved I/Q int16
            v = np.frombuffer(buf, dtype=np.int16).astype(np.float32)
            v *= np.float32(1.0 / 8192.0)
            if v.size < 2 * n:
                self.exhausted = True
                v = np.concatenate([v, np.zeros(2 * n - v.size, np.float32)])
            return (np.ascontiguousarray(v[0::2]),
                    np.ascontiguousarray(v[1::2]))
        buf = self._f.read(n * 8)  # complex64 = 8 bytes
        x = np.frombuffer(buf, dtype=np.complex64)
        if x.size < n:
            self.exhausted = True
            x = np.concatenate([x, np.zeros(n - x.size, np.complex64)])
        return (np.ascontiguousarray(x.real, np.float32),
                np.ascontiguousarray(x.imag, np.float32))

    def close(self) -> None:
        self._f.close()


class FileSink:
    """Record TX bursts to a capture file (formats as FileSource)."""

    def __init__(self, path: str, params: RadioParams = RadioParams(),
                 fmt: str = "complex64"):
        if fmt not in ("complex64", "int16"):
            raise ValueError("fmt must be 'complex64' or 'int16'")
        self.params = params
        self.fmt = fmt
        self._f = open(path, "wb")

    def send_burst(self, samples) -> None:
        re, im = _planar_f32(samples)
        amp = np.float32(self.params.tx_amp)
        if self.fmt == "int16":
            v = np.empty(2 * re.size, np.int16)
            v[0::2] = np.clip(np.rint(re * amp * 8192.0), -32767, 32767)
            v[1::2] = np.clip(np.rint(im * amp * 8192.0), -32767, 32767)
            v.tofile(self._f)
            return
        (re * amp + 1j * (im * amp)).astype(np.complex64).tofile(self._f)

    send_burst_sync = send_burst

    def close(self) -> None:
        self._f.close()
