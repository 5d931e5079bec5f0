"""Streaming receiver chain: superstep-pipelined chunked RX.

Device equivalent of the reference's receiver_chain runtime
(src/receiver_chain.cpp:29-126): `process_samples(chunk)` accepts
arbitrary-length sample runs and returns every CRC-valid payload whose
frame completed. The reference overlaps its six block stages with one
thread per block and a barrier per 4096-sample chunk; here the same
overlap comes from XLA's async dispatch, and the CPU-era per-chunk cadence
is replaced by *supersteps*:

  * Every device dispatch and result fetch costs a fixed overhead, so
    the chain batches K = strides_per_step chunks into ONE device
    dispatch and ONE result fetch covering K * chunk_size samples. Frame
    ownership stays per-chunk-exact; only the device cadence changes.
  * The device keeps a rolling sample window (one H2D per superstep,
    appended by the jitted step itself); the overlap-save halo is reused
    on device instead of re-uploaded.
  * Both pipeline stages run dispatch-ahead with their own in-flight
    queues: header results (stage 1) and payload decodes (stage 2) are
    fetched only once the queue exceeds pipeline_depth or the device has
    already finished them, and every device->host block is prefetched
    with copy_to_host_async at dispatch time, so no fetch waits on a cold
    synchronous copy.

Two device passes per superstep (the reference's frame_decoder does the
same two-phase header-then-payload walk, src/frame_decoder.cpp:45-91):
  1. detection + SIGNAL header decode on the owned region (rate-independent);
  2. one batched payload decode per distinct rate seen, with per-frame
     lengths from the headers (models/rx.decode_frame_dynamic_p). Decode
     batches are padded to a small set of fixed bucket sizes so the jit
     cache stays bounded (a fresh shape per frame-count would recompile).

Frames are delivered exactly once: a frame belongs to the superstep whose
owned [0, step) region contains its preamble start; equal duplicate starts
(a noise-fragmented plateau resolving to the same LTS pair twice) are
deduplicated before decode.
"""

from __future__ import annotations

import collections
import functools
import sys
import time
from dataclasses import dataclass

import numpy as np

from ..config import ChainParams, DEFAULT_PARAMS
from ..rates import ALL_RATES, Rate, params_for
from ..utils.platform import on_gpu
from . import native

#: detection + SIGNAL header need this much beyond a frame start
#: (320 preamble + 80 SIGNAL + LTS search margin)
DETECT_LEAD = 512

#: reference MAX_FRAME_SIZE (src/ppdu.h:17)
MAX_FRAME_SIZE = 2000

#: pad per-superstep device->host result blocks up to this many bytes,
#: which keeps the fetch path identical across supersteps (sized for an
#: earlier transport's flat small-copy latency; re-tuning it for the
#: H100 is ROADMAP Speed #7)
FETCH_PAD_BYTES = 1 << 16

#: auto superstep target on the GPU (samples per device dispatch; sized
#: for an earlier transport's bulk path, to be re-tuned for the H100)
AUTO_STEP_SAMPLES = 1 << 20

#: payload-decode batch bucket sizes: jobs are padded up to one of these
#: so at most len(DECODE_BUCKETS) shapes per rate ever compile
DECODE_BUCKETS = (4, 16, 64, 256, 1024)

#: host->device sample formats: (numpy dtype, quantization scale).
#: float32 is bit-parity with the reference's fc64-derived pipeline;
#: int16 is the USRP's over-the-wire sample format (UHD sc16 -
#: the N210's ADC is 14-bit, so sc16 ingest is radio-exact) at half the
#: H2D bytes; int12 (UHD sc12, 2 samples packed into 3 bytes per planar
#: component) cuts another 25% with ~55 dB quantization SNR - transparent
#: even for 64-QAM; int8 (UHD sc8) is the smallest but adds ~-35 dB
#: quantization noise: fine through 16-QAM, NOT enough for 64-QAM
#: (measured: 64-QAM frames in a clean mixed stream fail CRC at sc8).
INGEST_FORMATS = {
    "float32": (np.float32, 1.0),
    "int16": (np.int16, 8192.0),
    "int12": (np.uint8, 512.0),   # packed: 3 bytes per 2 samples
    "int10": (np.uint8, 128.0),   # packed: 5 bytes per 4 samples
    "int8": (np.int8, 32.0),
}

#: packed integer formats: name -> (bytes, samples) per pack group.
#: int12 is UHD's sc12 OTW format; int10 is OUR wire format (no UHD
#: equivalent): ~34 dB quantization SNR at the nominal +-4 full scale -
#: still ~7 dB above 64-QAM's needs - at 17% fewer wire bytes than sc12
#: (made for a narrow host link; whether it earns its place on the H100
#: is ROADMAP Design #5).
PACKED_FORMATS = {"int12": (3, 2), "int10": (5, 4)}

#: canonical wire scale per integer sample dtype (inverse of INGEST_FORMATS;
#: int12's packed uint8 buffers are handled separately - see pack12)
_WIRE_SCALE = {np.dtype(np.int16): 8192.0, np.dtype(np.int8): 32.0}


def pack12(x: np.ndarray, scale: float = 512.0) -> np.ndarray:
    """Quantize float samples to 12-bit and pack 2 samples into 3 bytes
    (planar-per-component variant of UHD's sc12 over-the-wire format).
    Operates on the last axis (even length); leading axes (channels)
    pass through."""
    v = np.clip(np.rint(np.asarray(x, np.float64) * scale),
                -2048, 2047).astype(np.int16) & 0xFFF
    even, odd = v[..., 0::2], v[..., 1::2]
    out = np.empty(v.shape[:-1] + (v.shape[-1] * 3 // 2,), np.uint8)
    out[..., 0::3] = even & 0xFF
    out[..., 1::3] = ((even >> 8) & 0xF) | ((odd & 0xF) << 4)
    out[..., 2::3] = (odd >> 4) & 0xFF
    return out


def unpack12_np(b: np.ndarray, scale: float = 512.0) -> np.ndarray:
    """Inverse of pack12 -> float32 samples (host side, last axis)."""
    b = np.asarray(b, np.uint8)
    b0, b1, b2 = (b[..., 0::3].astype(np.int32),
                  b[..., 1::3].astype(np.int32),
                  b[..., 2::3].astype(np.int32))
    even = b0 | ((b1 & 0xF) << 8)
    odd = (b1 >> 4) | (b2 << 4)
    v = np.empty(b0.shape[:-1] + (b0.shape[-1] * 2,), np.int32)
    v[..., 0::2], v[..., 1::2] = even, odd
    v -= (v & 0x800) << 1  # sign-extend 12 bits
    return (v.astype(np.float32) * np.float32(1.0 / scale))


def pack10(x: np.ndarray, scale: float = 128.0) -> np.ndarray:
    """Quantize float samples to 10-bit and pack 4 samples into 5 bytes
    (planar-per-component; our own wire format - see PACKED_FORMATS).
    Last axis length must be a multiple of 4; leading axes pass through."""
    v = np.clip(np.rint(np.asarray(x, np.float64) * scale),
                -512, 511).astype(np.int16) & 0x3FF
    s0, s1, s2, s3 = (v[..., 0::4].astype(np.uint32),
                      v[..., 1::4].astype(np.uint32),
                      v[..., 2::4].astype(np.uint32),
                      v[..., 3::4].astype(np.uint32))
    out = np.empty(v.shape[:-1] + (v.shape[-1] * 5 // 4,), np.uint8)
    out[..., 0::5] = s0 & 0xFF
    out[..., 1::5] = (s0 >> 8) | ((s1 & 0x3F) << 2)
    out[..., 2::5] = (s1 >> 6) | ((s2 & 0xF) << 4)
    out[..., 3::5] = (s2 >> 4) | ((s3 & 0x3) << 6)
    out[..., 4::5] = s3 >> 2
    return out


def unpack10_np(b: np.ndarray, scale: float = 128.0) -> np.ndarray:
    """Inverse of pack10 -> float32 samples (host side, last axis)."""
    b = np.asarray(b, np.uint8)
    b0, b1, b2, b3, b4 = (b[..., i::5].astype(np.int32) for i in range(5))
    s0 = b0 | ((b1 & 0x3) << 8)
    s1 = (b1 >> 2) | ((b2 & 0xF) << 6)
    s2 = (b2 >> 4) | ((b3 & 0x3F) << 4)
    s3 = (b3 >> 6) | (b4 << 2)
    v = np.empty(b0.shape[:-1] + (b0.shape[-1] * 4,), np.int32)
    v[..., 0::4], v[..., 1::4], v[..., 2::4], v[..., 3::4] = s0, s1, s2, s3
    v -= (v & 0x200) << 1  # sign-extend 10 bits
    return v.astype(np.float32) * np.float32(1.0 / scale)


def _pack_np(x: np.ndarray, fmt: str, scale: float) -> np.ndarray:
    return pack12(x, scale) if fmt == "int12" else pack10(x, scale)


def _unpack_np(b: np.ndarray, fmt: str, scale: float) -> np.ndarray:
    return unpack12_np(b, scale) if fmt == "int12" else unpack10_np(b, scale)


def _dequantize_wire(arr: np.ndarray) -> np.ndarray:
    """Integer wire-format samples -> float32 at the dtype's canonical
    scale; float arrays pass through. Used on the slow ingest path so that
    _ingest's re-quantization is an identity instead of scaling raw
    integer magnitudes twice (ADVICE r3)."""
    scale = _WIRE_SCALE.get(arr.dtype)
    if scale is None:
        return arr
    return arr.astype(np.float32) * np.float32(1.0 / scale)


def _headers_block(jnp, frontend, wr, wi, ds_lo, ds_hi, max_frames,
                   n_hdr, params, step, cfo_correct):
    """Detection + SIGNAL headers over the window's detect slice, packed
    as the (6, n_hdr) int32 block _drain parses: rows [starts, valid,
    rate_field, hdr_length, header_ok, trailer] with trailer[0] = the
    blocked extractor's dropped-event count and trailer[1] = the total
    detection count (ONE layout, shared by the step fn and the
    header_slots overflow fallback)."""
    h = frontend.decode_headers_p(
        (wr[..., ds_lo:ds_hi], wi[..., ds_lo:ds_hi]),
        max_frames=max_frames, params=params, drop_count_limit=step,
        cfo_correct=cfo_correct,
        hdr_slots=None if n_hdr == max_frames else n_hdr)
    trailer = jnp.zeros((n_hdr,), jnp.int32).at[0].set(
        h["detect_dropped"].astype(jnp.int32)).at[1].set(
        h["n_detected"].astype(jnp.int32))
    return jnp.concatenate([jnp.stack([
        h["starts"].astype(jnp.int32),
        h["valid"].astype(jnp.int32),
        h["rate_field"].astype(jnp.int32),
        h["hdr_length"].astype(jnp.int32),
        h["header_ok"].astype(jnp.int32),
    ]), trailer[None, :]])


@functools.lru_cache(maxsize=None)
def _build_step_fn(step: int, max_frames: int, params: ChainParams,
                   ingest_dtype: str, channels: int = 1,
                   cfo_correct: bool = False, window: int | None = None,
                   halo: int | None = None,
                   hdr_slots: int | None = None):
    """Fused superstep: roll the device window by the incoming samples AND
    run the detection+header pass. Returns (window_re, window_im,
    header_block) where header_block is ONE flat int32 array — per
    channel, rows [starts, valid, rate_field, hdr_length, header_ok,
    drop] — padded to FETCH_PAD_BYTES. One dispatch and one prefetched
    fetch per superstep, regardless of channel count (channels > 1 vmaps
    the detection+header pass over the leading axis: the streaming
    analogue of the capture path's multi-channel geometry).

    Module-level + lru_cache so every ReceiverChain with the same config
    shares one traced/compiled function (a per-instance closure would
    re-trace per chain: ~1.5 s overhead per construction at 1M-sample
    supersteps even with the persistent XLA cache hitting).

    window/halo generalize to the adaptive-superstep ladder: the owned
    region is the window slice [window-halo-step, window-halo) — the
    samples lagging ingestion by exactly `halo` — which tiles the stream
    for ANY sequence of dispatch sizes (fixed mode is the special case
    window = step + halo, slice offset 0)."""
    import jax
    import jax.numpy as jnp
    from ..models import frontend

    if window is None:
        window = step + (halo or DETECT_LEAD)
    if halo is None:
        halo = window - step
    off = window - halo - step
    ds_lo, ds_hi = off, window - halo + DETECT_LEAD
    _, scale = INGEST_FORMATS[ingest_dtype]

    # >= 2: the trailer row stores [dropped, n_detected] at indices 0, 1
    n_hdr = max_frames if hdr_slots is None \
        else max(2, min(hdr_slots, max_frames))

    def headers(wr, wi):
        return _headers_block(jnp, frontend, wr, wi, ds_lo, ds_hi,
                              max_frames, n_hdr, params, step,
                              cfo_correct)

    def fn(wr, wi, cr, ci):
        if ingest_dtype == "int12":
            def unpack(b):
                t = b.astype(jnp.int32).reshape(*b.shape[:-1], -1, 3)
                even = t[..., 0] | ((t[..., 1] & 0xF) << 8)
                odd = (t[..., 1] >> 4) | (t[..., 2] << 4)
                v = jnp.stack([even, odd], axis=-1).reshape(
                    *b.shape[:-1], -1)
                v = v - ((v & 0x800) << 1)  # sign-extend 12 bits
                return v.astype(jnp.float32) * np.float32(1.0 / scale)
            cr = unpack(cr)
            ci = unpack(ci)
        elif ingest_dtype == "int10":
            def unpack(b):
                t = b.astype(jnp.int32).reshape(*b.shape[:-1], -1, 5)
                s0 = t[..., 0] | ((t[..., 1] & 0x3) << 8)
                s1 = (t[..., 1] >> 2) | ((t[..., 2] & 0xF) << 6)
                s2 = (t[..., 2] >> 4) | ((t[..., 3] & 0x3F) << 4)
                s3 = (t[..., 3] >> 6) | (t[..., 4] << 2)
                v = jnp.stack([s0, s1, s2, s3], axis=-1).reshape(
                    *b.shape[:-1], -1)
                v = v - ((v & 0x200) << 1)  # sign-extend 10 bits
                return v.astype(jnp.float32) * np.float32(1.0 / scale)
            cr = unpack(cr)
            ci = unpack(ci)
        elif ingest_dtype != "float32":
            cr = cr.astype(jnp.float32) * np.float32(1.0 / scale)
            ci = ci.astype(jnp.float32) * np.float32(1.0 / scale)
        wr = jnp.concatenate([wr[..., cr.shape[-1]:], cr], axis=-1)
        wi = jnp.concatenate([wi[..., ci.shape[-1]:], ci], axis=-1)
        if channels > 1:
            flat = jax.vmap(headers)(wr, wi).reshape(-1)
        else:
            flat = headers(wr, wi).reshape(-1)
        pad = max(0, FETCH_PAD_BYTES // 4 - flat.shape[0])
        return wr, wi, jnp.concatenate([flat, jnp.zeros(pad, jnp.int32)])

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _build_headers_full_fn(step: int, max_frames: int, params: ChainParams,
                           channels: int, cfo_correct: bool,
                           window: int, halo: int):
    """Full-capacity header pass over an already-rolled window (the
    header_slots overflow fallback: rare supersteps with more detection
    events than the budget re-run here; one extra dispatch, nothing
    lost)."""
    import jax
    import jax.numpy as jnp
    from ..models import frontend

    off = window - halo - step
    ds_lo, ds_hi = off, window - halo + DETECT_LEAD

    def headers(wr, wi):
        return _headers_block(jnp, frontend, wr, wi, ds_lo, ds_hi,
                              max_frames, max_frames, params, step,
                              cfo_correct)

    def fn(wr, wi):
        if channels > 1:
            flat = jax.vmap(headers)(wr, wi).reshape(-1)
        else:
            flat = headers(wr, wi).reshape(-1)
        pad = max(0, FETCH_PAD_BYTES // 4 - flat.shape[0])
        return jnp.concatenate([flat, jnp.zeros(pad, jnp.int32)])

    return jax.jit(fn)


#: largest decode bucket that "auto" sends through the block-overlap
#: decode on a GPU; larger buckets run the exact kernel (sending every
#: bucket through it measured no faster on an all-rates stream; PERF.md)
BLOCKED_MAX_BUCKET = 64


def _impl_for_bucket(impl: str, bucket: int) -> str | None:
    """Resolve the chain's viterbi_impl knob to a per-bucket decoder
    (None = the platform's exact decoder, utils/platform.exact_viterbi).

    "auto": on a GPU, small decode batches fill few kernel lanes and
    serialize the ~12k-step time axis; the block-overlap decode maps
    trellis blocks onto lanes instead (its merge guard flags frames for
    an exact re-decode). Elsewhere "auto" is the exact scan.
    """
    if impl == "auto":
        return "blocked" if on_gpu() and bucket <= BLOCKED_MAX_BUCKET \
            else None
    if impl == "exact":
        return None
    return impl


def _pack_decode_rows(jnp, out) -> "jnp.ndarray":
    """Flatten a decode-output dict to (bucket * (max_length + 5),) uint8
    rows — payload bytes, then [crc_ok, len_lo, len_hi, viterbi_exact,
    rate_field] — padded to FETCH_PAD_BYTES."""
    ln = out["hdr_length"].astype(jnp.int32)
    flat = jnp.concatenate([
        out["payload"].astype(jnp.uint8),
        out["crc_ok"][:, None].astype(jnp.uint8),
        (ln[:, None] & 0xFF).astype(jnp.uint8),
        ((ln[:, None] >> 8) & 0xFF).astype(jnp.uint8),
        out["viterbi_exact"][:, None].astype(jnp.uint8),
        (out["rate_field"][:, None] & 0xFF).astype(jnp.uint8),
    ], axis=1).reshape(-1)
    pad = max(0, FETCH_PAD_BYTES - flat.shape[0])
    return jnp.concatenate([flat, jnp.zeros(pad, jnp.uint8)])


@functools.lru_cache(maxsize=None)
def _build_decode_fn(rate: Rate, bucket: int, max_length: int,
                     cfo_correct: bool, impl: str = "auto"):
    """Single-rate payload pass returning ONE (bucket, max_length + 5)
    uint8 row block per job (see _pack_decode_rows; single prefetched
    fetch, same rationale as _build_step_fn). One compiled variant per
    (rate, bucket, impl) — job batches are padded up to bucket so
    frame-count never mints new shapes. Shared across chain instances
    (lru_cache).

    impl: "auto" (see _impl_for_bucket; a block-overlap decode's merge
    guard sets the viterbi_exact column and the chain re-decodes flagged
    frames via the "exact" variant), "exact" forces the platform's exact
    decoder, any other value is passed to ops/viterbi.viterbi_decode
    verbatim."""
    import jax
    import jax.numpy as jnp
    from ..models import rx

    vimpl = _impl_for_bucket(impl, bucket)

    def fn(wr, wi, starts):
        # multi-channel chains pass their full (C, W) window with starts
        # pre-offset by channel*W: the row-major flatten is free and the
        # 1-D decode path handles every channel in the SAME dispatch
        # (frame extents never cross a row boundary - the per-channel
        # halo covers them)
        wr, wi = wr.reshape(-1), wi.reshape(-1)
        out = jax.vmap(
            lambda s: rx.decode_frame_dynamic_p(
                (wr, wi), rate, max_length, start=s,
                cfo_correct=cfo_correct, viterbi_impl=vimpl))(starts)
        return _pack_decode_rows(jnp, out)

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _build_decode_anyrate_fn(rates: tuple[Rate, ...], bucket: int,
                             max_length: int, cfo_correct: bool,
                             impl: str = "auto"):
    """Universal payload pass: ONE dispatch decodes a mixed-rate batch,
    each frame at the rate its SIGNAL header carries
    (models/rx.decode_frame_anyrate_p). Same row layout as
    _build_decode_fn. This replaces up to len(rates) dispatch+fetch pairs
    per superstep on mixed streams (VERDICT r3 item 5)."""
    import jax
    import jax.numpy as jnp
    from ..models import rx

    vimpl = _impl_for_bucket(impl, bucket)

    def fn(wr, wi, starts):
        wr, wi = wr.reshape(-1), wi.reshape(-1)   # see _build_decode_fn
        out = jax.vmap(
            lambda s: rx.decode_frame_anyrate_p(
                (wr, wi), rates, max_length, start=s,
                cfo_correct=cfo_correct, viterbi_impl=vimpl))(starts)
        return _pack_decode_rows(jnp, out)

    return jax.jit(fn)


@dataclass(frozen=True)
class DecodedPacket:
    """One CRC-valid decoded frame (the chain's output unit)."""

    payload: bytes
    rate: Rate
    length: int
    #: preamble start position in the global (per-channel) sample stream
    start: int
    #: channel index (multi-channel chains; 0 for single-channel)
    channel: int = 0

    def __bytes__(self) -> bytes:
        return self.payload


@dataclass
class ChainStats:
    """Running counters for chain observability (the reference's only
    telemetry is stderr prints, src/ppdu.cpp:276; these are the structured
    equivalent)."""

    samples_in: int = 0
    #: device supersteps processed (strides_per_step chunks each)
    windows: int = 0
    headers_ok: int = 0
    crc_ok: int = 0
    crc_fail: int = 0
    unknown_rate: int = 0
    #: CRC-valid headers dropped because hdr_length > max_length
    length_overflow: int = 0
    #: supersteps where every detection slot filled (possible missed frames)
    detect_saturated: int = 0
    #: detection events dropped device-side by the blocked extractor's
    #: per-512-sample-block cap (frontend._BLOCK_CAP; only a noise burst
    #: denser than 16 LTS-reachable events per 512 samples can trip it)
    detect_dropped: int = 0
    #: duplicate equal frame starts removed before decode
    dup_starts: int = 0
    #: supersteps whose detection count exceeded the header_slots budget
    #: and re-ran the full-capacity header pass (nothing lost)
    header_overflows: int = 0
    #: frames re-decoded with the exact Viterbi because the block-overlap
    #: kernel's merge guard flagged a possible splice failure (the
    #: fallback preserves the chain's bit-exactness contract)
    viterbi_fallbacks: int = 0
    #: wall-clock the host spent blocked on device results per stage (the
    #: analogue of the reference's per-block work() timing,
    #: src/receiver_chain.cpp:84-92); dispatch is async so this is sync
    #: wait time, not device time
    time_headers_s: float = 0.0
    time_decode_s: float = 0.0

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class ReceiverChain:
    """Stateful streaming receiver (reference receiver_chain equivalent).

    Args:
      rates: rates to decode (default: all 11). The halo (and so the
        window shape / memory) is sized by the longest frame any of these
        rates can produce at max_length.
      max_length: largest payload length to decode (reference
        MAX_FRAME_SIZE, src/ppdu.h:17, is 2000; examples use 1500).
      params: chain thresholds + chunk size + superstep batching
        (ChainParams).
      cfo_correct: enable the native-mode CFO estimation/correction
        (the reference's is dead code; see models/rx.estimate_cfo_p).
      verbose: print "Invalid CRC (length N)" to stderr on CRC failures,
        matching the reference's only runtime diagnostic (src/ppdu.cpp:276).
      pipeline_depth: in-flight supersteps per stage before the host
        blocks on the oldest (>=1; 1 = fully synchronous). The reference's
        analogue is its 6-stage chunk pipeline.
      ingest_dtype: host->device sample format: "float32" (reference
        fc32/fc64 parity), "int16" (UHD sc16 radio wire format, half the
        ingest bytes), "int12" (UHD sc12: 2 samples packed per 3 bytes,
        ~55 dB quantization SNR - safe for every rate incl. 64-QAM) or
        "int8" (UHD sc8, quarter; NOT enough for 64-QAM). See
        INGEST_FORMATS; int12 buffers are packed uint8 (pack12).
      viterbi_impl: payload Viterbi decoder. "auto" (default): on a GPU
        the guarded block-overlap decode for small decode buckets, with
        an exact re-decode of any frame its merge guard flags
        (stats.viterbi_fallbacks counts them), and the exact kernel for
        large buckets; elsewhere the exact scan. "exact" forces the
        platform's exact decoder, "triton"/"scan" force that exact
        decoder, "blocked" forces the block-overlap decode (still
        guarded).
      decode_mode: "auto" (default) uses the universal any-rate decoder
        (ONE device dispatch per superstep decode batch, every frame at
        its header's rate) when more than one rate is configured, and the
        cheaper single-rate decoder otherwise. "universal" / "per-rate"
        force either. Per-rate on a mixed stream issues one dispatch per
        (rate, bucket) pair — up to 11 per superstep.
      prewarm_exact: compile the exact-Viterbi re-decode variant (the
        merge-guard fallback path) in a background thread at chain
        construction, so the first flagged frame doesn't stall the
        pipeline for a synchronous jit (ADVICE r4). None (default) =
        True on accelerator backends, False on CPU (tests).
      channels: number of synchronized sample streams (default 1). With
        channels=C, process_samples takes (C, n) complex or planar
        buffers (one radio clock, C front-ends — a multi-antenna site or
        C co-located radios), detection+headers run for all channels in
        the SAME single device dispatch per superstep, and DecodedPacket
        carries its channel index. The reference is single-channel.

    process_samples() accepts any-length complex or planar chunks, exactly
    like receiver_chain::process_samples (src/receiver_chain.cpp:106).
    """

    def __init__(self, rates: tuple[Rate, ...] = ALL_RATES,
                 max_length: int = 1500,
                 params: ChainParams = DEFAULT_PARAMS,
                 cfo_correct: bool = False,
                 verbose: bool = False,
                 pipeline_depth: int = 2,
                 ingest_dtype: str = "float32",
                 viterbi_impl: str = "auto",
                 decode_mode: str = "auto",
                 channels: int = 1,
                 prewarm_exact: bool | None = None):
        if max_length > MAX_FRAME_SIZE:
            raise ValueError(f"max_length > MAX_FRAME_SIZE ({MAX_FRAME_SIZE})")
        if ingest_dtype not in INGEST_FORMATS:
            raise ValueError(f"ingest_dtype must be one of "
                             f"{sorted(INGEST_FORMATS)}")
        self.rates = tuple(Rate(r) for r in rates)
        if ingest_dtype == "int8":
            # sc8 quantization adds ~-35 dB noise: measurably breaks
            # 64-QAM (every frame fails CRC, indistinguishable from
            # noise to the user - see INGEST_FORMATS). Refuse the
            # combination instead of failing silently (VERDICT r4 #6);
            # callers wanting the small wire format drop the 64-QAM
            # rates or use "int12" (transparent at every rate).
            qam64 = [r.name for r in self.rates if params_for(r).bpsc >= 6]
            if qam64:
                raise ValueError(
                    f"ingest_dtype='int8' (sc8) cannot carry 64-QAM "
                    f"frames ({', '.join(qam64)}): 8-bit quantization "
                    f"noise fails their CRC. Exclude those rates or use "
                    f"ingest_dtype='int12'.")
        self.max_length = int(max_length)
        self.params = params
        self.cfo_correct = bool(cfo_correct)
        self.ingest_dtype = ingest_dtype
        self.channels = int(channels)
        if self.channels < 1:
            raise ValueError("channels must be >= 1")
        if viterbi_impl not in ("auto", "exact", "blocked", "triton",
                                "scan"):
            raise ValueError(
                "viterbi_impl must be auto|exact|blocked|triton|scan")
        self.viterbi_impl = viterbi_impl
        if decode_mode not in ("auto", "universal", "per-rate"):
            raise ValueError("decode_mode must be auto|universal|per-rate")
        self.decode_mode = ("universal" if len(rates) > 1 else "per-rate") \
            if decode_mode == "auto" else decode_mode
        self.stride = params.chunk_size
        k = params.strides_per_step
        if k is None:
            k = (max(1, -(-AUTO_STEP_SAMPLES // self.stride)) if on_gpu()
                 else 1)
        self.strides_per_step = max(1, int(k))
        #: samples per device superstep (ownership region length)
        self.step = self.stride * self.strides_per_step
        halo = max(params_for(r).frame_samples(max_length)
                   for r in self.rates)
        self.halo = max(halo, DETECT_LEAD)
        self.window = self.step + self.halo
        self.adaptive = params.latency_target_ms is not None
        if self.adaptive:
            # dispatch-size ladder (in strides): sparse/idle periods take
            # small dispatches near the transport's latency floor, dense
            # backlog takes full supersteps (VERDICT r4 #4); each rung is
            # one compiled step-fn variant over the SAME window
            self._ladder = [r for r in (1, 4, 16, 64, 256)
                            if r < self.strides_per_step]
            self._ladder.append(self.strides_per_step)
        self.verbose = bool(verbose)
        self.pipeline_depth = max(1, int(pipeline_depth))
        # Detection capacity: the reference has no cap (its detector tags
        # every plateau). Auto-size ours so even back-to-back minimal
        # frames anywhere in the detect region [0, step + DETECT_LEAD)
        # cannot exhaust the slots (frames in the lead halo consume slots
        # before the ownership filter).
        min_frame = min(params_for(r).frame_samples(0) for r in self.rates)
        if params.min_frame_samples is not None:
            # tuned capacity: the caller promises frames this short or
            # shorter won't occur (detect_saturated flags violations)
            min_frame = max(min_frame, int(params.min_frame_samples))
        self._min_frame = min_frame
        if params.max_frames_per_chunk is not None:
            self.max_frames = (int(params.max_frames_per_chunk)
                               * self.strides_per_step)
        else:
            self.max_frames = -(-(self.step + DETECT_LEAD) // min_frame) + 1
        # >= 2: the header-block trailer row carries [dropped, n_detected]
        self.max_frames = max(2, self.max_frames)
        self._valid_fields = {params_for(r).rate_field: r for r in self.rates}
        # universal-decode length classes: decoding a frame costs the
        # slowest CONFIGURED rate's symbol geometry (nsym_max), so rates
        # are partitioned into <=2 extent classes and each superstep
        # dispatches per class present - a QAM64 frame then pays ~189
        # symbols of extract/FFT/equalize instead of BPSK's 503
        # (VERDICT r4 #9). The split minimizes sum(|class| * max_nsym);
        # single-rate / uniform-extent sets collapse to one class.
        by_nsym = sorted(self.rates,
                         key=lambda r: params_for(r).num_symbols(max_length))
        nsyms = [params_for(r).num_symbols(max_length) for r in by_nsym]
        best, best_cost = [tuple(by_nsym)], len(by_nsym) * nsyms[-1]
        for cut in range(1, len(by_nsym)):
            cost = cut * nsyms[cut - 1] + (len(by_nsym) - cut) * nsyms[-1]
            if cost < best_cost:
                best_cost = cost
                best = [tuple(by_nsym[:cut]), tuple(by_nsym[cut:])]
        self._classes = best
        self._field_class = {
            params_for(r).rate_field: ci
            for ci, cls in enumerate(self._classes) for r in cls}
        # second runs of any chain-using CLI/API start in seconds
        from ..utils.cache import enable_persistent_cache
        enable_persistent_cache()
        self.stats = ChainStats()
        if prewarm_exact is None:
            prewarm_exact = on_gpu()
        if prewarm_exact and _impl_for_bucket(
                self.viterbi_impl, DECODE_BUCKETS[0]) == "blocked":
            # the first merge-guard fallback would otherwise jit-compile
            # the exact decode variant synchronously mid-stream
            # (ADVICE r4); warm the smallest bucket (_redecode_exact's
            # common shape - flagged frames are rare) in the background
            import threading
            threading.Thread(target=self._prewarm_exact,
                             name="fun_ofdm_prewarm", daemon=True).start()

        # host side: slice arbitrary pushes into exact superstep chunks
        # (single-channel: the native chunker; multi-channel: a python
        # list-accumulator over the (C, n) axis; adaptive: a pending
        # float buffer drained by _pump at ladder sizes)
        self._rechunk = native.Chunker(self.step, self.step) \
            if self.channels == 1 and not self.adaptive else None
        self._mc_buf: list = []          # list of (C, k) float32 pairs
        self._mc_avail = 0
        self._pend: list = []            # adaptive: (re, im) 1-D pieces
        self._pend_n = 0
        self._pend_t0: float | None = None
        # device side: rolling window state
        self._dev_win = None          # planar (window,) device arrays
        self._s_total = 0             # samples ingested (incl. warmup pad)
        self._t_real = 0              # real samples pushed
        # in-flight queues: headers awaiting sync, decodes awaiting sync
        self._hdr_q: collections.deque = collections.deque()
        self._dec_q: collections.deque = collections.deque()

    # --- jitted device functions (shared across instances) ---------------

    def _prewarm_exact(self) -> None:
        """AOT-compile the exact decode variant for the smallest bucket
        (background thread; failures are harmless - the fallback then
        compiles lazily as before)."""
        try:
            import jax

            import jax.numpy as jnp

            bucket = DECODE_BUCKETS[0]
            rate = (self._classes[0] if self.decode_mode == "universal"
                    else self.rates[0])
            fn = self._decode_fn(rate, bucket, exact=True)
            win_shape = (self.window,) if self.channels == 1 \
                else (self.channels, self.window)
            # a real dummy call (not lower().compile()): populates the
            # jit dispatch cache itself, so the first flagged frame is
            # fast even with the persistent XLA cache disabled
            z = jnp.zeros(win_shape, jnp.float32)
            jax.block_until_ready(
                fn(z, z, jnp.zeros((bucket,), jnp.int32)))
        except Exception:
            pass

    def _capacity(self, step: int) -> int:
        """Detection slot capacity for one dispatch of `step` samples."""
        if step == self.step:
            return self.max_frames
        if self.params.max_frames_per_chunk is not None:
            return max(2, int(self.params.max_frames_per_chunk)
                       * max(1, step // self.stride))
        return max(2, -(-(step + DETECT_LEAD) // self._min_frame) + 1)

    def _step_fn(self, step: int | None = None):
        step = self.step if step is None else step
        return _build_step_fn(step, self._capacity(step), self.params,
                              self.ingest_dtype, self.channels,
                              self.cfo_correct, self.window, self.halo,
                              self.params.header_slots)

    def _decode_fn(self, rate, bucket: int, exact: bool = False):
        """Jitted decode for one bucket. rate: a Rate (single-rate pass),
        a tuple of Rates (universal any-rate over that length class), or
        None (universal over every configured rate)."""
        impl = "exact" if exact else self.viterbi_impl
        if rate is None:
            rate = self.rates
        if isinstance(rate, tuple):
            return _build_decode_anyrate_fn(rate, bucket,
                                            self.max_length,
                                            self.cfo_correct, impl)
        return _build_decode_fn(rate, bucket, self.max_length,
                                self.cfo_correct, impl)

    # --- streaming API ----------------------------------------------------

    def _pend_push(self, re: np.ndarray, im: np.ndarray) -> None:
        if self._pend_t0 is None:
            self._pend_t0 = time.perf_counter()
        self._pend.append((re, im))
        self._pend_n += re.size

    def _pend_take(self, n: int, pad_to: int | None = None):
        """Pop n samples from the adaptive pending buffer (zero-pad to
        pad_to when set)."""
        taken_re, taken_im, got = [], [], 0
        while got < n:
            re, im = self._pend[0]
            need = n - got
            if re.size <= need:
                taken_re.append(re)
                taken_im.append(im)
                got += re.size
                self._pend.pop(0)
            else:
                taken_re.append(re[:need])
                taken_im.append(im[:need])
                self._pend[0] = (re[need:], im[need:])
                got = n
        self._pend_n -= n
        if self._pend_n == 0:
            self._pend_t0 = None
        if pad_to is not None and pad_to > n:
            taken_re.append(np.zeros(pad_to - n, np.float32))
            taken_im.append(np.zeros(pad_to - n, np.float32))
        return np.concatenate(taken_re), np.concatenate(taken_im)

    def _pump(self) -> None:
        """Adaptive dispatch policy: full supersteps while backlogged;
        once the oldest pending sample is ~half the latency target old,
        flush the backlog in the largest ladder dispatches that fit."""
        full = self.step
        while self._pend_n >= full:
            self._ingest(*self._pend_take(full))
        if not self._pend_n:
            return
        age_ms = (time.perf_counter() - self._pend_t0) * 1e3
        if age_ms < self.params.latency_target_ms / 2:
            return
        for r in reversed(self._ladder):
            k = r * self.stride
            while self._pend_n >= k:
                self._ingest(*self._pend_take(k))
        # a sub-chunk residue stays pending (flush() pads it out)

    def _pump_mc(self) -> None:
        """Multi-channel twin of _pump over the (C, n) accumulator."""
        while self._mc_avail >= self.step:
            self._ingest(*self._mc_take(self.step))
        if not self._mc_avail:
            self._pend_t0 = None
            return
        if self._pend_t0 is None:
            self._pend_t0 = time.perf_counter()
        age_ms = (time.perf_counter() - self._pend_t0) * 1e3
        if age_ms < self.params.latency_target_ms / 2:
            return
        for r in reversed(self._ladder):
            k = r * self.stride
            while self._mc_avail >= k:
                self._ingest(*self._mc_take(k))
        if not self._mc_avail:
            self._pend_t0 = None

    def process_samples(self, samples) -> list[DecodedPacket]:
        """Feed a chunk of samples; return packets completed by it.

        samples: 1-D complex array, or planar (re, im) arrays. Planar
        arrays whose dtype already matches ingest_dtype (a radio
        delivering its native sc16/sc8 buffers) are shipped as-is — no
        host-side conversion — when they arrive in whole supersteps;
        integer wire-format buffers of any other length are rescaled to
        float32 once and rechunked (same decoded output, one extra host
        copy). Packets may be returned on a later call
        than the one whose samples completed them (pipelining + superstep
        batching); flush() drains everything.
        """
        if self.channels > 1:
            return self._process_multichannel(samples)
        if self.adaptive:
            if isinstance(samples, tuple):
                re = np.asarray(samples[0])
                im = np.asarray(samples[1])
                if self.ingest_dtype in PACKED_FORMATS \
                        and re.dtype == np.uint8 and im.dtype == np.uint8:
                    # packed wire buffers (the fixed-mode fast-path
                    # format): unpack into the pending float buffer
                    gb, _ = PACKED_FORMATS[self.ingest_dtype]
                    if re.size % gb:
                        raise ValueError(
                            f"packed {self.ingest_dtype} buffers must be "
                            f"a multiple of {gb} bytes")
                    _, scale = INGEST_FORMATS[self.ingest_dtype]
                    re = _unpack_np(re, self.ingest_dtype, scale)
                    im = _unpack_np(im, self.ingest_dtype, scale)
                else:
                    re = _dequantize_wire(re)
                    im = _dequantize_wire(im)
            else:
                arr = np.asarray(samples)
                re = np.ascontiguousarray(arr.real, np.float32)
                im = np.ascontiguousarray(arr.imag, np.float32)
            re = np.ascontiguousarray(re, np.float32)
            im = np.ascontiguousarray(im, np.float32)
            self.stats.samples_in += re.size
            self._t_real += re.size
            self._pend_push(re, im)
            self._pump()
            return self._drain(force=False)
        if isinstance(samples, tuple):
            n = samples[0].size
            np_dtype, scale = INGEST_FORMATS[self.ingest_dtype]
            if self.ingest_dtype in PACKED_FORMATS \
                    and samples[0].dtype == np.uint8 \
                    and samples[1].dtype == np.uint8:
                # packed wire buffers (int12: 3 B / 2 samples; int10:
                # 5 B / 4 samples, per planar component)
                gb, gs = PACKED_FORMATS[self.ingest_dtype]
                pb = self.step * gb // gs
                n = samples[0].size * gs // gb
                if (self._rechunk.available == 0
                        and samples[0].size % pb == 0):
                    self.stats.samples_in += n
                    self._t_real += n
                    for i in range(0, samples[0].size, pb):
                        self._ingest(samples[0][i:i + pb],
                                     samples[1][i:i + pb])
                    return self._drain(force=False)
                if samples[0].size % gb:
                    raise ValueError(
                        f"packed {self.ingest_dtype} buffers must be a "
                        f"multiple of {gb} bytes")
                samples = (_unpack_np(samples[0], self.ingest_dtype, scale),
                           _unpack_np(samples[1], self.ingest_dtype, scale))
            elif (samples[0].dtype == np_dtype
                    and samples[1].dtype == np_dtype
                    and np_dtype != np.float32
                    and self._rechunk.available == 0
                    and n % self.step == 0):
                # pre-quantized fast path: exact supersteps, zero-copy
                self.stats.samples_in += n
                self._t_real += n
                for i in range(0, n, self.step):
                    self._ingest(samples[0][i:i + self.step],
                                 samples[1][i:i + self.step])
                return self._drain(force=False)
            else:
                # integer wire-format buffers that miss the fast path
                # (length not a superstep multiple, residue buffered, or
                # mixed dtypes) must be rescaled to float32 before the
                # rechunker, or _ingest would quantize their raw
                # magnitudes a second time (ADVICE r3)
                samples = (_dequantize_wire(np.asarray(samples[0])),
                           _dequantize_wire(np.asarray(samples[1])))
        else:
            n = np.asarray(samples).size
        self._rechunk.push(samples)
        self.stats.samples_in += n
        self._t_real += n
        while True:
            chunk = None if not self._rechunk.ready() else self._rechunk.pop()
            if chunk is None:
                break
            self._ingest(chunk[0], chunk[1])
        return self._drain(force=False)

    def _mc_take(self, k: int):
        """Pop k samples per channel from the multi-channel accumulator."""
        taken_re, taken_im, got = [], [], 0
        while got < k:
            re, im = self._mc_buf[0]
            need = k - got
            if re.shape[-1] <= need:
                taken_re.append(re)
                taken_im.append(im)
                got += re.shape[-1]
                self._mc_buf.pop(0)
            else:
                taken_re.append(re[:, :need])
                taken_im.append(im[:, :need])
                self._mc_buf[0] = (re[:, need:], im[:, need:])
                got = k
        self._mc_avail -= k
        return (np.concatenate(taken_re, axis=-1),
                np.concatenate(taken_im, axis=-1))

    def _process_multichannel(self, samples) -> list[DecodedPacket]:
        """process_samples for channels > 1: (C, n) complex or planar
        buffers, same wire formats and fast paths as single-channel.
        Every channel advances in lockstep (one radio clock, C antennas/
        front-ends - the streaming analogue of the capture path's
        multi-channel geometry); packets carry their channel index."""
        if not isinstance(samples, tuple):
            arr = np.asarray(samples)
            samples = (np.ascontiguousarray(arr.real, dtype=np.float32),
                       np.ascontiguousarray(arr.imag, dtype=np.float32))
        re, im = np.asarray(samples[0]), np.asarray(samples[1])
        if re.ndim != 2 or re.shape[0] != self.channels:
            raise ValueError(
                f"multi-channel chain expects (channels={self.channels}, n)"
                " buffers")
        np_dtype, scale = INGEST_FORMATS[self.ingest_dtype]
        if self.ingest_dtype in PACKED_FORMATS and re.dtype == np.uint8 \
                and im.dtype == np.uint8:
            gb, gs = PACKED_FORMATS[self.ingest_dtype]
            pb = self.step * gb // gs
            n = re.shape[-1] * gs // gb
            if not self.adaptive and self._mc_avail == 0 \
                    and re.shape[-1] % pb == 0:
                self.stats.samples_in += n * self.channels
                self._t_real += n
                for i in range(0, re.shape[-1], pb):
                    self._ingest(re[:, i:i + pb], im[:, i:i + pb])
                return self._drain(force=False)
            if re.shape[-1] % gb:
                raise ValueError(
                    f"packed {self.ingest_dtype} buffers must be a "
                    f"multiple of {gb} bytes")
            re = _unpack_np(re, self.ingest_dtype, scale)
            im = _unpack_np(im, self.ingest_dtype, scale)
        elif (re.dtype == np_dtype and im.dtype == np_dtype
                and np_dtype != np.float32
                and not self.adaptive
                and self._mc_avail == 0
                and re.shape[-1] % self.step == 0):
            # pre-quantized fast path: exact supersteps, zero-copy
            self.stats.samples_in += re.size
            self._t_real += re.shape[-1]
            for i in range(0, re.shape[-1], self.step):
                self._ingest(re[:, i:i + self.step],
                             im[:, i:i + self.step])
            return self._drain(force=False)
        else:
            re = _dequantize_wire(re)
            im = _dequantize_wire(im)
        re = np.ascontiguousarray(re, dtype=np.float32)
        im = np.ascontiguousarray(im, dtype=np.float32)
        self.stats.samples_in += re.size
        self._t_real += re.shape[-1]
        if self._mc_avail == 0 and self._pend_t0 is None:
            self._pend_t0 = time.perf_counter()
        self._mc_buf.append((re, im))
        self._mc_avail += re.shape[-1]
        if self.adaptive:
            self._pump_mc()
        else:
            while self._mc_avail >= self.step:
                cre, cim = self._mc_take(self.step)
                self._ingest(cre, cim)
        return self._drain(force=False)

    def flush(self, terminal: bool = True) -> list[DecodedPacket]:
        """Drain buffered samples (zero-padding the tail) at stream end.

        Flush rolls zero supersteps through the window to force out every
        pending frame, so the stream position after flush contains
        synthetic zeros.

        terminal=True (default): the chain is done; start a new
        ReceiverChain for a new stream (the reference's analogue is
        destroying the receiver). terminal=False additionally RESETS the
        window to a clean stream position so this same chain can serve
        back-to-back streams (the reference receiver's indefinite
        lifetime, src/receiver.cpp:42-77) with no re-jit (compiled fns
        are shared): the next process_samples starts a fresh stream
        whose packet .start positions count from 0 again; stats remain
        cumulative."""
        if self._t_real == 0:
            # nothing real ever arrived: don't force compilation of the
            # step fn just to roll zeros (ADVICE r2)
            return []
        if self.adaptive:
            if self._pend_n:
                k = next(r for r in self._ladder
                         if r * self.stride >= self._pend_n)
                re, im = self._pend_take(self._pend_n,
                                         pad_to=k * self.stride)
                self._ingest(re, im)
            zeros = np.zeros(self.stride, np.float32)
        elif self.channels == 1:
            tail = self._rechunk.pop(pad=True)
            if tail is not None:
                self._ingest(tail[0], tail[1])
            zeros = np.zeros(self.step, np.float32)
        else:
            if self._mc_avail:
                re, im = self._mc_take(self._mc_avail)
                pad = self.step - re.shape[-1]
                z = np.zeros((self.channels, pad), np.float32)
                self._ingest(np.concatenate([re, z], axis=-1),
                             np.concatenate([im, z], axis=-1))
            zeros = np.zeros((self.channels, self.step), np.float32)
        # keep rolling zero dispatches until every real sample has been
        # owned (ownership lags ingestion by `halo`)
        while self._s_total - self.halo < self._t_real:
            self._ingest(zeros, zeros)
        packets = self._drain(force=True)
        if not terminal:
            # reset to a clean stream position: fresh window state and a
            # zeroed global sample counter; the jitted step/decode fns
            # and their compiled executables are untouched
            self._dev_win = None
            self._s_total = 0
            self._t_real = 0
            self._pend, self._pend_n, self._pend_t0 = [], 0, None
            if self._rechunk is not None:
                self._rechunk = native.Chunker(self.step, self.step)
            self._mc_buf = []
            self._mc_avail = 0
        return packets

    # --- pipeline stages ---------------------------------------------------

    def _ingest(self, c_re: np.ndarray, c_im: np.ndarray) -> None:
        """Ship one superstep of samples to the device and run the fused
        roll+detect+headers step asynchronously (one dispatch)."""
        import jax.numpy as jnp

        if self._dev_win is None:
            shape = (self.window,) if self.channels == 1 \
                else (self.channels, self.window)
            z = jnp.zeros(shape, jnp.float32)
            self._dev_win = (z, z)
        dtype, scale = INGEST_FORMATS[self.ingest_dtype]
        if self.ingest_dtype in PACKED_FORMATS:
            if c_re.dtype != np.uint8:
                c_re = _pack_np(c_re, self.ingest_dtype, scale)
                c_im = _pack_np(c_im, self.ingest_dtype, scale)
        elif self.ingest_dtype != "float32" and c_re.dtype != dtype:
            lim = float(np.iinfo(dtype).max)
            c_re = np.clip(np.rint(c_re * scale), -lim, lim).astype(dtype)
            c_im = np.clip(np.rint(c_im * scale), -lim, lim).astype(dtype)
        k = c_re.shape[-1]
        if self.ingest_dtype in PACKED_FORMATS and c_re.dtype == np.uint8:
            gb, gs = PACKED_FORMATS[self.ingest_dtype]
            k = k * gs // gb
        wr, wi, hdr = self._step_fn(k)(
            self._dev_win[0], self._dev_win[1],
            jnp.asarray(c_re), jnp.asarray(c_im))
        self._dev_win = (wr, wi)
        # this dispatch owns the k samples lagging ingestion by `halo`
        # (tiles the stream for any dispatch-size sequence)
        gpos = self._s_total - self.halo
        self._s_total += k
        if gpos + k <= 0:
            return  # warm-up: owned region entirely before the stream
        # start the device->host copy now so the wire time overlaps the
        # next supersteps' compute instead of serializing into the sync
        copy_async = getattr(hdr, "copy_to_host_async", None)
        if copy_async is not None:
            copy_async()
        self.stats.windows += 1
        self._hdr_q.append((gpos, k, self._dev_win, hdr))

    @staticmethod
    def _ready(arr) -> bool:
        is_ready = getattr(arr, "is_ready", None)
        return bool(is_ready()) if is_ready is not None else False

    def _dispatch_one(self, win, rate: Rate | None, chs, local_starts,
                      off, jobs) -> None:
        """Dispatch decode jobs for (channel, start) pairs gathered across
        ALL channels, padded to fixed buckets so frame count never mints a
        fresh jit shape; overflow splits into max-bucket jobs.

        The channel index folds into the start offset (flat start =
        ch * window + start; the decode fn flattens its (C, W) window
        row-major), so a multi-channel superstep costs ONE decode
        dispatch+fetch instead of one per channel."""
        import jax.numpy as jnp

        flat = (chs.astype(np.int64) * self.window
                + off + local_starts).astype(np.int32)
        for lo in range(0, flat.size, DECODE_BUCKETS[-1]):
            part = slice(lo, lo + DECODE_BUCKETS[-1])
            fpart = flat[part]
            bucket = next(b for b in DECODE_BUCKETS if b >= fpart.size)
            padded = np.full(bucket, fpart[0], np.int32)
            padded[:fpart.size] = fpart
            out = self._decode_fn(rate, bucket)(
                win[0], win[1], jnp.asarray(padded))
            copy_async = getattr(out, "copy_to_host_async", None)
            if copy_async is not None:
                copy_async()
            jobs.append((rate, chs[part], local_starts[part],
                         fpart.copy(), out))

    def _dispatch_decodes(self, win, chs, starts, fields, off,
                          jobs) -> None:
        """Queue batched payload decodes for one superstep's owned frames
        (all channels merged; stage 2 dispatch, fetched by a later
        _drain). chs/starts/fields: equal-length arrays over frames; off:
        owned-region offset in window coordinates."""
        if self.decode_mode == "universal":
            # ONE mixed-rate dispatch per length class per bucket: every
            # frame of every channel decodes at its header's rate in the
            # same graph, against its class's (smaller) symbol geometry
            for ci, cls in enumerate(self._classes):
                sel = np.array([self._field_class.get(int(f)) == ci
                                for f in fields])
                if sel.any():
                    self._dispatch_one(win, cls, chs[sel], starts[sel],
                                       off, jobs)
        else:
            for field_val in np.unique(fields):
                sel = fields == field_val
                self._dispatch_one(win, self._valid_fields[int(field_val)],
                                   chs[sel], starts[sel], off, jobs)

    def _redecode_exact(self, win, rate: Rate | None,
                        flat_bad) -> np.ndarray:
        """Re-decode merge-guard-flagged frames with the exact Viterbi.

        flat_bad: channel-folded start offsets (ch * window + start).
        Returns the same (n, max_length + 5) uint8 row layout as the
        primary decode. Synchronous (flagged frames are rare)."""
        import jax.numpy as jnp

        row = self.max_length + 5
        outs = []
        for lo in range(0, flat_bad.size, DECODE_BUCKETS[-1]):
            part = flat_bad[lo:lo + DECODE_BUCKETS[-1]]
            bucket = next(b for b in DECODE_BUCKETS if b >= part.size)
            padded = np.full(bucket, part[0], np.int32)
            padded[:part.size] = part
            out = self._decode_fn(rate, bucket, exact=True)(
                win[0], win[1], jnp.asarray(padded))
            outs.append(np.asarray(out)[: part.size * row].reshape(-1, row))
        return np.concatenate(outs)

    def _collect_decodes(self, gpos, win, jobs) -> list[DecodedPacket]:
        """Sync one superstep's decode jobs into DecodedPackets."""
        wpkts: list[DecodedPacket] = []
        t1 = time.perf_counter()
        for rate, chs, starts, flat, out in jobs:
            row = self.max_length + 5
            packed = np.asarray(out)[: chs.size * row].reshape(-1, row)
            exact = packed[:, self.max_length + 3].astype(bool)
            bad = np.nonzero(~exact)[0]
            if bad.size:
                # blocked-Viterbi merge guard tripped: restore exactness
                # by re-decoding the flagged frames sequentially
                self.stats.viterbi_fallbacks += int(bad.size)
                packed = packed.copy()
                packed[bad] = self._redecode_exact(win, rate, flat[bad])
            payloads = packed[:, :self.max_length]
            crc_ok = packed[:, self.max_length].astype(bool)
            hdr_len = (packed[:, self.max_length + 1].astype(np.int32)
                       | (packed[:, self.max_length + 2]
                          .astype(np.int32) << 8))
            rfield = packed[:, self.max_length + 4]
            for k in range(chs.size):
                if not crc_ok[k]:
                    # reference: report + drop, keep streaming
                    # (ppdu.cpp:274-279)
                    self.stats.crc_fail += 1
                    if self.verbose:
                        print(f"Invalid CRC (length {int(hdr_len[k])})",
                              file=sys.stderr)
                    continue
                self.stats.crc_ok += 1
                n = int(hdr_len[k])
                wpkts.append(DecodedPacket(
                    payload=payloads[k, :n].tobytes(),
                    rate=(rate if isinstance(rate, Rate)
                          else self._valid_fields[int(rfield[k])]),
                    length=n,
                    start=gpos + int(starts[k]),
                    channel=int(chs[k])))
        self.stats.time_decode_s += time.perf_counter() - t1
        wpkts.sort(key=lambda p: (p.start, p.channel))
        return wpkts

    def _drain(self, force: bool) -> list[DecodedPacket]:
        """Sync finished stages past the pipeline depth; return packets.

        Stage 1 (headers) and stage 2 (payload decodes) each keep up to
        pipeline_depth supersteps in flight; results are synced when a
        queue exceeds its depth OR the device has already produced them
        (opportunistic, keeps sparse streams prompt). A decode dispatched
        while draining stage 1 is therefore fetched no earlier than the
        NEXT drain unless it is already done — decode wire time overlaps
        subsequent supersteps' compute.
        """
        keep = 0 if force else self.pipeline_depth
        while self._hdr_q and (len(self._hdr_q) > keep
                               or self._ready(self._hdr_q[0][3])):
            gpos, step_k, win, hdr = self._hdr_q.popleft()
            cap = self._capacity(step_k)
            n_hdr = cap if self.params.header_slots is None \
                else max(2, min(self.params.header_slots, cap))
            t0 = time.perf_counter()
            hs = np.asarray(hdr)[: self.channels * 6 * n_hdr]
            hs = hs.reshape(self.channels, 6, n_hdr)
            if n_hdr < cap and int(hs[:, 5, 1].max()) > n_hdr:
                # more detection events than the header budget: re-run
                # the full-capacity pass on the (still-live) window
                self.stats.header_overflows += 1
                full = _build_headers_full_fn(
                    step_k, cap, self.params, self.channels,
                    self.cfo_correct, self.window, self.halo)(
                    win[0], win[1])
                hs = np.asarray(full)[: self.channels * 6 * cap]
                hs = hs.reshape(self.channels, 6, cap)
            self.stats.time_headers_s += time.perf_counter() - t0
            jobs: list = []
            sel_chs, sel_starts, sel_fields = [], [], []
            for ch in range(self.channels):
                h = hs[ch]
                starts = h[0]
                valid = h[1].astype(bool)
                fields = h[2]
                lengths = h[3]
                header_ok = h[4].astype(bool)
                dropped = int(h[5, 0])
                if dropped:
                    # blocked-extractor per-block cap overflowed:
                    # `dropped` events never reached the slot list
                    self.stats.detect_dropped += dropped
                    if self.verbose:
                        print(f"Detection events dropped ({dropped})",
                              file=sys.stderr)
                if int(h[5, 1]) >= cap:
                    # every detection slot of the FULL capacity filled:
                    # frames beyond it were silently missed (reference
                    # has no cap). n_detected, not the possibly
                    # header_slots-truncated valid array - a count
                    # exactly at the budget is not saturation.
                    self.stats.detect_saturated += 1
                    if self.verbose:
                        print("Detection saturated "
                              f"({cap} slots)", file=sys.stderr)
                owned = header_ok & (starts >= 0) & (starts < step_k) \
                    & (gpos + starts >= 0)
                if owned.any():
                    # dedup equal starts: a noise-fragmented plateau can
                    # emit two events resolving to the same LTS pair
                    # (ADVICE r2) — without this the same packet would be
                    # delivered twice
                    ow = np.nonzero(owned)[0]
                    _, first = np.unique(starts[ow], return_index=True)
                    if first.size != ow.size:
                        self.stats.dup_starts += ow.size - first.size
                        dup = np.ones(ow.size, bool)
                        dup[first] = False
                        owned[ow[dup]] = False
                if not owned.any():
                    continue
                self.stats.headers_ok += int(owned.sum())
                known = np.isin(fields, list(self._valid_fields)) & owned
                self.stats.unknown_rate += int((owned & ~known).sum())
                over = known & (lengths > self.max_length)
                if over.any():
                    self.stats.length_overflow += int(over.sum())
                sel = known & (lengths <= self.max_length)
                if sel.any():
                    idx = np.nonzero(sel)[0]
                    sel_chs.append(np.full(idx.size, ch, np.int32))
                    sel_starts.append(starts[idx].astype(np.int32))
                    sel_fields.append(fields[idx])
            if sel_chs:
                # ONE decode dispatch (per rate group; universal mode:
                # one total) covering every channel's frames. The decode
                # indexes window coordinates: owned-region starts sit at
                # offset window - halo - step_k (0 in fixed mode).
                off = self.window - self.halo - step_k
                self._dispatch_decodes(
                    win, np.concatenate(sel_chs),
                    np.concatenate(sel_starts),
                    np.concatenate(sel_fields), off, jobs)
            if jobs:
                self._dec_q.append((gpos, win, jobs))

        packets: list[DecodedPacket] = []
        while self._dec_q and (len(self._dec_q) > keep
                               or all(self._ready(o)
                                      for *_, o in self._dec_q[0][2])):
            # opportunistic pop requires EVERY job of the superstep ready:
            # np.asarray on an unfinished output serializes into the full
            # device queue and hits the transport's cold-fetch pathology
            # (measured 3.7 s/superstep on the all-rates config)
            gpos, win, jobs = self._dec_q.popleft()
            packets.extend(self._collect_decodes(gpos, win, jobs))
        return packets
