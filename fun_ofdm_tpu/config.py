"""Chain configuration.

Replaces the reference's compile-time #defines (frame_detector.h:12-13,
timing_sync.h:12-14, receiver.h:16) and the usrp_params struct (usrp.h:25-52)
with one frozen dataclass. Everything here is static (trace-time) config.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChainParams:
    """RX chain tuning parameters.

    Attributes:
      plateau_threshold:  normalized STS autocorrelation threshold
                          (reference PLATEAU_THRESHOLD, frame_detector.h:12).
      sts_plateau_length: consecutive above-threshold samples before a
                          plateau is declared (STS_PLATEAU_LENGTH).
      lts_corr_threshold: normalized LTS cross-correlation peak threshold
                          (LTS_CORR_THRESHOLD, timing_sync.h:12).
      sts_length:         autocorrelation lag / window (STS period).
      lts_search:         samples after an STS end in which to search for
                          LTS peaks. The reference searches
                          CARRYOVER_LENGTH - LTS_LENGTH = 96 positions
                          (timing_sync.cpp:75), but that geometry misses
                          any frame whose STS plateau persists to the
                          final STS sample: the second LTS peak then sits
                          exactly one sample past the window, and earlier
                          noise-induced plateau breaks push it further
                          out (measured 73/256 frames lost at 16 dB SNR,
                          1/256 at 24 dB). Default 128 closes the boundary
                          (1/256 at 16 dB, 0 above);
                          set 96 for reference-parity behavior.
      lts_segments:       LTS matched-filter segmentation for
                          CFO-tolerant timing sync. 1 (default) = the
                          reference's fully coherent 64-tap correlation;
                          4 = four 16-tap sub-correlations magnitude-
                          combined, keeping detection alive out to
                          ~+-1/32 cycles/sample of carrier offset (a
                          coherent correlation collapses past ~3e-3).
                          Pair with cfo_correct=True on the chain (the
                          coarse+fine estimator cascade covers the same
                          range, models/rx.estimate_cfo_p).
      chunk_size:         streaming chunk length (NUM_RX_SAMPLES,
                          receiver.h:16). This is the frame-ownership and
                          feed granularity; device work is batched into
                          supersteps of strides_per_step chunks.
      max_frames_per_chunk: detection capacity per chunk in the streaming
                          receiver (fixed shapes under jit).
                          None (default) = auto-size from the chunk length
                          and the shortest decodable frame, so back-to-back
                          minimal frames can never exceed the slot count.
      strides_per_step:   chunks batched into ONE device dispatch + ONE
                          result fetch by the streaming receiver. Each
                          host<->device transaction has a fixed cost, so
                          throughput scales with chunk_size *
                          strides_per_step until ingest bandwidth caps
                          it. None (default) = auto: ~2^20 samples per
                          superstep on a GPU, 1 chunk on the CPU (tests /
                          latency-parity). Delivery latency grows with
                          the superstep: chunk_size * strides_per_step
                          samples of stream time.
      header_slots:       SIGNAL-decode budget per superstep. None
                          (default) = decode a header for every
                          detection slot (worst-case capacity). A tuned
                          pipeline can set the expected frame count plus
                          margin: header compute then scales with real
                          frame density, and the rare superstep whose
                          detection count exceeds the budget transparently
                          re-runs a full-capacity header pass
                          (stats.header_overflows counts them) - nothing
                          is ever lost.
      latency_target_ms:  adaptive-superstep delivery-latency target.
                          None (default) = fixed supersteps of
                          strides_per_step chunks (max throughput). Set
                          (e.g. 50.0) = the chain dispatches a FULL
                          superstep whenever that much input is pending,
                          but a sparse/idle stream is flushed to the
                          device in smaller ladder dispatches once the
                          oldest pending sample is ~half the target old,
                          so delivery approaches the transport's
                          round-trip floor instead of waiting out a
                          2^20-sample superstep (the reference delivers
                          per 4096-chunk, src/receiver.cpp:42-58).
                          Works for single- and multi-channel chains.
      min_frame_samples:  shortest frame the detection capacity must
                          accommodate. None (default) = the shortest
                          frame any configured rate can produce (the
                          exact no-silent-drop bound). A tuned pipeline
                          that only carries, say, 1500-byte frames can
                          raise this to shrink the per-superstep header
                          capacity (SIGNAL decodes scale with slot
                          count); overflow is still observable via
                          stats.detect_saturated.
    """

    plateau_threshold: float = 0.9
    sts_plateau_length: int = 16
    lts_corr_threshold: float = 0.9
    sts_length: int = 16
    lts_search: int = 128
    lts_segments: int = 1
    chunk_size: int = 4096
    max_frames_per_chunk: int | None = None
    strides_per_step: int | None = None
    min_frame_samples: int | None = None
    latency_target_ms: float | None = None
    header_slots: int | None = None


DEFAULT_PARAMS = ChainParams()
