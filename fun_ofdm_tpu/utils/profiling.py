"""Profiling helpers: device traces + host stage timing.

The reference's only profiling is ad-hoc per-block wall-clock timing with a
commented-out over-budget warning (src/receiver_chain.cpp:84-92) and the
sim's elapsed-time print (examples/test_sim.cpp:99-103). Here:

  * device_trace(): context manager around jax.profiler.trace — captures an
    XLA device trace viewable in TensorBoard/Perfetto (the real per-kernel
    timeline the reference never had);
  * Timer: tiny named wall-clock accumulator for host-side harness loops;
  * ReceiverChain.stats carries per-pass device-call timings already.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


@contextlib.contextmanager
def device_trace(log_dir: str, host_tracer_level: int = 2):
    """Capture a jax.profiler trace into log_dir (TensorBoard format)."""
    import jax

    jax.profiler.start_trace(log_dir, host_tracer_level=host_tracer_level)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Named wall-clock accumulator: with timer("fft"): ..., then .report()."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{k}: {v * 1e3:.3f} ms total / {self.counts[k]} calls"
                 for k, v in sorted(self.totals.items())]
        return "\n".join(lines)
