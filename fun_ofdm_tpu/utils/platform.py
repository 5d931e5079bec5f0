"""The one place that decides what the device can run.

`jax.default_backend()` reports the highest-priority registered backend,
which stays "gpu" even when computation has been pinned to the host CPU
via `jax.config.update("jax_default_device", ...)` (the test rig and the
multi-device dry run do exactly that). Decisions that depend on where
arrays will actually live use the *effective* platform of the default
device instead.

There are two cases: a CUDA GPU, where the Viterbi decode runs the Triton
kernel (ops/viterbi_triton.py) and the streaming chain sizes supersteps
for the device, and everything else, which runs the plain lax.scan
decoder at the reference's chunk cadence.
"""

from __future__ import annotations


def default_platform() -> str:
    """Platform name ("cpu"/"gpu") of the device new arrays land on."""
    import jax

    dev = jax.config.jax_default_device
    platform = getattr(dev, "platform", None)
    if platform is not None:
        return platform
    return jax.default_backend()


def on_gpu() -> bool:
    """True where new arrays land on a GPU."""
    return default_platform() == "gpu"


def exact_viterbi() -> str:
    """The exact Viterbi decoder for this platform: "triton" on a GPU,
    "scan" elsewhere."""
    return "triton" if on_gpu() else "scan"


def require_gpu(what: str) -> None:
    """Raise where there is no GPU: a GPU-only path is never replaced by
    the scan or the Pallas interpreter behind the caller's back."""
    if not on_gpu():
        raise RuntimeError(
            f"{what} needs a GPU, but arrays land on "
            f"{default_platform()!r}")
