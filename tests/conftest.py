import os

# 8 virtual CPU devices so sharding logic is exercised without a GPU.
# Must be set before jax import.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# On a machine with a GPU, this process must not reserve the card's memory
# (tests run on the CPU; the on-card tier runs chip_smoke.py in a child).
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import jax  # noqa: E402

# Run all test computation on the host CPU backend, even where a GPU
# backend is registered.
jax.config.update("jax_default_device", jax.devices("cpu")[0])

# Golden-parity tests compare against the reference's double-precision
# arithmetic; enable x64 so complex128 paths are real. The device path
# uses complex64/f32 explicitly and is tested that way too.
jax.config.update("jax_enable_x64", True)


def cpu_devices():
    return jax.devices("cpu")
