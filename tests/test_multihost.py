"""Multi-host distributed test: 2 processes x 4 virtual CPU devices.

Validates the jax.distributed bring-up path (parallel/distributed.py) and
that the sharded streaming receive's halo exchange works across a process
boundary — the multi-host property the reference never had and the
BASELINE scaling target requires (SURVEY.md section 5.8).

Spawns real OS processes (the only faithful way to test
jax.distributed); each runs tests/multihost_worker.py.
"""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_sharded_receive():
    num_processes = 2
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    env.pop("JAX_PLATFORM_NAME", None)
    worker = os.path.join(_REPO, "tests", "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(num_processes), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=_REPO)
        for pid in range(num_processes)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"MULTIHOST OK process={pid}" in out, out
