"""The on-card tier: chip_smoke.py on a GPU, and its refusal elsewhere.

chip_smoke.py runs the RX/TX main path on the card and checks the
compiled kernels against the plain references. It runs in a child
process: a JAX process reserves most of the card's memory, and this
process's own tests stay on the host CPU (tests/conftest.py).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMOKE = os.path.join(_REPO, "chip_smoke.py")


def _run_smoke(cwd, env, timeout=600, *args):
    r = subprocess.run([sys.executable, os.path.join(cwd, "chip_smoke.py"),
                        *args], capture_output=True, text=True,
                       timeout=timeout, cwd=cwd, env=env)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    return r, last


def _has_gpu() -> bool:
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return False
    return r.returncode == 0 and "GPU" in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    if not _has_gpu():
        pytest.skip("no GPU on this machine")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_PYTHON_CLIENT_PREALLOCATE",
                        "XLA_FLAGS")}
    r, last = _run_smoke(_REPO, env, 1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert json.loads(last)["ok"] is True


def test_chip_smoke_refuses_cpu():
    """With only a CPU, the smoke fails and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r, last = _run_smoke(_REPO, env, 300)
    assert r.returncode != 0
    out = json.loads(last)
    assert out["ok"] is False and "device" not in out
    assert "not a GPU" in out["error"]


def test_chip_smoke_needs_the_repo(tmp_path):
    """A directory holding chip_smoke.py alone cannot pass."""
    shutil.copy(_SMOKE, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r, last = _run_smoke(str(tmp_path), env, 300)
    assert r.returncode != 0
    out = json.loads(last)
    assert out["ok"] is False and "No module named" in out["error"]
