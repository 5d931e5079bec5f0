"""Examples as CI: the reference's examples/ directory is its de-facto
acceptance suite (SURVEY.md section 4); run ours the same way.

Each CLI is executed as a real subprocess (import side effects, arg
parsing, exit codes all covered) on small configurations. The sim mirrors
the reference `sim` binary's output contract ("Received N packets",
reference examples/test_sim.cpp:101-103).
"""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, *args: str, timeout: int = 600):
    env = dict(os.environ)
    # run the device code on the host CPU backend (tests must not depend
    # on GPU access)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, os.path.join(_REPO, "examples", script), *args],
        capture_output=True, text=True, timeout=timeout, cwd=_REPO, env=env)


@pytest.mark.slow
def test_sim_example_small():
    r = _run("sim.py", "--count", "5", "--length", "200", "--pad", "2000")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Received 5 packets" in r.stdout, r.stdout + r.stderr


@pytest.mark.slow
def test_sim_example_with_awgn():
    r = _run("sim.py", "--count", "3", "--length", "100",
             "--rate", "RATE_1_2_QPSK", "--snr", "20", "--pad", "2000")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Received 3 packets" in r.stdout, r.stdout + r.stderr


@pytest.mark.slow
def test_tx_rx_examples_via_file(tmp_path):
    cap = str(tmp_path / "capture.c64")
    t = _run("tx.py", cap, "--count", "4", "--length", "150",
             "--rate", "RATE_3_4_QAM16")
    assert t.returncode == 0, t.stdout + t.stderr
    r = _run("rx.py", cap, "--rate", "RATE_3_4_QAM16",
             "--max-length", "150")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Received 4 packets" in r.stdout, r.stdout + r.stderr


@pytest.mark.slow
def test_transceiver_example():
    r = _run("transceiver.py", "--count", "3")
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.slow
def test_capture_example_anyrate(tmp_path):
    """Batch capture decode CLI: frames recorded at one rate decode with
    zero rate configuration (universal any-rate path)."""
    cap = str(tmp_path / "capture.c64")
    t = _run("tx.py", cap, "--count", "3", "--length", "120",
             "--rate", "RATE_2_3_QAM64")
    assert t.returncode == 0, t.stdout + t.stderr
    r = _run("capture.py", cap, "--max-length", "120")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Received 3 packets" in r.stdout, r.stdout + r.stderr
    assert "RATE_2_3_QAM64" in r.stdout


@pytest.mark.slow
def test_tx_rx_examples_via_udp_two_processes():
    """The reference's flagship demo is two SEPARATE machines running
    test_tx / test_rx over the air (README.md:299-311); radio-free
    equivalent: examples/rx.py listening on UDP and examples/tx.py
    streaming to it from another OS process, >90% delivery (the
    reference's own health bar)."""
    import socket as _socket

    s = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    rx_proc = subprocess.Popen(
        [sys.executable, os.path.join(_REPO, "examples", "rx.py"),
         f"udp://127.0.0.1:{port}", "--rate", "RATE_1_2_QPSK",
         "--max-length", "200", "--quiet"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=_REPO, env=env)
    try:
        import time as _time
        _time.sleep(3)  # let the listener bind + receiver warm up
        t = _run("tx.py", f"udp://127.0.0.1:{port}", "--count", "10",
                 "--length", "150", "--rate", "RATE_1_2_QPSK",
                 "--gap", "3000", "--pace")
        assert t.returncode == 0, t.stdout + t.stderr
        out, err = rx_proc.communicate(timeout=300)
    finally:
        if rx_proc.poll() is None:
            rx_proc.kill()
            rx_proc.communicate()
    assert rx_proc.returncode == 0, out + err
    got = int(out.split("Received ")[1].split(" packets")[0])
    assert got >= 9, out + err  # >90% of 10
