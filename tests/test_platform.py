"""The one capability decision (utils/platform.py) and the compile cache
location (utils/cache.py)."""

import os

import jax
import jax.numpy as jnp
import pytest

from fun_ofdm_tpu.ops import viterbi
from fun_ofdm_tpu.rates import Rate
from fun_ofdm_tpu.runtime import chain as chain_mod
from fun_ofdm_tpu.runtime.chain import DECODE_BUCKETS, ReceiverChain
from fun_ofdm_tpu.utils import cache, platform


@pytest.fixture
def fake_gpu(monkeypatch):
    monkeypatch.setattr(platform, "default_platform", lambda: "gpu")


def test_cpu_runs_the_scan():
    assert platform.default_platform() == "cpu"
    assert not platform.on_gpu()
    assert platform.exact_viterbi() == "scan"


def test_gpu_runs_the_kernel(fake_gpu):
    assert platform.on_gpu()
    assert platform.exact_viterbi() == "triton"


@pytest.mark.parametrize("call", [
    lambda s: viterbi.viterbi_decode(s, 100, impl="triton"),
    lambda s: viterbi.viterbi_decode_blocked(s, 100, impl="triton"),
])
def test_kernel_request_without_gpu_raises(call):
    """No silent fallback: asking for the GPU kernel on the CPU fails
    instead of running the scan or the interpreter."""
    soft = jnp.zeros((1, 212), jnp.int32)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        call(soft)


def test_unknown_viterbi_impl_raises():
    with pytest.raises(ValueError, match="unknown Viterbi impl"):
        viterbi.viterbi_decode(jnp.zeros((1, 212), jnp.int32), 100,
                               impl="pallas")


def test_chain_auto_is_exact_on_cpu():
    assert all(chain_mod._impl_for_bucket("auto", b) is None
               for b in DECODE_BUCKETS)
    assert chain_mod._impl_for_bucket("exact", 4) is None
    assert chain_mod._impl_for_bucket("blocked", 1024) == "blocked"


def test_chain_auto_on_gpu_blocks_small_buckets(fake_gpu):
    got = {b: chain_mod._impl_for_bucket("auto", b) for b in DECODE_BUCKETS}
    assert got == {b: ("blocked" if b <= chain_mod.BLOCKED_MAX_BUCKET
                       else None) for b in DECODE_BUCKETS}


def test_chain_rejects_unknown_viterbi_impl():
    with pytest.raises(ValueError, match="viterbi_impl"):
        ReceiverChain(rates=(Rate.RATE_1_2_QPSK,), max_length=30,
                      viterbi_impl="pallas-blocked")


def test_chain_superstep_follows_the_platform(fake_gpu, monkeypatch):
    monkeypatch.setattr(cache, "enable_persistent_cache", lambda: None)
    ch = ReceiverChain(rates=(Rate.RATE_1_2_QPSK,), max_length=30,
                       prewarm_exact=False)
    assert ch.step >= chain_mod.AUTO_STEP_SAMPLES


def test_chain_superstep_is_one_chunk_on_cpu():
    ch = ReceiverChain(rates=(Rate.RATE_1_2_QPSK,), max_length=30)
    assert ch.strides_per_step == 1


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_into_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(repo, ".jax_cache")


def test_cache_is_off_on_cpu():
    assert cache.enable_persistent_cache() is None


@pytest.mark.parametrize("env_set", [False, True])
def test_cache_sets_no_other_dir_when_env_is_set(monkeypatch, tmp_path,
                                                 fake_gpu, env_set):
    calls = {}
    monkeypatch.setattr(cache, "_ENABLED", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(cache, "default_cache_dir",
                            lambda: str(tmp_path / "c"))
    got = cache.enable_persistent_cache()
    if env_set:
        assert got == str(tmp_path)
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert got == str(tmp_path / "c")
        assert calls["jax_compilation_cache_dir"] == str(tmp_path / "c")


def test_no_tpu_code_left():
    """Nothing reachable needs a TPU."""
    import fun_ofdm_tpu.ops as ops_pkg

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # split so that this file does not match its own patterns
    tpu = "tpu"
    bad = ("pallas." + tpu, "pl" + tpu, '== "' + tpu + '"',
           "FUN_OFDM_VITERBI_" + "RADIX", "FUN_OFDM_TPU_" + "COMPILE_CACHE")
    hits = []
    for base in ("fun_ofdm_tpu", "tools", "tests", "examples"):
        for dirpath, _, files in os.walk(os.path.join(root, base)):
            for f in files:
                if f.endswith(".py"):
                    text = open(os.path.join(dirpath, f)).read()
                    hits += [(f, b) for b in bad if b in text]
    assert not hits, hits
    assert not os.path.exists(os.path.join(
        os.path.dirname(ops_pkg.__file__), "viterbi_pallas.py"))
