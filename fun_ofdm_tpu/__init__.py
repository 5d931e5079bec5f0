"""fun_ofdm_tpu: an 802.11a OFDM PHY in JAX/XLA/Pallas for NVIDIA GPUs.

A from-scratch reimplementation of the capabilities of the C++/USRP
reference `bmorgan5/fun_ofdm` as pure, batched, shardable array programs:
the full TX chain (PLCP header, scrambler, K=7 convolutional code,
puncturing, interleaving, BPSK..QAM64, 64-pt IFFT + CP, preamble) and RX
chain (STS autocorrelation detect, LTS timing sync, FFT, channel
estimation, pilot phase tracking, soft Viterbi, CRC-32) - plus channel
impairment simulation and multi-chip sharding the reference never had.
"""

from .rates import Rate, RateParams, params_for, from_rate_field  # noqa: F401
from .config import ChainParams, DEFAULT_PARAMS  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy top-level facades (importing them eagerly would pull in jax
    # before host code gets a chance to configure devices/platforms).
    if name in ("Transmitter", "Receiver"):
        from . import api
        return getattr(api, name)
    if name in ("ReceiverChain", "DecodedPacket", "LoopbackRadio",
                "RadioParams", "FileSource", "FileSink"):
        from . import runtime
        return getattr(runtime, name)
    raise AttributeError(name)
