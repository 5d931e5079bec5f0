"""Sanity checks on the committed BER/PER baseline artifact.

The reference never published error-rate curves; docs/ber_data.json (from
tools/ber_baseline.py) is this framework's statistical baseline
(SURVEY.md section 7 step 5). These tests validate the artifact's physics
so a regenerated baseline can't silently go nonsensical: waterfall shape
(PER non-increasing with SNR), clean decoding at high SNR, and rate
robustness ordering at moderate SNR.
"""

import json
import os

import numpy as np
import pytest

_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "ber_data.json")


@pytest.fixture(scope="module")
def data():
    if not os.path.exists(_PATH):
        pytest.skip("docs/ber_data.json not generated yet")
    with open(_PATH) as f:
        return json.load(f)


def _curves(data, mode=None, channel=None):
    out = []
    for c in data["curves"]:
        if mode is not None and c["mode"] != mode:
            continue
        if channel is not None and c["channel"] != channel:
            continue
        out.append(c)
    return out


def test_artifact_covers_all_rates(data):
    from fun_ofdm_tpu.rates import ALL_RATES
    names = {c["rate"] for c in _curves(data, "sync", "awgn")}
    assert names == {r.name for r in ALL_RATES}


def test_per_waterfall_non_increasing(data):
    """PER must fall (within statistical noise) as SNR rises."""
    n = data["frames_per_point"]
    tol = 3.0 / n + 0.02  # ~3-sigma of the PER estimator + slack
    for c in _curves(data, "sync"):
        per = np.asarray(c["per"])
        rises = np.diff(per)
        assert (rises <= tol).all(), (c["rate"], c["channel"], per.tolist())


def test_high_snr_decodes_clean(data):
    """At the top of the SNR grid every sync-mode AWGN curve hits PER ~ 0."""
    for c in _curves(data, "sync", "awgn"):
        assert c["per"][-1] <= 0.01, (c["rate"], c["per"][-1])
        assert c["ber"][-1] <= 1e-4, (c["rate"], c["ber"][-1])


def test_rate_robustness_ordering(data):
    """At moderate SNR the most robust MCS (1/2-BPSK) cannot be worse than
    the least robust (3/4-QAM64) - the defining waterfall ordering."""
    snr = data["snr_db"]
    curves = {c["rate"]: np.asarray(c["per"])
              for c in _curves(data, "sync", "awgn")}
    bpsk = curves["RATE_1_2_BPSK"]
    qam64 = curves["RATE_3_4_QAM64"]
    n = data["frames_per_point"]
    tol = 3.0 / n + 0.02
    mid = [i for i, s in enumerate(snr) if 4 <= s <= 20]
    assert mid
    for i in mid:
        assert bpsk[i] <= qam64[i] + tol, (snr[i], bpsk[i], qam64[i])


def test_detect_mode_present_and_clean_at_top_snr(data):
    """Full detect+decode PER must reach exactly 0 at the top SNR point:
    the round-2 artifact floored at 1/256 from the reference-geometry
    96-sample LTS search window (fixed: ChainParams.lts_search=128);
    a recurrence means a detection regression."""
    det = _curves(data, "detect")
    assert det, "no detect-mode curves in artifact"
    for c in det:
        assert c["per"][-1] == 0.0, (c["rate"], c["per"][-1])
