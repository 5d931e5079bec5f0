#!/usr/bin/env python3
"""Generate the BER/PER-vs-SNR baseline artifact (docs/BER.md + ber_data.json).

The reference never published error-rate curves (SURVEY.md section 6); this
establishes the statistical baseline for the rebuilt PHY: PER and BER vs
SNR for all 11 rates under AWGN (frame-synchronous mode), the full
detect+decode chain for representative rates, and CFO/multipath impairment
configs (BASELINE config 3).

Usage: python tools/ber_baseline.py [--frames N] [--length L] [--fast]
Writes docs/ber_data.json (raw counters) and docs/BER.md (tables).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=512,
                    help="frames per SNR point (sync mode)")
    ap.add_argument("--length", type=int, default=200, help="payload bytes")
    ap.add_argument("--fast", action="store_true",
                    help="small smoke config (CI)")
    args = ap.parse_args()

    from fun_ofdm_tpu.rates import ALL_RATES, Rate, params_for
    from fun_ofdm_tpu.sim import ber
    from fun_ofdm_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    frames = 64 if args.fast else args.frames
    length = args.length
    snr_all = list(range(0, 26, 2))
    if args.fast:
        snr_all = [0, 6, 12, 18, 24]

    data = {"length": length, "frames_per_point": frames,
            "snr_db": snr_all, "curves": []}

    t_start = time.time()

    # 1. AWGN, frame-synchronous, all 11 rates
    for rate in ALL_RATES:
        t0 = time.time()
        r = ber.error_rates(rate, length, snr_all, n_frames=frames)
        data["curves"].append({
            "mode": "sync", "channel": "awgn", "rate": rate.name,
            "per": r.per.tolist(), "ber": r.ber.tolist(),
            "n_frames": r.n_frames,
        })
        print(f"sync awgn {rate.name:20s} {time.time()-t0:6.1f}s "
              f"per@{snr_all[-1]}dB={r.per[-1]:.4f}", flush=True)

    # 2. full detect+decode chain, representative rates
    det_rates = [Rate.RATE_1_2_BPSK, Rate.RATE_3_4_QAM16, Rate.RATE_3_4_QAM64]
    det_snr = [4, 8, 12, 16, 20, 24] if not args.fast else [8, 16, 24]
    det_frames = max(frames // 2, 64)
    for rate in det_rates:
        t0 = time.time()
        r = ber.error_rates(rate, length, det_snr, n_frames=det_frames,
                            detect=True)
        data["curves"].append({
            "mode": "detect", "channel": "awgn", "rate": rate.name,
            "snr_db": det_snr, "per": r.per.tolist(),
            "n_frames": r.n_frames,
        })
        print(f"detect awgn {rate.name:18s} {time.time()-t0:6.1f}s "
              f"per@{det_snr[-1]}dB={r.per[-1]:.4f}", flush=True)

    # 3. impairments at the reference sim's rate (RATE_3_4_QAM16):
    #    residual CFO (fraction of subcarrier spacing) and 2-tap multipath
    imp_rate = Rate.RATE_3_4_QAM16
    imp_snr = snr_all
    for name, kw in [
        ("cfo", dict(cfo_norm=2e-4, cfo_correct=True)),
        ("multipath", dict(taps=(1.0, 0.25 + 0.15j))),
        ("cfo+multipath", dict(cfo_norm=2e-4, cfo_correct=True,
                               taps=(1.0, 0.25 + 0.15j))),
    ]:
        t0 = time.time()
        r = ber.error_rates(imp_rate, length, imp_snr, n_frames=frames, **kw)
        data["curves"].append({
            "mode": "sync", "channel": name, "rate": imp_rate.name,
            "per": r.per.tolist(), "ber": r.ber.tolist(),
            "n_frames": r.n_frames,
        })
        print(f"sync {name:14s} {imp_rate.name:14s} {time.time()-t0:6.1f}s "
              f"per@{imp_snr[-1]}dB={r.per[-1]:.4f}", flush=True)

    data["elapsed_s"] = time.time() - t_start

    os.makedirs(os.path.join(_REPO, "docs"), exist_ok=True)
    with open(os.path.join(_REPO, "docs", "ber_data.json"), "w") as f:
        json.dump(data, f, indent=1)

    write_markdown(data)
    print(f"done in {data['elapsed_s']:.0f}s -> docs/BER.md", flush=True)
    return 0


def write_markdown(data: dict) -> None:
    lines = [
        "# BER / PER baseline",
        "",
        "Statistical baseline of this 802.11a PHY under synthetic",
        "channels (the reference publishes no curves of its own - SURVEY.md",
        "section 6). Generated by `tools/ber_baseline.py`; raw counters in",
        "`docs/ber_data.json`; waterfall plot by `tools/ber_plot.py`:",
        "",
        "![BER/PER waterfall curves](ber_curves.png)",
        "",
        f"- payload length: {data['length']} bytes",
        f"- frames per SNR point: {data['frames_per_point']} (sync mode)",
        "- channel SNR: AWGN Es/N0 per complex sample",
        "- `sync` mode: decode at the known frame offset (codec chain)",
        "- `detect` mode: full STS/LTS detection + decode (delivery PER,",
        "  includes missed detections)",
        "",
    ]
    snr_all = data["snr_db"]

    sync_awgn = [c for c in data["curves"]
                 if c["mode"] == "sync" and c["channel"] == "awgn"]
    lines += ["## PER vs SNR - AWGN, frame-synchronous, all rates", "",
              "| rate | " + " | ".join(f"{s} dB" for s in snr_all) + " |",
              "|---|" + "---|" * len(snr_all)]
    for c in sync_awgn:
        lines.append("| " + c["rate"] + " | "
                     + " | ".join(f"{p:.3g}" for p in c["per"]) + " |")
    lines += ["", "## BER vs SNR - AWGN, frame-synchronous", "",
              "| rate | " + " | ".join(f"{s} dB" for s in snr_all) + " |",
              "|---|" + "---|" * len(snr_all)]
    for c in sync_awgn:
        lines.append("| " + c["rate"] + " | "
                     + " | ".join(f"{b:.2e}" for b in c["ber"]) + " |")

    det = [c for c in data["curves"] if c["mode"] == "detect"]
    if det:
        dsnr = det[0]["snr_db"]
        lines += ["", "## PER vs SNR - full detect+decode chain", "",
                  "| rate | " + " | ".join(f"{s} dB" for s in dsnr) + " |",
                  "|---|" + "---|" * len(dsnr)]
        for c in det:
            lines.append("| " + c["rate"] + " | "
                         + " | ".join(f"{p:.3g}" for p in c["per"]) + " |")

    imp = [c for c in data["curves"]
           if c["mode"] == "sync" and c["channel"] != "awgn"]
    if imp:
        lines += ["", "## PER vs SNR - impairments "
                  f"({imp[0]['rate']}; CFO 2e-4 of subcarrier spacing w/ "
                  "correction, 2-tap multipath)", "",
                  "| channel | " + " | ".join(f"{s} dB" for s in snr_all)
                  + " |",
                  "|---|" + "---|" * len(snr_all)]
        for c in imp:
            lines.append("| " + c["channel"] + " | "
                         + " | ".join(f"{p:.3g}" for p in c["per"]) + " |")
    lines.append("")

    with open(os.path.join(_REPO, "docs", "BER.md"), "w") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    sys.exit(main())
