"""Tighten the rate-8/9 §VII-C verdict points to ~500 errors.

The −0.022 (designed) / −0.041 (trained) dB wins over the 6-bit OMS
anchor rest on 100-error points (±10% FER, ~1σ separation at 9.2 dB).
This re-measures the deciding SNRs for all three arms at 500 errors or
2.5e8 frames (±4.5% FER), fresh seed, results kept SEPARATE from the
scan checkpoints (same harness, same graph).

    python experiments/tighten89.py      # GPU, one process
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

OUT = "experiments/tighten89_results.json"


def main():
    from ldpc_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import logging
    logging.basicConfig(level=logging.INFO, force=True)

    from pbrl_rates import _mk_setup
    from ldpc_tpu.sim import SimulationConfig, simulate_single_snr

    mk, punct_bits, code = _mk_setup("89")
    res = {}
    if os.path.exists(OUT):
        res = json.load(open(OUT))
    wave = min(262144, 32768 * max(1, round(9472 / code.n)))
    for arm in ("oms6", "rcq-pol", "wrcq-89"):
        dec = mk(arm)
        pts = res.setdefault(arm, {})
        for snr in (9.0, 9.2):
            key = f"{snr:.1f}"
            if key in pts:
                continue
            cfg = SimulationConfig(
                snr_range=(snr, snr), max_frames=250_000_000,
                max_errors=500, min_frames=65536, wave_size=wave,
                early_exit_iters=5, survivor_budget=4096,
                punctured_positions=punct_bits, save_results=False,
                seed=99)
            fer, ber, it, nf, ne = simulate_single_snr(dec, snr, cfg)
            pts[key] = {"fer": fer, "frames": nf, "errors": ne}
            with open(OUT, "w") as f:
                json.dump(res, f, indent=2)
            print(f"89/{arm} @ {snr}: FER {fer:.4e} ({ne}/{nf})",
                  flush=True)
    return res


if __name__ == "__main__":
    main()
