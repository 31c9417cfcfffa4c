"""Deep-FER campaign: push the (9472, 8192)-class QC code to FER 1e-5/1e-6.

The paper's quantization claims live in the deep-FER regime — §VII-B
reports NO error floor above FER 1e-7 for 3-bit W-OMS-RCQ (its 2-quantizer
variant floors at 1e-7; ``README.md:304``). Round-1 measurements stopped
at ~1e-3 because full-depth Monte-Carlo at 1e-6 costs ~1e8 frames/point.
This campaign combines the round-2 throughput machinery to make that
affordable:

- LAYERED fused decoding at T=6 (measured strictly better FER than
  10-iteration flooding at the operating points, docs/RESULTS.md) with
  the selected 2-4-6@1.3 quantizer ladder;
- two-checkpoint fused compaction ({T1, T} syndrome schedule): stage 1
  decodes everyone for T1 layered iterations in the whole-decode kernel,
  survivors re-decode at full depth. T1=3 (measured survivor fractions:
  38% at 6.4 dB, 4.7% at 6.6 dB for T1=3; T1=2 leaves >90% unconverged
  and constantly overflows into the exact two-pass fallback — correct
  but slower);
- uniform (gamma=1) bv=8 internal quantizer (the closed form with no transcendentals;
  +0.001 dB vs the power-law ladder, accuracy_bc3 results);
- resumable per-SNR checkpoints (JSON; rerun the script to continue).

    python experiments/deep_fer.py [--frames 100000000] [--errors 100]
                                   [--weights experiments/orcq_bc3_ck]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(frames: int = 5 * 10 ** 7, errors: int = 100, lift: int = 256,
        wave: int = 32768, snr_lo: float = 6.4, snr_hi: float = 6.7,
        snr_step: float = 0.1, weights_ck: str | None = None,
        out_path: str = "experiments/deep_fer_results.json",
        verbose: bool = True):
    from ldpc_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    # surface the simulator's per-point + heartbeat logger.info lines (the
    # campaign launcher's staleness watchdog keys off log growth)
    logging.basicConfig(level=logging.INFO, force=True)

    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.sim import LDPCSimulator, SimulationConfig
    from ldpc_tpu.utils.checkpoint import load_checkpoint

    rng = np.random.default_rng(0)
    base = rng.integers(0, lift, size=(5, 37))  # the bench protograph
    qc = build_qc_graph(base, lift)
    qp = ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3))     # selected ladder
    vqp = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))   # uniform bv=8
    fused = dict(fused=True, batch_tile=64, dtype=jnp.bfloat16)

    code6 = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=6)
    code10 = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=10)
    zoo6 = {
        "RCQ-bc3-L6": ldpc_tpu.make_decoder(
            code6, kind="rcq", bc=3, bv=8, quantizer_params=qp,
            v2c_quantizer_params=vqp, max_iterations=6, qc=qc,
            layered=True, qc_options=fused),
        "RCQ-bc4-L6": ldpc_tpu.make_decoder(
            code6, kind="rcq", bc=4, bv=8, quantizer_params=qp,
            v2c_quantizer_params=vqp, max_iterations=6, qc=qc,
            layered=True, qc_options=fused),
        "float-MS-L6": ldpc_tpu.make_decoder(
            code6, kind="ms", max_iterations=6, qc=qc, layered=True,
            qc_options=fused),
    }
    zoo10 = {}
    if weights_ck and os.path.exists(weights_ck):
        w = load_checkpoint(weights_ck)
        dec = ldpc_tpu.make_decoder(
            code10, kind="orcq", bc=3, bv=8, sharing_type=2,
            quantizer_params=qp, v2c_quantizer_params=vqp,
            max_iterations=10, qc=qc, qc_options=fused)
        dec.weights = {k: jnp.asarray(v) for k, v in w.items()}
        zoo10["W-OMS-RCQ-bc3-trained"] = dec
        if verbose:
            print(f"loaded trained weights from {weights_ck}", flush=True)

    def cfg(t1):
        return SimulationConfig(
            snr_range=(snr_lo, snr_hi), snr_step=snr_step,
            max_frames=frames, max_errors=errors,
            min_frames=min(wave * 4, frames), wave_size=wave,
            early_exit_iters=t1, survivor_budget=max(64, wave // 16),
            stage1_batch_tile=64, save_results=False)

    os.makedirs("experiments/deep_fer_ck", exist_ok=True)
    results = {}
    for t1, zoo in ((3, zoo6), (5, zoo10)):
        sim = LDPCSimulator(cfg(t1))
        for name, dec in zoo.items():
            ck = f"experiments/deep_fer_ck/{name}.json"
            results[name] = sim.simulate_decoder(dec, name, verbose=verbose,
                                                 checkpoint=ck)

    report = {
        "code": f"QC({code6.n},{code6.k}) lift={lift}; layered T=6 "
                "(trained decoder: flooding T=10), {2,T}-checkpoint "
                "compaction, uniform bv=8, ladder 2-4-6@1.3",
        "frames_cap": frames, "errors_target": errors,
        "curves": {k: r.to_dict() for k, r in results.items()},
    }
    # error-floor verdict: slope of log10(FER) per dB over the last points
    for name, r in results.items():
        fer = np.asarray(r.frame_error_rates, float)
        snr = np.asarray(r.snr_values, float)
        ok = fer > 0
        verdict = "insufficient data"
        if ok.sum() >= 3:
            lf = np.log10(fer[ok])
            s = np.diff(lf) / np.diff(snr[ok])
            # a floor shows as the slope collapsing toward 0 at the tail
            verdict = ("floor suspected" if len(s) >= 2 and
                       abs(s[-1]) < 0.3 * abs(s[0]) else "no floor observed")
        report.setdefault("floor_verdicts", {})[name] = {
            "verdict": verdict,
            "min_fer_measured": float(fer[ok].min()) if ok.any() else None,
        }
        if verbose:
            print(f"{name}: {verdict} "
                  f"(min FER {report['floor_verdicts'][name]['min_fer_measured']})",
                  flush=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--wave", type=int, default=32768)
    ap.add_argument("--snr-lo", type=float, default=6.4)
    ap.add_argument("--snr-hi", type=float, default=6.7)
    ap.add_argument("--snr-step", type=float, default=0.1)
    ap.add_argument("--weights", default="experiments/orcq_bc3_ck")
    ap.add_argument("--out", default="experiments/deep_fer_results.json")
    args = ap.parse_args()
    run(args.frames, args.errors, wave=args.wave, snr_lo=args.snr_lo,
        snr_hi=args.snr_hi, snr_step=args.snr_step,
        weights_ck=args.weights, out_path=args.out)
