"""Free V2C bits: bv=10/12 uniform internal ladders on the precoded
PBRL graph.

§26 localized the remaining 4-bit-vs-OMS gap to a shallow quantized-arm
slope and exonerated near-zero resolution as implemented by POWER
ladders (they regress 7x — the uniform ladder's coarse first step is a
beneficial dead-zone). The remaining suspect is the uniform step SIZE
at reach ~300-400: bv=8 gives steps of 1.4-3.1. The uniform qdq
is closed-form (round+clip — `ldpc_tpu.quantizer.uniform_qdq`), so its
cost is bit-width independent: bv=10/12 are FREE here, unlike on the
paper's FPGA where bv sets datapath width. Arms hold the refined CN
ladder (§25) and raise bv.

    python experiments/pbrl_bv10.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CN_REF3 = ((8.4963, 1.3), (12.108, 1.3), (12.108, 1.3))
VQP_REF3 = ((182.5928, 1.0), (315.3076, 1.0), (394.1345, 1.0))


def main(frames=2 * 10 ** 7, errors=100, snrs=(2.0, 2.4),
         out_path="experiments/pbrl_bv10_results.json"):
    from ldpc_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import logging
    logging.basicConfig(level=logging.INFO, force=True)

    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.sim import SimulationConfig, simulate_single_snr

    base, lift, punct_cols = ldpc_tpu.create_pbrl_qc_protograph(
        k=1032, rate=1 / 3, precode=True)
    qc = build_qc_graph(base, lift)
    T = 10
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    punct_bits = tuple(range(lift * punct_cols[0],
                             lift * (punct_cols[0] + 1)))
    fused = dict(fused=True, batch_tile=None, dtype=jnp.bfloat16)
    if jax.default_backend() == "cpu":
        fused = dict(fused, interpret=True, dtype=jnp.float32)

    def mk(bv, bc=4):
        return ldpc_tpu.make_decoder(
            code, kind="rcq", bc=bc, bv=bv, quantizer_params=CN_REF3,
            v2c_quantizer_params=VQP_REF3, max_iterations=T, qc=qc,
            layered=True, closed_qdq=(bc >= 5), qc_options=dict(fused))

    arms = {
        "bc4_bv10": mk(10),
        "bc4_bv12": mk(12),
        "bc5_bv10": mk(10, bc=5),
    }

    results = {}
    for name, dec in arms.items():
        results[name] = {}
        for snr in snrs:
            cfg = SimulationConfig(
                snr_range=(snr, snr), max_frames=frames,
                max_errors=errors, min_frames=65536, wave_size=32768,
                early_exit_iters=5, survivor_budget=4096,
                punctured_positions=punct_bits, save_results=False)
            fer, ber, avg_it, nf, ne = simulate_single_snr(dec, snr, cfg)
            results[name][str(snr)] = {"fer": fer, "frames": nf,
                                       "errors": ne}
            print(f"{name:10s} @ {snr} dB: FER {fer:.3e} "
                  f"({ne} errs / {nf} frames)", flush=True)

    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return results


if __name__ == "__main__":
    main()
