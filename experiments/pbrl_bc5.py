"""Does a 5th C2V bit (or a longer schedule) lift the §16 deep-FER floor?

RESULTS §16 measured: on the QC PBRL-like (3096, 1032) rate-1/3 code
(lift 86, transmitted degree-1 IR bits), every bc=4 arm flattens below
FER ~1e-4 while unquantized-C2V OMS keeps its slope to 1e-6. §17's
protograph DE localized the pathology to the FINITE graph, not ensemble
quantization. The two candidate fixes this experiment separates
(experiments/pbrl_lift_floor.py covers the third, a bigger lift):

- **bc=5**: one more C2V magnitude bit. The unrolled staircase is 15
  compare+add pairs per message; the ``closed_qdq`` kernel option
  (decode/pallas_fused.py ``_qdq_mode``) computes the same quantizer
  index in O(1) closed form.
- **T=20**: real PBRL practice runs long schedules (T up to 50); §16 ran
  layered T=10.

Arms (all plain RCQ — no trained weights, isolating the quantizer; the
on-code ladder 6-11-16@1.3 from §16's sweep):

  bc4-T10 (the §16 floored anchor), bc5-T10, bc4-T20, bc5-T20

The OMS-6bit slope anchor is already measured in
experiments/rate_specific_deep_results.json.

    python experiments/pbrl_bc5.py [--frames 20000000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QP = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))   # §16 on-code ladder
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))


def run(frames: int = 2 * 10 ** 7, errors: int = 100,
        snr_lo: float = 2.6, snr_hi: float = 4.0, snr_step: float = 0.2,
        wave_size: int = 32768, survivor_budget: int = 4096,
        out_path: str = "experiments/pbrl_bc5_results.json",
        verbose: bool = True):
    from ldpc_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import logging
    logging.basicConfig(level=logging.INFO, force=True)

    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.sim import LDPCSimulator, SimulationConfig

    base, lift = ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3)
    qc = build_qc_graph(base, lift)

    def make(bc, T):
        code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
        fused = dict(fused=True, batch_tile=None, dtype=jnp.bfloat16,
                     closed_qdq=(bc >= 5))
        if jax.default_backend() == "cpu":
            fused = dict(fused, interpret=True, dtype=jnp.float32)
        return ldpc_tpu.make_decoder(
            code, kind="rcq", bc=bc, bv=8, quantizer_params=QP,
            v2c_quantizer_params=VQP8, max_iterations=T, qc=qc,
            layered=True, qc_options=fused)

    arms = {
        "RCQ-bc4-T10": make(4, 10),
        "RCQ-bc5-T10": make(5, 10),
        "RCQ-bc4-T20": make(4, 20),
        "RCQ-bc5-T20": make(5, 20),
    }

    cfg = SimulationConfig(
        snr_range=(snr_lo, snr_hi), snr_step=snr_step,
        max_frames=frames, max_errors=errors,
        min_frames=min(2 * wave_size, frames), wave_size=wave_size,
        early_exit_iters=5, survivor_budget=survivor_budget,
        stage1_batch_tile=None,  # auto-pick (f32-on-CPU halves the tile)
        save_results=False)
    sim = LDPCSimulator(cfg)
    os.makedirs("experiments/pbrl_bc5_ck", exist_ok=True)
    curves = {}
    for name, dec in arms.items():
        curves[name] = sim.simulate_decoder(
            dec, name, verbose=verbose,
            checkpoint=f"experiments/pbrl_bc5_ck/{name}.json")

    report = {
        "code": f"QC PBRL (3096, 1032), lift {lift}, layered, ladder "
                f"6-11-16@1.3, plain RCQ",
        "curves": {k: r.to_dict() for k, r in curves.items()},
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    if verbose:
        for name, r in curves.items():
            fer = ", ".join(f"{s:g}dB:{f:.2e}" for s, f in
                            zip(r.snr_values, r.frame_error_rates))
            print(f"{name}: {fer}", flush=True)
    print(f"results -> {out_path}", flush=True)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--out", default="experiments/pbrl_bc5_results.json")
    args = ap.parse_args()
    run(frames=args.frames, errors=args.errors, out_path=args.out)
