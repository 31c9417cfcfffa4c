"""Close the bc=3 accuracy gap: trained W-OMS-RCQ(3,8) vs float min-sum on
the (9472, 8192)-class QC bench code.

Round-1 measured plain RCQ bc=3 at +0.157 dB and trained W-RCQ bc=3 at
+0.129 dB from float at FER 1e-2 — short of the BASELINE +-0.05 dB target.
The paper's own answer (§VII-B, Table III) is the OMS-form decoder:
W-OMS-RCQ(3,8), whose offset transform reshapes the message distribution
to fit a 3-bit quantizer far better than the multiplicative form. This
experiment:

1. picks the per-phase quantizer ranges by a small dev sweep (the
   operational stand-in for the paper's §VI quantizer design rule: choose
   the (C, gamma) ladder minimizing dev FER at the operating point);
2. trains W-OMS-RCQ(bc=3, bv=8, sharing type 2) with STE posterior-joint
   training;
3. measures the FER waterfall of float-MS / RCQ-bc3 / trained decoders on
   a fine SNR grid and reports each decoder's dB gap at FER 1e-2.

    python experiments/accuracy_bc3.py [--frames 131072] [--epochs 24]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from experiments.fer_parity import snr_at_fer  # noqa: E402


def run(frames: int = 131072, epochs: int = 24, lift: int = 256,
        out_path: str | None = "experiments/accuracy_bc3_results.json",
        verbose: bool = True):
    from ldpc_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.sim import LDPCSimulator, SimulationConfig, \
        simulate_single_snr
    from ldpc_tpu.train import PosteriorJointTrainer, TrainingConfig

    rng = np.random.default_rng(0)
    base = rng.integers(0, lift, size=(5, 37))  # the bench protograph
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=10)
    qc = build_qc_graph(base, lift)
    # evaluation decodes through the whole-decode fused kernel: each spec
    # is one compact kernel instead of a giant unrolled XLA graph
    perf = dict(fused=True, batch_tile=64, dtype=jnp.bfloat16)

    def mk(kind, qparams, **kw):
        return ldpc_tpu.make_decoder(
            code, kind=kind, bc=3, bv=8, quantizer_params=qparams,
            max_iterations=10, qc=qc, qc_options=perf, **kw)

    # -- 1. quantizer ladder selection (dev FER at the operating point) ----
    dev_cfg = SimulationConfig(snr_range=(6.4, 6.4), snr_step=1.0,
                               max_frames=16384, max_errors=10 ** 9,
                               min_frames=0, wave_size=4096, seed=7)
    ladders = {
        "3-5-7@1.3": ((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
        "2-4-6@1.3": ((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
        "4-6-8@1.3": ((4.0, 1.3), (6.0, 1.3), (8.0, 1.3)),
        "3-5-7@1.0": ((3.0, 1.0), (5.0, 1.0), (7.0, 1.0)),
        "3-5-7@1.6": ((3.0, 1.6), (5.0, 1.6), (7.0, 1.6)),
    }
    dev = {}
    for name, qp in ladders.items():
        fer = simulate_single_snr(mk("rcq", qp), 6.4, dev_cfg)[0]
        dev[name] = fer
        if verbose:
            print(f"ladder {name:11s} dev FER @6.4 dB = {fer:.4f}",
                  flush=True)
    best = min(dev, key=dev.get)
    qparams = ladders[best]
    if verbose:
        print(f"selected ladder: {best}", flush=True)

    # -- 2. train W-OMS-RCQ(3,8) and W-RCQ(3,8) ----------------------------
    trained = {}
    vqp_uni = tuple((2.0 * C, 1.0) for C, _ in qparams)
    for kind, nm in (("orcq", "W-OMS-RCQ"), ("wrcq", "W-RCQ")):
        # train with the uniform bv quantizer — the deployed (deep-FER /
        # bench) form — so train and deploy semantics match
        dec = mk(kind, qparams, sharing_type=2, v2c_quantizer_params=vqp_uni,
                 init=("nms" if kind == "wrcq" else "reference"), seed=0)
        tr = PosteriorJointTrainer(
            dec, TrainingConfig(batch_size=128, num_epochs=epochs,
                                learning_rate=2e-3, snr_range=(5.5, 7.5),
                                # at this operating point BIT accuracy is
                                # >0.99 from epoch 1 — the reference's
                                # early-stop rule would halt before any
                                # learning happens; disable it
                                early_stop_accuracy=2.0,
                                seed=0))
        hist = tr.train(num_samples=2048, verbose=verbose)
        trained[nm] = (dec, hist["training_losses"][-1])
        if verbose:
            print(f"{nm}: {len(hist['training_losses'])} epochs, "
                  f"final loss {hist['training_losses'][-1]:.5f}", flush=True)
    # persist the trained W-OMS-RCQ weights for the deep-FER campaign
    from ldpc_tpu.utils.checkpoint import save_checkpoint
    save_checkpoint("experiments/orcq_bc3_ck",
                    {k: v for k, v in trained["W-OMS-RCQ"][0].weights.items()
                     if v is not None})

    # -- 3. fine FER sweep + gaps ------------------------------------------
    cfg = SimulationConfig(snr_range=(5.75, 7.25), snr_step=0.25,
                           max_frames=frames, max_errors=2000,
                           min_frames=min(16384, frames), wave_size=8192)
    sim = LDPCSimulator(cfg)
    zoo = {
        "float-MS": ldpc_tpu.make_decoder(code, kind="ms", qc=qc,
                                          max_iterations=10,
                                          qc_options=perf),
        "RCQ-bc3-bv8": mk("rcq", qparams),
        # uniform (gamma=1) internal bv quantizer: the closed form with no transcendentals
        # (no transcendentals) — quantify its FER delta at scale
        "RCQ-bc3-bv8uni": mk("rcq", qparams,
                             v2c_quantizer_params=tuple(
                                 (2.0 * C, 1.0) for C, _ in qparams)),
        "W-OMS-RCQ-bc3-trained": trained["W-OMS-RCQ"][0],
        "W-RCQ-bc3-trained": trained["W-RCQ"][0],
    }
    results = sim.simulate_multiple_decoders(zoo, verbose=verbose)

    target = 1e-2
    base_snr = snr_at_fer(results["float-MS"].snr_values,
                          results["float-MS"].frame_error_rates, target)
    report = {
        "code": f"QC({code.n},{code.k}) lift={lift}, 10 iters, bc=3 bv=8",
        "quantizer_ladder": {"selected": best, "dev_fers": dev},
        "frames_per_point": frames,
        "target_fer": target,
        "float_ms_snr_at_target": base_snr,
        "gaps_db": {},
        "curves": {k: r.to_dict() for k, r in results.items()},
    }
    for name, r in results.items():
        s = snr_at_fer(r.snr_values, r.frame_error_rates, target)
        gap = None if (s is None or base_snr is None) else s - base_snr
        report["gaps_db"][name] = gap
        if verbose:
            print(f"{name:24s} SNR@FER1e-2 = "
                  f"{'n/a' if s is None else f'{s:.3f} dB'}"
                  f" (gap {'n/a' if gap is None else f'{gap:+.3f} dB'})",
                  flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"results -> {out_path}", flush=True)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=131072)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--lift", type=int, default=256)
    ap.add_argument("--out", default="experiments/accuracy_bc3_results.json")
    args = ap.parse_args()
    run(args.frames, args.epochs, args.lift, args.out)
