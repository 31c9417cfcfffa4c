"""Paper §VII-B quantizer-count rule: 2 quantizer pairs floor, 3 don't.

The paper's one result that validates §VI's "add a quantizer" design
rule end-to-end (``/root/reference/2310.15483v2.pdf`` §VII-B, BASELINE
Tier C): a 3-bit decoder with only Q=2 C2V quantizer pairs develops an
error floor near FER 1e-7 that the Q=3 version does not. The engines'
``phase_schedule(T, Q)`` assigns ladder phases by thirds/halves, so the
arms differ ONLY in how many (C, gamma) pairs the schedule cycles
through.

Protocol (bench (9472,8192)-class QC code, layered T=6, bc=3/bv=8,
honest post-§33 semantics):

- q3: the shipped DDE-designed 3-pair ladder (2.65-3.09-5.38 @1.3) —
  its no-floor deep curve to 2e-8 is already measured (RESULTS §27);
  re-measured here on the same grid as q2 for a same-harness contrast.
- q2: a 2-pair ladder designed by the same honest pipeline
  (``iterate_refine`` on the bench protograph, layered, CN-only).
- deep FER 6.0..7.8 dB step 0.2, 50 errors or 1e9 frames per point —
  at ~600k cw/s a 5e8-frame point is ~15 min, so the 1e-7..1e-8 regime
  is directly reachable. If a q2 floor appears, diagnose it with
  ``design.find_trapping_sets`` + ``sim.estimate_trapping_floor``
  (the experiments/floor_is.py harness).

    python experiments/quantizer_count.py --phase design   # CPU
    python experiments/quantizer_count.py --phase deep     # GPU

PBRL arms (--phase design13 / deep13): the bench QC code turns out NOT
to exercise the rule — protograph DE shows both pair counts converge to
numeric zero at every T (no floor to flip), and MC agrees to ~1e-9. The
code where the quantizer budget genuinely binds is the precoded PBRL at
rate 1/3: its ~46 degree-1 IR columns are channel-limited whenever a
C2V lands in the CN dead zone, so the (C, gamma) schedule must cover
both the early small-message regime and the late dead-zone-sensitive
regime — with only 2 pairs the schedule cannot, with 3 it can (the
round-4 floor-mode refine opens a sub-1e-7 DE window at ~0.6 dB).
design13 designs a 2-pair ladder with the SAME floor-aware iterated
refine used for the 3-pair arm (fair budget comparison); deep13
measures both to deep FER on the real graph.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T, BC, BV = 6, 3, 8
LIFT = 256
Q3_CN = ((2.6474, 1.3), (3.0869, 1.3), (5.3767, 1.3))  # bench DDE ladder
VQP = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
DESIGN_PATH = "experiments/quantizer_count_design.json"
CK_DIR = "experiments/quantizer_count_ck"
OUT = "experiments/quantizer_count_results.json"


def bench_base():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(5, 37))


def design(max_passes: int = 4, verbose: bool = True):
    """CPU: 2-pair CN ladder for the bench protograph, honest refine.

    Seed = the DDE ladder's outer pair (first, last): the schedule
    splits T=6 into halves, so pair 1 covers iterations 0-2 (early,
    small messages) and pair 2 covers 3-5 (converged, large)."""
    from ldpc_tpu.design import iterate_refine

    hist = iterate_refine(
        bench_base(), ((2.6474, 1.3), (5.3767, 1.3)), VQP, bc=BC, bv=BV,
        max_iterations=T, snr_db=None, schedule="layered",
        max_passes=max_passes, min_gain_db=0.01, grid_step=1 / 32,
        sweep=(0.6, 0.8, 0.9, 1.1, 1.25, 1.6), verbose=verbose)
    out = hist.to_dict()
    with open(DESIGN_PATH, "w") as f:
        json.dump(out, f, indent=2)
    print(f"q2 design: best pass {hist.best.index} "
          f"thr {hist.best.threshold_db:.3f} ({hist.stopped_by})",
          flush=True)
    return out


def _mk(arm):
    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    base = bench_base()
    code = ldpc_tpu.create_qc_code(base, lift=LIFT, max_iterations=T)
    qc = build_qc_graph(base, LIFT)
    fused = dict(fused=True, batch_tile=64, dtype=jnp.bfloat16,
                 lean=True, natural=True)
    if jax.default_backend() == "cpu":
        fused = dict(fused=True, batch_tile=16, dtype=jnp.float32,
                     interpret=True, lean=True)
    if arm == "rcq-q3":
        qp = Q3_CN
    elif arm == "rcq-q2":
        d = json.load(open(DESIGN_PATH))
        qp = tuple(tuple(x) for x in d["passes"][d["best_index"]]["cn"])
    else:
        raise ValueError(arm)
    return ldpc_tpu.make_decoder(
        code, kind="rcq", bc=BC, bv=BV, quantizer_params=qp,
        v2c_quantizer_params=VQP, max_iterations=T, qc=qc, layered=True,
        qc_options=dict(fused)), code


PBRL_DESIGN = "experiments/quantizer_count_design13.json"
PBRL_T, PBRL_BC, PBRL_BV = 10, 4, 8


def _pbrl13():
    import ldpc_tpu
    return ldpc_tpu.create_pbrl_qc_protograph(
        k=1032, rate=1 / 3, lift=43, precode=True, core_rate=8 / 9)


def design13(max_passes: int = 6, verbose: bool = True):
    """CPU: 2-pair CN ladder for the precoded PBRL rate-1/3 graph, same
    floor-aware refine as the 3-pair arm (pbrl_rates design_13); seed =
    the 3-pair seed's outer pairs at the same scale."""
    from ldpc_tpu.design import iterate_refine

    base, lift, punct = _pbrl13()
    hist = iterate_refine(
        base, ((6.797, 1.3), (6.5867, 1.3)), VQP, bc=PBRL_BC, bv=PBRL_BV,
        max_iterations=PBRL_T, snr_db=None, schedule="layered",
        punctured_cols=punct, max_passes=max_passes, min_gain_db=0.01,
        grid_step=1 / 8, sweep=(0.5, 0.7, 0.9, 1.1, 1.4, 2.0),
        verbose=verbose)
    out = hist.to_dict()
    with open(PBRL_DESIGN, "w") as f:
        json.dump(out, f, indent=2)
    b = hist.best
    print(f"pbrl13 2-pair design: best pass {b.index} thr "
          f"{b.threshold_db:.3f} floor {b.de_floor} ({hist.stopped_by})",
          flush=True)
    return out


def _mk13(arm):
    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    base, lift, punct = _pbrl13()
    code = ldpc_tpu.create_qc_code(base, lift=lift,
                                   max_iterations=PBRL_T)
    qc = build_qc_graph(base, lift)
    punct_bits = tuple(range(lift * punct[0], lift * (punct[0] + 1)))
    fused = dict(fused=True, batch_tile=None, dtype=jnp.bfloat16)
    if jax.default_backend() == "cpu":
        fused = dict(fused, interpret=True, dtype=jnp.float32)
    # both arms use their floor-POLISHED ladders (same design budget:
    # knee-anchored refine + 2 floor-polish passes each)
    if arm == "p3":   # the 3-pair designed arm (pbrl_rates rate-13)
        p = json.load(open(
            "experiments/pbrl_rates_design_13_polish.json"))
    elif arm == "p2":
        p = json.load(open(
            "experiments/quantizer_count_design13_polish.json"))
    else:
        raise ValueError(arm)
    qp = tuple(tuple(x) for x in p["cn"])
    dec = ldpc_tpu.make_decoder(
        code, kind="rcq", bc=PBRL_BC, bv=PBRL_BV, quantizer_params=qp,
        v2c_quantizer_params=VQP, max_iterations=PBRL_T, qc=qc,
        layered=True, qc_options=dict(fused))
    return dec, punct_bits


def deep13(arms=("p2", "p3"), snr_lo=1.4, snr_hi=3.6, snr_step=0.2,
           errors=100, frames=5 * 10 ** 7, verbose=True):
    """GPU: deep FER of the 2-pair vs 3-pair designed arms on the
    precoded PBRL rate-1/3 code (the §VII-B floor-flip regime)."""
    from ldpc_tpu.sim import SimulationConfig, simulate_single_snr

    out_path = "experiments/quantizer_count13_results.json"
    results = {}
    if os.path.exists(out_path):
        results = json.load(open(out_path))
    for arm in arms:
        dec, punct_bits = _mk13(arm)
        pts = results.setdefault(arm, {})
        snr = snr_lo
        while snr <= snr_hi + 1e-9:
            key = f"{snr:.1f}"
            if key not in pts:
                cfg = SimulationConfig(
                    snr_range=(snr, snr), max_frames=frames,
                    max_errors=errors, min_frames=65536,
                    wave_size=98304, early_exit_iters=5,
                    survivor_budget=4096,
                    punctured_positions=punct_bits, save_results=False)
                fer, ber, it, nf, ne = simulate_single_snr(dec, snr, cfg)
                pts[key] = {"fer": fer, "frames": nf, "errors": ne}
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=2)
                if verbose:
                    print(f"pbrl13/{arm} @ {snr:.1f}: FER {fer:.3e} "
                          f"({ne}/{nf})", flush=True)
            # break on cached zero-error points too, so resumed runs
            # stop at the same scan extent as fresh ones
            if pts[key]["errors"] == 0:
                break
            snr = round(snr + snr_step, 10)
    return results


def deep(arms=("rcq-q2", "rcq-q3"), snr_lo=6.0, snr_hi=7.8,
         snr_step=0.2, errors=50, frames=10 ** 9, verbose=True):
    from ldpc_tpu.sim import SimulationConfig, simulate_single_snr

    os.makedirs(CK_DIR, exist_ok=True)
    results = {}
    if os.path.exists(OUT):
        results = json.load(open(OUT))
    for arm in arms:
        dec, code = _mk(arm)
        pts = results.setdefault(arm, {})
        snr = snr_lo
        while snr <= snr_hi + 1e-9:
            key = f"{snr:.1f}"
            if key not in pts:
                cfg = SimulationConfig(
                    snr_range=(snr, snr), max_frames=frames,
                    max_errors=errors, min_frames=65536,
                    wave_size=32768, early_exit_iters=3,
                    survivor_budget=4096, save_results=False)
                fer, ber, it, nf, ne = simulate_single_snr(dec, snr, cfg)
                pts[key] = {"fer": fer, "frames": nf, "errors": ne}
                with open(OUT, "w") as f:
                    json.dump(results, f, indent=2)
                if verbose:
                    print(f"{arm} @ {snr:.1f}: FER {fer:.3e} ({ne}/{nf})",
                          flush=True)
            if pts[key]["errors"] == 0:
                break
            snr = round(snr + snr_step, 10)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["design", "deep", "design13",
                                        "deep13"], required=True)
    ap.add_argument("--errors", type=int, default=50)
    ap.add_argument("--frames", type=int, default=10 ** 9)
    ap.add_argument("--arms", nargs="+", default=None,
                    help="deep13 arms (default: p2 p3)")
    args = ap.parse_args()

    if args.phase in ("design", "design13"):
        import jax
        jax.config.update("jax_platforms", "cpu")
        design() if args.phase == "design" else design13()
    else:
        from ldpc_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()
        import logging
        logging.basicConfig(level=logging.INFO, force=True)
        if args.phase == "deep":
            deep(errors=args.errors, frames=args.frames)
        else:
            deep13(arms=tuple(args.arms or ("p2", "p3")),
                   errors=args.errors,
                   frames=min(args.frames, 5 * 10 ** 7))
