"""Quantify the §16 floor semi-analytically: importance-sampled failure
probability of the enumerated absorbing-set classes.

§16 MEASURED the random QC PBRL rate-1/3 code flooring at FER ~1e-4
(bc=4, ladder 6-11-16@1.3, layered T=10); §19 NAMED the candidate
structures ((8,1)x17, (6,2)x26 absorbing classes, plus big (7,2)/(8,2)
families). This script closes the quantitative loop: mean-shift IS
(``ldpc_tpu.sim.importance``) estimates each class's localized-failure
probability under the ACTUAL bc=4 decoder at the measured floor SNRs,
and the union bound

    FER_floor ~ sum_class multiplicity x p_class

is compared against the measured curve. The precoded graph's top
classes are estimated for contrast (prediction: orders lower).

Caveats (documented, standard for the method): the greedy enumeration
gives LOWER-bound multiplicities; localized indicators under-count
failures that spill one bit outside the set; p is exemplar-based
(exact for QC orbits, approximate across same-(a,b) non-orbit sets —
class probability spread is reported via per-exemplar sampling when
``--exemplars`` > 1).

    python experiments/floor_is.py [--samples 32768]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QP = ((6.0, 1.3), (11.0, 1.3), (16.0, 1.3))
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))


def main(samples=2 ** 15, exemplars=3, shift=1.6,
         snrs=(3.2, 3.6, 4.0), n_classes=4,
         out_path="experiments/floor_is_results.json"):
    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.design import find_trapping_sets
    from ldpc_tpu.sim import estimate_trapping_floor

    T = 10
    results = {}

    def build(precode):
        punct = None
        if precode:
            B, L, pc = ldpc_tpu.create_pbrl_qc_protograph(
                k=1032, rate=1 / 3, precode=True)
            # the precode column is NEVER transmitted: the IS channel must
            # puncture it exactly as the measured system does
            punct = tuple(range(L * pc[0], L * (pc[0] + 1)))
        else:
            B, L = ldpc_tpu.create_pbrl_qc_protograph(k=1032, rate=1 / 3)
        code = ldpc_tpu.create_qc_code(B, lift=L, max_iterations=T)
        qc = build_qc_graph(B, L)
        fused = None
        if jax.default_backend() == "gpu":
            fused = dict(fused=True, batch_tile=None, dtype=jnp.bfloat16)
        dec = ldpc_tpu.make_decoder(
            code, kind="rcq", bc=4, bv=8, quantizer_params=QP,
            v2c_quantizer_params=VQP8, max_iterations=T, qc=qc,
            layered=True, qc_options=fused)
        return code, dec, punct

    base_key = jax.random.PRNGKey(20260818)
    for arm_i, (name, precode) in enumerate(
            (("random", False), ("precoded", True))):
        code, dec, punct = build(precode)
        rep = find_trapping_sets(code.H, a_max=8, b_max=3, restarts=3,
                                 max_sets=10000)
        # top classes by (b, a); several exemplars each to expose
        # within-class probability spread
        chosen = {}
        for ts in rep.sets:
            chosen.setdefault((ts.a, ts.b), []).append(ts)
        # floor relevance: ABSORBING classes first (min-sum cannot leave
        # them; a degree-1 (1,1) singleton is benign — its odd check
        # corrects it), then by (b, a). Exemplars restricted to absorbing
        # members when the class has any.
        cc = rep.class_counts()
        classes = sorted(
            chosen, key=lambda ab: (cc[ab]["absorbing"] == 0, ab[1], ab[0])
        )[:n_classes]
        for ab in classes:
            absb = [t for t in chosen[ab] if t.absorbing]
            if absb:
                chosen[ab] = absb
        results[name] = {"classes": {}}
        for snr in snrs:
            per_class = {}
            for ab in classes:
                # absorbing members dominate the floor; when the class is
                # mixed, p is measured on absorbing exemplars so the
                # multiplicity must match that subpopulation
                mult = cc[ab]["absorbing"] or cc[ab]["unique"]
                ps = []
                for i, ts in enumerate(chosen[ab][:exemplars]):
                    # deterministic, run-reproducible key (hash() of str
                    # tuples is PYTHONHASHSEED-salted)
                    k = base_key
                    for part in (arm_i, ab[0], ab[1], i):
                        k = jax.random.fold_in(k, part)
                    est = estimate_trapping_floor(
                        dec, [((ts.a, ts.b), 1, ts.variables)],
                        snr_db=snr, shift=shift, n_samples=samples,
                        batch=2 ** 11, key=k, punctured=punct)
                    (_, p, rel) = est.per_class[ab]
                    ps.append((p, rel))
                pbar = float(np.mean([p for p, _ in ps]))
                per_class[f"{ab[0]},{ab[1]}"] = dict(
                    multiplicity=int(mult), p_mean=pbar,
                    exemplars=[[float(p), float(r)] for p, r in ps],
                    contribution=mult * pbar)
                print(f"{name} @ {snr} dB class {ab} x{mult}: "
                      f"p~{pbar:.3e} -> {mult * pbar:.3e}", flush=True)
            total = sum(v["contribution"] for v in per_class.values())
            results[name]["classes"][str(snr)] = per_class
            results[name].setdefault("floor", {})[str(snr)] = total
            print(f"{name} @ {snr} dB union-bound floor ~ {total:.3e}",
                  flush=True)

    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"results -> {out_path}", flush=True)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=2 ** 15)
    ap.add_argument("--exemplars", type=int, default=3)
    ap.add_argument("--shift", type=float, default=1.6)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--snrs", type=float, nargs="+",
                    default=[3.2, 3.6, 4.0])
    ap.add_argument("--out", default="experiments/floor_is_results.json")
    args = ap.parse_args()
    main(samples=args.samples, exemplars=args.exemplars, shift=args.shift,
         n_classes=args.classes, snrs=tuple(args.snrs), out_path=args.out)
