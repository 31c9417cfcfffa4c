"""Paper §VII-C across rates: one precoded PBRL mother code, designed
4-bit RCQ vs 6-bit OMS at every rate (the last unreproduced headline).

The paper's claim (``/root/reference/2310.15483v2.pdf`` §VII-C, echoed
``README.md:304``): 4-bit rate-specific W-NMS-RCQ beats 6-bit OMS at
FER 1e-6 for a k=1032 PBRL family at rates 1/3, 1/2, 2/3, 8/9. Round 3
reproduced the ordering at ONE rate (1/3, RESULTS §31/§32) by design
alone. This experiment runs the full family the real-PBRL way:

- ONE mother structure: ``create_pbrl_qc_protograph(k=1032, lift=43,
  precode=True, core_rate=8/9)`` — lift 43 puts all four paper rates on
  the lattice, and ``core_rate`` pins the IRA core so every rate's
  protograph is EXACTLY the leading submatrix of the mother
  (tests/test_codes.py::test_pbrl_qc_family_core_rate_nesting).
- Per-rate CN-ladder design via ``design.iterate_refine`` (the §32
  converged-refine loop) on the decision-bias-fixed DE, seeded from the
  round-3 fixed point's CN ladder. V2C coordinates are decode-neutral
  in the layered schedule (RESULTS §33), so they stay at 4-8-12.
- Per-rate adaptive deep-FER scan: walk SNR upward in 0.2 dB steps
  (coarse 0.4 dB while FER > 3e-3) until each arm reaches FER <= 1e-6,
  then report SNR @ FER 1e-6 by log-linear interpolation.

Phases (design is CPU, one process per rate is safe; dev/deep are GPU —
ONE process at a time):

    python experiments/pbrl_rates.py --phase design --rates 89 23 12 13
    python experiments/pbrl_rates.py --phase deep --rates 89 [--arms ...]
    python experiments/pbrl_rates.py --phase report
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K, LIFT, CORE_RATE = 1032, 43, 8 / 9
T, BC, BV = 10, 4, 8
RATES = {"13": 1 / 3, "12": 1 / 2, "23": 2 / 3, "89": 8 / 9}
# round-3 converged refine fixed point's CN ladder (RESULTS §32). The
# V2C ladder is DECODE-NEUTRAL in the layered schedule (RESULTS §33:
# the bv qdq touches only the final posterior, which after the
# sign-preserving fix cannot change the decision), so the design loop
# tunes CN only and every arm uses the plain 4-8-12 bv ladder.
CN_SEED = ((6.797, 1.3), (7.2043, 1.3), (6.5867, 1.3))
# per-rate seed scale: channel LLRs grow as 10^(snr/10) with the
# operating Es/N0, so the rate-1/3 fixed point's reach must scale up at
# the higher rates or the initial DE threshold lands several dB high
# (first launch measured 11.2-13 dB caps at rates 1/2..8/9 unscaled)
SEED_SCALE = {"13": 1.0, "12": 1.4, "23": 2.0, "89": 4.0}
VQP8 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
VQP6 = ((4.0, 1.0), (8.0, 1.0), (12.0, 1.0))
DESIGN_PATH = "experiments/pbrl_rates_design_{tag}.json"
CK_DIR = "experiments/pbrl_rates_ck"
OUT_PATH = "experiments/pbrl_rates_results.json"
FER_TARGET = 1e-6


def family(tag):
    import ldpc_tpu
    base, lift, punct = ldpc_tpu.create_pbrl_qc_protograph(
        k=K, rate=RATES[tag], lift=LIFT, precode=True, core_rate=CORE_RATE)
    return base, lift, punct


def seed_ladders(tag: str):
    s = SEED_SCALE[tag]
    return tuple((round(c * s, 4), g) for c, g in CN_SEED), VQP8


def design(tag: str, max_passes: int = 6, grid_step: float = 1 / 16,
           verbose: bool = True):
    """CPU phase: iterated refine for one rate (parallel-safe per rate)."""
    from ldpc_tpu.design import iterate_refine

    base, lift, punct = family(tag)
    cn0, v2c0 = seed_ladders(tag)
    # the rate-1/3 grid is dominated by the deg-49 punctured column;
    # 1/8 LLR still gives ~7 grid points per CN quantizer bin
    if tag == "13":
        grid_step = max(grid_step, 1 / 8)
    hist = iterate_refine(
        base, cn0, v2c0, bc=BC, bv=BV, max_iterations=T, snr_db=None,
        schedule="layered", punctured_cols=punct, max_passes=max_passes,
        min_gain_db=0.01, grid_step=grid_step,
        sweep=(0.5, 0.7, 0.9, 1.1, 1.4, 2.0), verbose=verbose)
    out = {"rate": RATES[tag], "mb": int(base.shape[0]),
           "grid_step": grid_step, **hist.to_dict()}
    with open(DESIGN_PATH.format(tag=tag), "w") as f:
        json.dump(out, f, indent=2)
    print(f"rate {tag}: best pass {hist.best.index} "
          f"thr {hist.best.threshold_db:.3f} dB ({hist.stopped_by})",
          flush=True)
    return out


def _load_design(tag):
    with open(DESIGN_PATH.format(tag=tag)) as f:
        return json.load(f)


POLISH_PATH = "experiments/pbrl_rates_design_{tag}_polish.json"


def _best_ladder(tag):
    """The rate's operational ladder: the floor-polished one when the
    polish phase has run, else the best threshold-refine pass."""
    path = POLISH_PATH.format(tag=tag)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    d = _load_design(tag)
    return d["passes"][d["best_index"]]


def _q4_ladder(tag):
    """The rate's 4-pair ladder (pbrl_rates_q4.py): floor-clean straight
    out of threshold refine at every rate, and better DE thresholds than
    the floor-polished 3-pair ladders (§VI add-a-quantizer rule)."""
    with open(f"experiments/pbrl_rates_design_{tag}_q4.json") as f:
        return json.load(f)


def polish(tag: str, verbose: bool = True):
    """CPU phase: floor-objective polish of the threshold-designed
    ladder, anchored where its high-SNR DE floor peaks.

    Threshold refine stops at its bisection resolution and cannot see a
    deep residual floor (rate 89 measured: MC floors at ~4.9e-6 while
    the DE of the designed ladder floors at ~4.8e-9 concentrated in one
    base column — 43 bits x 1.2e-7 = the MC number). Two lexicographic
    error-descent passes at the floor's peak SNR remove it (rate 89:
    the last pair's reach 13 -> 29; late-iteration messages outgrow a
    static reach — the paper's grow-the-reach dynamic-quantizer rule)."""
    from ldpc_tpu.design.proto_dde import (
        protograph_density_evolution as de, refine_ladders_protograph)

    base, lift, punct = family(tag)
    d = _load_design(tag)
    bp = d["passes"][d["best_index"]]
    cn = tuple(tuple(x) for x in bp["cn"])
    vqp = tuple(tuple(x) for x in bp["v2c"])
    thr = bp["threshold_db"]
    if thr >= 12.9:
        # explicit None check: window_db == 0.0 dB is a legitimate
        # convergence-window bottom (rate-1/3 knees sit near 0.6 dB)
        w = bp.get("window_db")
        thr = w if w is not None else 2.0
    gs = d.get("grid_step", 1 / 16)
    kw = dict(max_iterations=T, bc=BC, bv=BV, schedule="layered",
              punctured_cols=punct, grid_step=gs)
    # probe the post-waterfall region for the residual-floor peak
    probe = []
    for off in (0.5, 1.0, 1.5, 2.0, 3.0):
        r = de(base, snr_db=thr + off, kind="rcq", quantizer_params=cn,
               v2c_quantizer_params=vqp, **kw)
        probe.append((thr + off, float(r.error_prob[-1])))
        if verbose:
            print(f"  floor probe {thr + off:.2f} dB: "
                  f"{r.error_prob[-1]:.3e}", flush=True)
    peak_snr, peak_err = max(probe, key=lambda p: p[1])
    cur, cur_v, e = cn, vqp, peak_err
    if peak_err < 1e-12:
        # already numeric-zero everywhere: polishing would chase noise
        # and can DAMAGE the waterfall (measured on the 4-pair rate-89
        # ladder: thr 6.35 -> 6.52 for a 3.5e-16 -> 2.9e-16 "gain")
        print(f"rate {tag} polish: floor already clean "
              f"({peak_err:.1e}), skipping", flush=True)
        out = {"rate": RATES[tag], "anchor_db": peak_snr,
               "pre_err": peak_err, "post_err": peak_err,
               "cn": [list(p) for p in cur],
               "v2c": [list(p) for p in cur_v]}
        with open(POLISH_PATH.format(tag=tag), "w") as f:
            json.dump(out, f, indent=2)
        return out
    for i in range(2):
        cur, cur_v, e = refine_ladders_protograph(
            base, cur, cur_v, snr_db=peak_snr, objective="floor",
            guard_snr=thr,   # don't trade waterfall for floor
            sweep=(0.6, 0.8, 0.9, 1.1, 1.25, 1.6),
            gammas=(1.0, 1.15, 1.3, 1.5, 1.8, 2.2), **kw)
        if verbose:
            print(f"  polish pass {i + 1}: err {e:.3e} cn {cur}",
                  flush=True)
    out = {"rate": RATES[tag], "anchor_db": peak_snr,
           "pre_err": peak_err, "post_err": float(e),
           "cn": [list(p) for p in cur], "v2c": [list(p) for p in cur_v]}
    with open(POLISH_PATH.format(tag=tag), "w") as f:
        json.dump(out, f, indent=2)
    print(f"rate {tag} polish: floor {peak_err:.3e} -> {e:.3e} "
          f"@ {peak_snr:.2f} dB", flush=True)
    return out


def _mk_setup(tag):
    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    base, lift, punct_cols = family(tag)
    qc = build_qc_graph(base, lift)
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    punct_bits = tuple(range(lift * punct_cols[0],
                             lift * (punct_cols[0] + 1)))
    fused = dict(fused=True, batch_tile=None, dtype=jnp.bfloat16)
    if jax.default_backend() == "cpu":
        fused = dict(fused, interpret=True, dtype=jnp.float32)

    def mk(arm):
        if arm == "oms6":   # the anchor, exactly pbrl_wrcq.py's
            dec = ldpc_tpu.make_decoder(
                code, kind="oms", sharing_type=2, bv=6,
                v2c_quantizer_params=VQP6, max_iterations=T, qc=qc,
                layered=True, qc_options=dict(fused))
            dec.weights = {"beta": jnp.full_like(dec.weights["beta"], 0.5),
                           "alpha": jnp.zeros_like(dec.weights["alpha"])}
            return dec
        if arm == "rcq-seed":
            qp, vqp = seed_ladders(tag)
        elif arm == "rcq-best":
            d = _load_design(tag)
            p = d["passes"][d["best_index"]]
            qp = tuple(tuple(x) for x in p["cn"])
            vqp = tuple(tuple(x) for x in p["v2c"])
        elif arm == "rcq-pol":             # floor-polished ladder
            with open(POLISH_PATH.format(tag=tag)) as f:
                p = json.load(f)
            qp = tuple(tuple(x) for x in p["cn"])
            vqp = tuple(tuple(x) for x in p["v2c"])
        elif arm == "rcq-pol3":            # two-point-guarded polish
            # (polish_guard_study.py: floor descent at the peak, guard
            # at threshold+0.25 dB with 10x slack — keeps the waterfall)
            with open(f"experiments/pbrl_rates_design_{tag}"
                      "_polish3.json") as f:
                p = json.load(f)
            qp = tuple(tuple(x) for x in p["cn"])
            vqp = tuple(tuple(x) for x in p["v2c"])
        elif arm in ("rcq-q4", "rcq-q5"):  # 4/5-pair ladder (§VI rule)
            with open(f"experiments/pbrl_rates_design_{tag}"
                      f"_{arm[4:]}.json") as f:
                p = json.load(f)
            qp = tuple(tuple(x) for x in p["cn"])
            vqp = tuple(tuple(x) for x in p["v2c"])
        elif arm.startswith("rcq-p"):      # specific refine pass
            d = _load_design(tag)
            p = d["passes"][int(arm[5:])]
            qp = tuple(tuple(x) for x in p["cn"])
            vqp = tuple(tuple(x) for x in p["v2c"])
        elif arm.startswith("wrcq-"):
            # "wrcq-<tag>" = trained on the rate's best (polished)
            # ladder; "wrcq-<tag>-q4" = trained on the 4-pair ladder
            # (checkpoint orcq_<tag>_q4, written by train --ladder q4)
            from ldpc_tpu.utils.checkpoint import load_checkpoint
            per_layer = arm.endswith("pl")
            if per_layer:
                arm = arm[:-2]
            if arm.endswith("-q4"):
                p = _q4_ladder(tag)
                ck = f"{CK_DIR}/orcq_{tag}_q4"
            elif arm.endswith("-pol3"):
                with open(f"experiments/pbrl_rates_design_{tag}"
                          "_polish3.json") as f:
                    p = json.load(f)
                ck = f"{CK_DIR}/orcq_{tag}_pol3"
            else:
                p = _best_ladder(tag)
                ck = f"{CK_DIR}/orcq_{tag}"
            if per_layer:
                ck += "pl"
            qp = tuple(tuple(x) for x in p["cn"])
            vqp = tuple(tuple(x) for x in p["v2c"])
            dec = ldpc_tpu.make_decoder(
                code, kind="orcq", bc=BC, bv=BV, quantizer_params=qp,
                v2c_quantizer_params=vqp, max_iterations=T, qc=qc,
                layered=True, sharing_type=2, per_layer=per_layer,
                qc_options=dict(fused))
            dec.weights = {k: jnp.asarray(v)
                           for k, v in load_checkpoint(ck).items()}
            return dec
        else:
            raise ValueError(arm)
        return ldpc_tpu.make_decoder(
            code, kind="rcq", bc=BC, bv=BV, quantizer_params=qp,
            v2c_quantizer_params=vqp, max_iterations=T, qc=qc,
            layered=True, qc_options=dict(fused))

    return mk, punct_bits, code


def train(tag: str, epochs: int = 30, ladder: str = "best",
          per_layer: bool = False, verbose: bool = True):
    """GPU phase: rate-specific W-OMS-RCQ on the rate's designed ladder
    (the paper's rate-specific trained decoder; guide rule says run this
    only where the designed arm still trails the anchor).

    ``ladder="q4"`` trains on the 4-pair ladder instead (checkpoint
    ``orcq_<tag>_q4``, consumed by the ``wrcq-<tag>-q4`` deep arm)."""
    import jax
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.train import PosteriorJointTrainer, TrainingConfig
    from ldpc_tpu.utils.checkpoint import save_checkpoint

    _, punct_bits, _ = _mk_setup(tag)
    if ladder == "q4":
        p = _q4_ladder(tag)
        thr = p["threshold_db"]
        ck_name = f"orcq_{tag}_q4"
    elif ladder == "pol3":
        with open(f"experiments/pbrl_rates_design_{tag}"
                  "_polish3.json") as f:
            p = json.load(f)
        thr = p["threshold_db"]
        ck_name = f"orcq_{tag}_pol3"
    else:
        d = _load_design(tag)
        bp = d["passes"][d["best_index"]]
        if bp["threshold_db"] >= 12.9:
            w = bp.get("window_db")
            thr = w if w is not None else bp["threshold_db"]
        else:
            thr = bp["threshold_db"]
        p = _best_ladder(tag)   # polished ladder when available
        ck_name = f"orcq_{tag}"
    base, lift, _ = family(tag)
    fused = dict(fused=True, batch_tile=None, dtype=jnp.bfloat16)
    if jax.default_backend() == "cpu":
        fused = dict(fused, interpret=True, dtype=jnp.float32)
    if per_layer:
        ck_name += "pl"
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    dec = ldpc_tpu.make_decoder(
        code, kind="orcq", bc=BC, bv=BV,
        quantizer_params=tuple(tuple(x) for x in p["cn"]),
        v2c_quantizer_params=tuple(tuple(x) for x in p["v2c"]),
        max_iterations=T, qc=build_qc_graph(base, lift), layered=True,
        sharing_type=2, per_layer=per_layer, qc_options=dict(fused))
    steps = epochs * (2048 // 128)
    tr = PosteriorJointTrainer(dec, TrainingConfig(
        batch_size=128, num_epochs=epochs, learning_rate=2e-3,
        snr_range=(thr + 1.0, thr + 3.0), lr_schedule="cosine",
        warmup_steps=8, decay_steps=steps, early_stop_accuracy=2.0,
        seed=0, punctured_positions=punct_bits))
    h = tr.train(num_samples=2048, verbose=verbose)
    os.makedirs(CK_DIR, exist_ok=True)
    save_checkpoint(f"{CK_DIR}/{ck_name}",
                    {k: v for k, v in dec.weights.items() if v is not None})
    print(f"trained orcq rate {tag} ({ck_name}): "
          f"loss {h['training_losses'][-1]:.5f}", flush=True)
    return h


def _scan_arm(tag, arm, dec, punct_bits, snr_start, *, frames, errors,
              verbose=True):
    """Adaptive deep scan: coarse 0.4 dB walk while FER > 3e-3, then
    0.2 dB with full caps until FER <= target (or 0 errors at cap).
    Checkpoints per point; resume skips measured points."""
    from ldpc_tpu.sim import SimulationConfig, simulate_single_snr

    os.makedirs(CK_DIR, exist_ok=True)
    ck_path = f"{CK_DIR}/{tag}_{arm}.json"
    points = {}
    if os.path.exists(ck_path):
        points = json.load(open(ck_path))["points"]

    # dispatch amortization: these codes are 3-8x shorter than the bench
    # code, so a 32768-frame wave is mostly per-dispatch overhead — scale
    # the wave so each dispatch carries bench-sized work
    n_bits = dec.code.n if hasattr(dec, "code") else 3096
    wave = min(262144, 32768 * max(1, round(9472 / n_bits)))

    def measure(snr, fr, er):
        key = f"{snr:.1f}"
        if key in points:
            return points[key]
        cfg = SimulationConfig(
            snr_range=(snr, snr), max_frames=fr, max_errors=er,
            min_frames=65536, wave_size=wave, early_exit_iters=5,
            survivor_budget=4096, punctured_positions=punct_bits,
            save_results=False)
        fer, ber, avg_it, nf, ne = simulate_single_snr(dec, snr, cfg)
        points[key] = {"fer": fer, "frames": nf, "errors": ne}
        with open(ck_path, "w") as f:
            json.dump({"arm": arm, "rate_tag": tag, "points": points}, f,
                      indent=2)
        if verbose:
            print(f"{tag}/{arm} @ {snr:.1f} dB: FER {fer:.3e} "
                  f"({ne}/{nf})", flush=True)
        return points[key]

    snr = snr_start
    # if the start overshot the waterfall (DE thresholds on punctured
    # graphs can be off either way), walk DOWN until the FER is coarse
    for _ in range(12):
        p = measure(round(snr, 1), min(frames, 2 * 10 ** 6), errors)
        if p["fer"] >= 3e-4 or snr <= snr_start - 4.8:
            break
        snr -= 0.4
    # coarse walk: cheap caps, find the waterfall
    for _ in range(16):
        p = measure(round(snr, 1), min(frames, 2 * 10 ** 6), errors)
        if p["fer"] <= 3e-3:
            break
        snr += 0.4
    # fine walk to the target
    for _ in range(14):
        p = measure(round(snr, 1), frames, errors)
        if p["fer"] <= FER_TARGET or p["errors"] == 0:
            break
        snr += 0.2
    return points


def deep(tag: str, arms, snr_start=None, frames=5 * 10 ** 7,
         errors: int = 100, verbose: bool = True):
    """GPU phase: adaptive deep-FER scan of each arm at one rate."""
    mk, punct_bits, _ = _mk_setup(tag)
    if snr_start is None:
        d = _load_design(tag)
        # anchor on the BEST pass (CLAUDE.md rule): its threshold in the
        # converging regime, else its convergence-window bottom; the
        # coarse walk (both directions) finds the real waterfall
        p = d["passes"][d["best_index"]]
        cap = p["threshold_db"] >= 12.9
        w = p.get("window_db")
        snr_start = round((w if w is not None else p["threshold_db"])
                          if cap else p["threshold_db"] + 0.2, 1)
    for arm in arms:
        _scan_arm(tag, arm, mk(arm), punct_bits, snr_start,
                  frames=frames, errors=errors, verbose=verbose)


def _snr_at(points, target=FER_TARGET):
    """Log-linear interpolated SNR @ target FER from scan points."""
    pts = sorted((float(s), v["fer"]) for s, v in points.items()
                 if v["fer"] > 0)
    for (s0, f0), (s1, f1) in zip(pts, pts[1:]):
        if f0 >= target >= f1:
            return s0 + (s1 - s0) * (math.log(f0 / target)
                                     / math.log(f0 / f1))
    return None


def report(out_path=OUT_PATH):
    """Collect per-rate scans into the §VII-C table."""
    table = {}
    for tag in RATES:
        row = {}
        for fn in os.listdir(CK_DIR) if os.path.isdir(CK_DIR) else []:
            if fn.startswith(f"{tag}_") and fn.endswith(".json"):
                arm = fn[len(tag) + 1:-5]
                pts = json.load(open(f"{CK_DIR}/{fn}"))["points"]
                row[arm] = {"points": pts, "snr_at_1e-6": _snr_at(pts)}
        if row:
            anchor = row.get("oms6", {}).get("snr_at_1e-6")
            for arm, r in row.items():
                if anchor and r["snr_at_1e-6"]:
                    r["gap_vs_oms6_db"] = round(r["snr_at_1e-6"] - anchor,
                                                3)
            table[tag] = {"rate": RATES[tag], "arms": row}
    with open(out_path, "w") as f:
        json.dump(table, f, indent=2)
    for tag, t in table.items():
        for arm, r in t["arms"].items():
            print(f"rate {tag} {arm:10s}: SNR@1e-6 = {r['snr_at_1e-6']} "
                  f"gap {r.get('gap_vs_oms6_db')}", flush=True)
    return table


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["design", "polish", "train",
                                        "deep", "report"], required=True)
    ap.add_argument("--rates", nargs="+", default=["89", "23", "12", "13"])
    ap.add_argument("--arms", nargs="+", default=["oms6", "rcq-best"])
    ap.add_argument("--frames", type=int, default=5 * 10 ** 7)
    ap.add_argument("--errors", type=int, default=100)
    ap.add_argument("--max-passes", type=int, default=6)
    ap.add_argument("--snr-start", type=float, default=None)
    ap.add_argument("--ladder", choices=["best", "q4", "pol3"],
                    default="best")
    ap.add_argument("--per-layer", action="store_true",
                    help="per-layer weight buckets (checkpoint *pl; "
                         "deep arm suffix ...pl)")
    args = ap.parse_args()

    if args.phase != "design":
        from ldpc_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()
        import logging
        logging.basicConfig(level=logging.INFO, force=True)

    if args.phase == "design":
        import jax
        jax.config.update("jax_platforms", "cpu")
        for tag in args.rates:
            design(tag, max_passes=args.max_passes)
    elif args.phase == "polish":
        import jax
        jax.config.update("jax_platforms", "cpu")
        for tag in args.rates:
            polish(tag)
    elif args.phase == "train":
        for tag in args.rates:
            train(tag, ladder=args.ladder, per_layer=args.per_layer)
    elif args.phase == "deep":
        for tag in args.rates:
            deep(tag, tuple(args.arms), snr_start=args.snr_start,
                 frames=args.frames, errors=args.errors)
    else:
        report()
