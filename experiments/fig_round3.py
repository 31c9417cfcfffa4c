"""Round-3 figure: the quantizer design loop, measured (real MC data).

Two panels (separate y-scales would never share one chart):
  A — precoded PBRL (3096,1032): hand 4-bit vs designed(+trained) 4-bit
      vs designed 5-bit vs the 6-bit OMS anchor (RESULTS 20a/25/26).
  B — bench QC(9472,8192): hand ladder vs DDE ladder vs trained-on-DDE
      (RESULTS 11/23/27).

All points are 100-error (or noted) hardware Monte-Carlo measurements —
no synthetic curves (contrast: the reference's committed figures,
SURVEY §8.6). Colors: the dataviz reference categorical palette, fixed
slot order per entity.

    python experiments/fig_round3.py

RETRACTED (2026-08-20): panel A's quantized-arm curves (wrcq-ref3,
rcq-ref3it) were measured with the dead-zone decision bias and are
retracted — see docs/RESULTS.md §33/§33a. The generator is kept for
history; do not regenerate panel A from the biased JSONs. Panel B
(bench code, small-reach bv ladders) stands. An honest round-4 figure
replaces this once the post-fix campaign lands.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

C1, C2, C3, C4 = "#2a78d6", "#eb6834", "#1baf7a", "#eda100"
SURFACE, INK, INK2 = "#fcfcfb", "#0b0b0b", "#52514e"


def curve(path, name):
    d = json.load(open(path))["curves"][name]
    return d["snr_values"], d["frame_error_rates"]


def main(out="images/design_loop_fer.png"):
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.6), dpi=150)
    fig.patch.set_facecolor(SURFACE)

    # -- panel A: precoded PBRL ------------------------------------------
    s_hand, f_hand = curve("experiments/pbrl_precode_results.json",
                           "precoded-bc4-T10")
    s_w, f_w = curve("experiments/pbrl_wrcq_deep.json", "wrcq-ref3")
    # iterated refine (RESULTS §31) + deepened OMS anchor, if measured
    final = "experiments/pbrl_wrcq_deep_final.json"
    if os.path.exists(final):
        s_i, f_i = curve(final, "rcq-ref3it")
        s_oms, f_oms = curve(final, "oms6")
    else:  # fall back to the per-arm checkpoint + round-2 anchor
        d = json.load(open("experiments/pbrl_wrcq_ck/deep/rcq-ref3it.json"))
        s_i, f_i = d["snr_values"][:len(d["frame_error_rates"])], \
            d["frame_error_rates"]
        s_oms, f_oms = curve("experiments/pbrl_precode_results.json",
                             "precoded-oms6-T10")
        # the round-2 anchor starts at 2.6 dB; prepend the measured
        # 2.0-2.4 dB deep anchor points (100/88 errors) so the anchor
        # covers the crossover region (ADVICE r3 item 3)
        deep_oms = "experiments/pbrl_wrcq_ck/deep/oms6.json"
        if os.path.exists(deep_oms):
            d2 = json.load(open(deep_oms))
            s2 = d2["snr_values"][:len(d2["frame_error_rates"])]
            pre = [(s, f) for s, f in zip(s2, d2["frame_error_rates"])
                   if s < min(s_oms)]
            s_oms = [s for s, _ in pre] + list(s_oms)
            f_oms = [f for _, f in pre] + list(f_oms)
    # drop zero-FER tail points (0 errors) from the OMS anchor
    pts = [(s, f) for s, f in zip(s_oms, f_oms) if f > 0]
    s_oms, f_oms = zip(*pts)

    for s, f, c, lab in (
            (s_hand, f_hand, C1, "4-bit RCQ, hand ladder"),
            (s_w, f_w, C2, "4-bit W-RCQ, designed+trained (1 pass)"),
            (s_i, f_i, C3, "4-bit RCQ, iterated design (3 passes)"),
            (s_oms, f_oms, C4, "6-bit OMS anchor")):
        ax1.semilogy(s, f, "-o", color=c, lw=2, ms=5, label=lab)
    ax1.set_title("A — precoded PBRL (3096, 1032), layered T=10",
                  color=INK, fontsize=10)
    ax1.set_xlabel("Eb/N0 (dB)")
    ax1.set_ylabel("FER")
    ax1.legend(fontsize=8, framealpha=0)

    # -- panel B: bench QC code ------------------------------------------
    s_h, f_h = curve("experiments/deep_fer_results.json", "RCQ-bc3-L6")
    s_d, f_d = curve("experiments/bench_dde_results.json", "RCQ-dde-L6")
    s_t, f_t = curve("experiments/bench_dde_results.json", "W-ORCQ-dde-L6")
    for s, f, c, lab in (
            (s_h, f_h, C1, "3-bit RCQ, hand ladder (r2)"),
            (s_d, f_d, C2, "3-bit RCQ, DDE ladder (bench)"),
            (s_t, f_t, C3, "3-bit W-RCQ, trained on DDE")):
        ax2.semilogy(s, f, "-o", color=c, lw=2, ms=5, label=lab)
    ax2.set_title("B — bench QC (9472, 8192), layered T=6",
                  color=INK, fontsize=10)
    ax2.set_xlabel("Eb/N0 (dB)")
    ax2.legend(fontsize=8, framealpha=0)

    for ax in (ax1, ax2):
        ax.set_facecolor(SURFACE)
        ax.grid(True, which="major", lw=0.5, color="#e4e3df")
        ax.grid(True, which="minor", lw=0.25, color="#efeeea")
        for sp in ax.spines.values():
            sp.set_color(INK2)
        ax.tick_params(colors=INK2, labelsize=8)

    fig.suptitle("The \u00a7VI design loop "
                 "(100-error or frame-capped Monte-Carlo points)", color=INK, fontsize=11)
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    os.makedirs("images", exist_ok=True)
    fig.savefig(out, facecolor=SURFACE)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
