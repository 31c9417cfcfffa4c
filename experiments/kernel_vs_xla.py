"""The whole-decode kernels against the XLA engines they replace, on one GPU,
at the bench shape (5x37 base, lift 256, bc=3 bv=8 RCQ, 32768 frames at
7.0 dB, bf16).

- bench program: the {3, 6} two-checkpoint decode of ``bench.build()``
  with the layered kernel, against the same program on the XLA layered
  engine (``qc_decode_batch_layered``); windows run kernel, XLA, XLA,
  kernel so that clock drift shows as a difference between repeats;
- stage 1 alone: the layered kernel at T=3 over the whole batch;
- flooding T=6: ``qc_fused_decode_batch`` against
  ``qc_decode_batch(check_every=6)``.

Prints the card's name and power limit, then one JSON line per
measurement (milliseconds per 32768-frame wave, median over windows).

    python experiments/kernel_vs_xla.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPS = 10   # waves per timed window


def _window(fn, llrs):
    import jax

    t0 = time.perf_counter()
    outs = [fn(llrs[i % len(llrs)]) for i in range(REPS)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / REPS, outs


def _report(name, fn, llrs, windows=3):
    """Compile on the first wave, then ``windows`` timed windows."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(llrs[0]))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(windows):
        dt, outs = _window(fn, llrs)
        times.append(dt)
    return dict(name=name, compile_s=compile_s,
                ms_per_wave=[t * 1e3 for t in times],
                median_ms=statistics.median(times) * 1e3), outs


def main():
    import jax
    import jax.numpy as jnp

    import bench
    from ldpc_tpu.channel import awgn_llr
    from ldpc_tpu.decode.early_exit import make_two_checkpoint_decoder
    from ldpc_tpu.decode.pallas_fused import (qc_fused_decode_batch,
                                              qc_fused_decode_batch_layered)
    from ldpc_tpu.decode.qc_engine import qc_decode_batch

    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_vs_xla.py times the kernels on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    code, dec, two_ck = bench.build()
    xla_dec = dataclasses.replace(dec, qc_options=dict(dtype=jnp.bfloat16))
    xla_two_ck = make_two_checkpoint_decoder(xla_dec, t1=bench.T1,
                                             survivor_budget=bench.S)
    llrs = [awgn_llr(k, jnp.zeros((bench.B, code.n), jnp.float32),
                     bench.SNR_DB)
            for k in jax.random.split(jax.random.PRNGKey(0), 3)]

    def program(tc):
        @jax.jit
        def wave(llr):
            out, n_surv = tc(llr)
            return jnp.sum(jnp.any(out.bits != 0, axis=1)), n_surv
        return wave

    kernel_wave, xla_wave = program(two_ck), program(xla_two_ck)
    for i, (name, fn) in enumerate((("bench_program_kernel", kernel_wave),
                                    ("bench_program_xla", xla_wave),
                                    ("bench_program_xla", xla_wave),
                                    ("bench_program_kernel", kernel_wave))):
        row, outs = _report(name, fn, llrs, windows=1)
        row["frame_errors"] = [int(o[0]) for o in outs]
        row["survivors_max"] = max(int(o[1]) for o in outs)
        assert row["survivors_max"] <= bench.S, row
        row["cw_per_s"] = bench.B / row["median_ms"] * 1e3
        print(json.dumps(row), flush=True)

    W, qc, spec = dec.weights, dec.qc, dec.spec
    stage1 = jax.jit(lambda x: qc_fused_decode_batch_layered(
        x, W, qc=qc, spec=spec, max_iterations=bench.T1,
        dtype=jnp.bfloat16, lean=True).success)
    flood_kernel = jax.jit(lambda x: qc_fused_decode_batch(
        x, W, qc=qc, spec=spec, max_iterations=bench.T,
        dtype=jnp.bfloat16, lean=True).success)
    flood_xla = jax.jit(lambda x: qc_decode_batch(
        x, W, qc=qc, spec=spec, max_iterations=bench.T,
        check_every=bench.T, dtype=jnp.bfloat16).success)
    for name, fn in (("stage1_kernel_layered_T3", stage1),
                     ("flooding_kernel_T6", flood_kernel),
                     ("flooding_xla_T6_check6", flood_xla)):
        row, outs = _report(name, fn, llrs)
        row["successes"] = int(outs[0].sum())
        print(json.dumps(row), flush=True)
    print(json.dumps({"peak_bytes": jax.devices()[0].memory_stats().get(
        "peak_bytes_in_use")}), flush=True)


if __name__ == "__main__":
    main()
