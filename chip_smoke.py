"""Smoke run of the decode path on NVIDIA GPUs, through the entry points a
user calls, at the bench code's full width (5x37 base, lift 256: the
paper's (9472, 8192) family).

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: phase 5 only

1. Kernel parity at bench width: the compiled layered kernel (f32)
   against the XLA layered engine on the GPU and on the CPU, and in bf16
   against the GPU engine, at one frame per program and again at the
   bench's stage-1 tile and at a tile that leaves a program part-full;
   the compiled flooding kernel against the plain numpy reference
   (``decode/oracle.py``).
2. The bench program (``bench.build``: layered T=6 RCQ, {3, 6}
   two-checkpoint early exit, S=128) for a few waves of 32768 frames at
   7.0 dB: survivor budget never exceeded, FER, cw/s, compile time.
3. One campaign point: ``LDPCSimulator`` with survivor compaction, two
   waves at 7.0 dB.
4. Three ``PosteriorJointTrainer`` steps for W-RCQ at the shape of
   ``experiments/train_wrcq_qc9472.py`` (batch 128, T=10, STE through the
   XLA QC engine): finite loss and gradient norm.
5. ``--four-cards``: the two-checkpoint decode under ``shard_map`` on a
   1-D ("batch",) mesh of four cards, whose pooled stats must equal one
   card's, and one data-parallel training step (on a smaller protograph)
   against one card's.

Each phase prints one line; any failure raises and exits non-zero. The
card's name and power limit come first; the last line of standard output,
printed only when every phase passed on a GPU, is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
PARITY_FRAMES, PARITY_SNR_DB = 256, 6.4   # ~38% of frames survive t1=3
FLOOD_FRAMES = 8
# f32 kernel vs XLA engine posteriors: the arithmetic is the same op for
# op, but Triton and XLA contract mul+add into FMAs differently, so
# posteriors agree to float rounding, not to the bit.
POST_RTOL, POST_ATOL = 1e-5, 1e-4
BF16_BIT_AGREEMENT = 0.9999
# multi-frame tiles: the bench's stage-1 tile (auto_batch_tile(bench.B))
# and 112, which splits the 256 frames 112 + 112 + 32
OTHER_TILE = 112
CAMPAIGN_WAVE, CAMPAIGN_WAVES = 32768, 2
TRAIN_STEPS = 3
DP_LOSS_RTOL = 1e-5   # data-parallel vs one-card loss: reduction order
DP_BASE = (3, 12)


def ok_line(platform: str, kind: str, count: int) -> str:
    """The contract's last line, exactly."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _progress(msg: str) -> None:
    """A progress line on stderr (stdout keeps one line per phase), so a
    run cut by a time limit shows how far it got."""
    print(msg, file=sys.stderr, flush=True)


def _syndrome_ok(H, bits) -> np.ndarray:
    """[B] all checks satisfied, on the host (f32 BLAS; counts are exact)."""
    par = (H.astype(np.float32) @ np.asarray(bits, np.float32).T) % 2
    return ~par.any(axis=0)


def phase_parity(code, dec):
    import jax
    import jax.numpy as jnp

    import bench
    from ldpc_tpu.channel import awgn_llr
    from ldpc_tpu.decode.oracle import oracle_decode
    from ldpc_tpu.decode.pallas_fused import (auto_batch_tile,
                                              qc_fused_decode_batch,
                                              qc_fused_decode_batch_layered)
    from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered

    qc, spec, W, T = dec.qc, dec.spec, dec.weights, dec.max_iterations
    llr = awgn_llr(jax.random.PRNGKey(SEED),
                   jnp.zeros((PARITY_FRAMES, code.n), jnp.float32),
                   PARITY_SNR_DB)

    def engine(x, w, dtype):
        """Per-iteration posteriors of the XLA layered engine."""
        r = qc_decode_batch_layered(x, w, qc=qc, spec=spec,
                                    max_iterations=T, dtype=dtype,
                                    return_trajectory=True)
        return np.asarray(r.posteriors_all.astype(jnp.float32))

    t0 = time.time()
    kern = qc_fused_decode_batch_layered(llr, W, qc=qc, spec=spec,
                                         max_iterations=T, dtype=jnp.float32)
    kbits = np.asarray(kern.bits)
    ksucc = np.asarray(kern.success)
    kpost = np.asarray(kern.posterior)
    t_kernel = time.time() - t0
    with jax.default_matmul_precision("highest"):
        traj_gpu = engine(llr, W, jnp.float32)
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            traj_cpu = engine(jax.device_put(np.asarray(llr), cpu),
                              jax.device_put(W, cpu), jnp.float32)
    surv_t1 = 1.0 - _syndrome_ok(code.H, traj_gpu[2] < 0).mean()
    for where, traj in (("gpu", traj_gpu), ("cpu", traj_cpu)):
        ref_bits = (traj[-1] < 0).astype(np.int32)
        np.testing.assert_array_equal(kbits, ref_bits,
                                      err_msg=f"f32 bits vs {where} engine")
        np.testing.assert_array_equal(ksucc, _syndrome_ok(code.H, ref_bits),
                                      err_msg=f"success vs {where} engine")
        np.testing.assert_allclose(kpost, traj[-1], rtol=POST_RTOL,
                                   atol=POST_ATOL,
                                   err_msg=f"posterior vs {where} engine")

    kb = qc_fused_decode_batch_layered(llr, W, qc=qc, spec=spec,
                                       max_iterations=T, dtype=jnp.bfloat16,
                                       lean=True)
    with jax.default_matmul_precision("highest"):
        ref_b = engine(llr, W, jnp.bfloat16)[-1] < 0
    agree = float((np.asarray(kb.bits).astype(bool) == ref_b).mean())
    assert agree >= BF16_BIT_AGREEMENT, f"bf16 bit agreement {agree}"
    np.testing.assert_array_equal(np.asarray(kb.success),
                                  _syndrome_ok(code.H, ref_b),
                                  err_msg="bf16 success set")

    # Programs that decode several frames reuse their scratch behind
    # barriers; a race there would show only here, as interpret mode runs
    # in program order.
    tiles = (auto_batch_tile(bench.B), OTHER_TILE)
    for bt in tiles:
        kt = qc_fused_decode_batch_layered(llr, W, qc=qc, spec=spec,
                                           max_iterations=T,
                                           dtype=jnp.float32, batch_tile=bt)
        np.testing.assert_array_equal(np.asarray(kt.bits), kbits,
                                      err_msg=f"f32 bits, tile {bt}")
        np.testing.assert_array_equal(np.asarray(kt.success), ksucc,
                                      err_msg=f"f32 success, tile {bt}")
        np.testing.assert_allclose(np.asarray(kt.posterior), traj_gpu[-1],
                                   rtol=POST_RTOL, atol=POST_ATOL,
                                   err_msg=f"f32 posterior, tile {bt}")
        kbt = qc_fused_decode_batch_layered(llr, W, qc=qc, spec=spec,
                                            max_iterations=T,
                                            dtype=jnp.bfloat16, lean=True,
                                            batch_tile=bt)
        np.testing.assert_array_equal(np.asarray(kbt.bits),
                                      np.asarray(kb.bits),
                                      err_msg=f"bf16 bits, tile {bt}")
        np.testing.assert_array_equal(np.asarray(kbt.success),
                                      np.asarray(kb.success),
                                      err_msg=f"bf16 success, tile {bt}")

    fl = qc_fused_decode_batch(llr[:FLOOD_FRAMES], W, qc=qc, spec=spec,
                               max_iterations=T, dtype=jnp.float32)
    thr = np.asarray(spec.thresholds, np.float64)
    vthr = np.asarray(spec.v2c_thresholds, np.float64)

    def lut(table):
        def qdq(x, t):  # the LUT scan: snap |x| down to a threshold
            mag = np.abs(x)
            idx = np.maximum((mag[..., None] >= table[t]).sum(-1) - 1, 0)
            return np.where(x < 0, -1.0, 1.0) * np.maximum(table[t][idx],
                                                           1e-30)
        return qdq

    host_llr = np.asarray(llr[:FLOOD_FRAMES], np.float64)
    for b in range(FLOOD_FRAMES):
        bits, _, _, _ = oracle_decode(code.H, host_llr[b], T,
                                      transform="rcq", qdq=lut(thr),
                                      quantize_v2c=lut(vthr))
        np.testing.assert_array_equal(np.asarray(fl.bits[b]), bits,
                                      err_msg=f"flooding frame {b} vs oracle")
    print(f"phase 1 parity: layered kernel f32 == XLA engine on gpu and cpu "
          f"({PARITY_FRAMES} frames at {PARITY_SNR_DB} dB, "
          f"{surv_t1:.1%} unconverged at t1=3, {int(ksucc.sum())} decoded; "
          f"posterior rtol={POST_RTOL} atol={POST_ATOL}); bf16 bit "
          f"agreement {agree:.6f} >= {BF16_BIT_AGREEMENT}, same success set; "
          f"same f32 and bf16 results at {tiles[0]} and {tiles[1]} frames "
          f"per program; "
          f"flooding kernel f32 bits == oracle on {FLOOD_FRAMES} frames; "
          f"first kernel call {t_kernel:.1f} s", flush=True)


def phase_bench(code, two_ck):
    import jax
    import jax.numpy as jnp

    import bench
    from ldpc_tpu.channel import awgn_llr

    keys = jax.random.split(jax.random.PRNGKey(SEED + 1), 4)

    @jax.jit
    def wave(key):
        llr = awgn_llr(key, jnp.zeros((bench.B, code.n), jnp.float32),
                       bench.SNR_DB)
        out, n_surv = two_ck(llr)
        return jnp.sum(jnp.any(out.bits != 0, axis=1)), n_surv

    t0 = time.time()
    first = jax.block_until_ready(wave(keys[0]))
    compile_s = time.time() - t0
    t0 = time.time()
    rest = [wave(k) for k in keys[1:]]
    rest = [(int(fe), int(ns)) for fe, ns in rest]
    dt = time.time() - t0
    stats = [(int(first[0]), int(first[1]))] + rest
    worst = max(ns for _, ns in stats)
    assert worst <= bench.S, f"survivor budget overflow: {worst} > {bench.S}"
    fer = sum(fe for fe, _ in stats) / (len(stats) * bench.B)
    print(f"phase 2 bench program: {len(stats)} waves of {bench.B} frames "
          f"at {bench.SNR_DB} dB, FER {fer:.3e}, survivors per wave "
          f"{[ns for _, ns in stats]} <= S={bench.S}, "
          f"{len(rest) * bench.B / dt:.1f} cw/s over {len(rest)} waves "
          f"(channel included), first wave {compile_s:.1f} s with compile",
          flush=True)


def phase_campaign(dec):
    from ldpc_tpu.sim import LDPCSimulator, SimulationConfig

    import bench

    cfg = SimulationConfig(
        snr_range=(bench.SNR_DB, bench.SNR_DB), snr_step=1.0,
        max_frames=CAMPAIGN_WAVES * CAMPAIGN_WAVE, max_errors=10 ** 9,
        min_frames=0, wave_size=CAMPAIGN_WAVE, early_exit_iters=bench.T1,
        survivor_budget=4 * bench.S, save_results=False, seed=SEED)
    t0 = time.time()
    res = LDPCSimulator(cfg).simulate_decoder(dec, verbose=False)
    wall = time.time() - t0
    frames = res.total_frames[0]
    assert frames == CAMPAIGN_WAVES * CAMPAIGN_WAVE, frames
    print(f"phase 3 campaign point: {frames} frames at {bench.SNR_DB} dB, "
          f"FER {res.frame_error_rates[0]:.3e}, wall {wall:.1f} s with "
          f"compile", flush=True)


def _trainer(mesh=None, base_shape=(5, 37), unroll=True):
    """W-RCQ trainer at the shape of ``experiments/train_wrcq_qc9472.py``
    on a lift-256 protograph of ``base_shape`` (default: the bench's)."""
    import jax.numpy as jnp

    import ldpc_tpu
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.train import PosteriorJointTrainer, TrainingConfig

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=base_shape)
    code = ldpc_tpu.create_qc_code(base, lift=256, max_iterations=10)
    wrcq = ldpc_tpu.make_decoder(
        code, kind="wrcq", bc=4, sharing_type=2,
        quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
        max_iterations=10, qc=build_qc_graph(base, 256), init="nms",
        seed=SEED, qc_options=dict(check_every=10, dtype=jnp.bfloat16,
                                   unroll=unroll))
    return PosteriorJointTrainer(
        wrcq, TrainingConfig(batch_size=128, num_epochs=1,
                             learning_rate=2e-3, snr_range=(5.5, 7.5),
                             seed=SEED), mesh=mesh)


def phase_train():
    import jax

    tr = _trainer()
    key = jax.random.PRNGKey(SEED)
    t0 = time.time()
    losses = []
    for _ in range(TRAIN_STEPS):
        key, sub = jax.random.split(key)
        loss, _, gnorm = tr.train_epoch(sub, batches_per_epoch=1)
        assert np.isfinite(loss) and np.isfinite(gnorm), (loss, gnorm)
        losses.append((loss, gnorm))
    print(f"phase 4 training: {TRAIN_STEPS} W-RCQ steps (batch 128, T=10, "
          f"n=9472), (loss, grad norm) = "
          f"{[(round(a, 6), round(b, 6)) for a, b in losses]}, "
          f"{time.time() - t0:.1f} s with compile", flush=True)


def phase_four_cards(code, dec):
    import jax
    import jax.numpy as jnp

    import bench
    from ldpc_tpu.channel import awgn_llr
    from ldpc_tpu.decode.early_exit import make_two_checkpoint_decoder
    from ldpc_tpu.parallel import make_mesh, make_spmd_two_checkpoint_stats_fn

    mesh = make_mesh(4)
    llr = awgn_llr(jax.random.PRNGKey(SEED + 2),
                   jnp.zeros((bench.B, code.n), jnp.float32), bench.SNR_DB)
    t0 = time.time()
    pooled = make_spmd_two_checkpoint_stats_fn(
        dec, t1=bench.T1, survivor_budget=bench.S, mesh=mesh)(llr,
                                                              dec.weights)
    pooled = tuple(int(v) for v in pooled)
    t_spmd = time.time() - t0
    _progress(f"phase 5: four-card stats {pooled} in {t_spmd:.1f} s")
    out, n_surv = make_two_checkpoint_decoder(
        dec, t1=bench.T1, survivor_budget=4 * bench.S)(llr)
    wrong = jnp.sum(out.bits.astype(jnp.int32), axis=-1)
    single = (int(jnp.sum(wrong > 0)), int(jnp.sum(wrong)),
              int(jnp.sum(out.iterations)), int(jnp.sum(out.success)),
              int(n_surv))
    assert pooled == single, (pooled, single)
    _progress(f"phase 5: one-card stats equal, {time.time() - t0:.1f} s")

    # The data-parallel comparison trains on a 3x12 protograph at lift 256
    # with the iteration loop scanned. At the bench's 5x37 base the STE
    # step compiles for minutes on one H100 (phase 4: three steps in
    # 192.4 s, compile included; a data-parallel step had not compiled
    # after 130 s), and this phase compiles two such programs. Sharding
    # the batch does not depend on the code's size; the decode above runs
    # at the bench code and batch.
    key = jax.random.PRNGKey(SEED)
    dp_loss, _, dp_g = _trainer(mesh, DP_BASE, unroll=False).train_epoch(
        key, batches_per_epoch=1)
    _progress(f"phase 5: data-parallel step, {time.time() - t0:.1f} s")
    one_loss, _, one_g = _trainer(None, DP_BASE, unroll=False).train_epoch(
        key, batches_per_epoch=1)
    assert np.isfinite(dp_loss) and np.isfinite(dp_g)
    np.testing.assert_allclose(dp_loss, one_loss, rtol=DP_LOSS_RTOL)
    print(f"phase 5 four cards: pooled two-checkpoint stats over a 4-card "
          f"batch mesh == one card on {bench.B} frames at {bench.SNR_DB} dB "
          f"(frame errors, bit errors, iterations, successes, survivors) = "
          f"{pooled}, {t_spmd:.1f} s with compile; data-parallel training "
          f"step ({DP_BASE[0]}x{DP_BASE[1]} base, lift 256) loss "
          f"{dp_loss:.8f} vs one card {one_loss:.8f} "
          f"(rtol {DP_LOSS_RTOL})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase and its comparison")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
              f"{dev.platform}", file=sys.stderr)
        return 2
    if args.four_cards and len(jax.devices()) < 4:
        print(f"--four-cards needs 4 GPUs; JAX found {len(jax.devices())}",
              file=sys.stderr)
        return 2

    import bench
    from ldpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    for line in card_lines():
        print(f"card: {line}", flush=True)
    code, dec, two_ck = bench.build()
    if args.four_cards:
        phase_four_cards(code, dec)
    else:
        phase_parity(code, dec)
        phase_bench(code, two_ck)
        phase_campaign(dec)
        phase_train()
    print(ok_line(dev.platform, dev.device_kind, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
