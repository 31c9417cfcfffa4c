"""SPMD Monte-Carlo: shard_map waves with per-device RNG and psum'd stats.

The mesh path used by ``ldpc_tpu.sim`` when a mesh is supplied: every
device draws its own noise (key folded with its mesh index — no cross-device
RNG traffic), decodes its local shard of the wave, and the four error
counters cross the interconnect as one fused ``psum``. Weight tables ride
replicated: shard the batch, replicate the tiny model, let XLA place the
collectives (NCCL over NVLink between the cards of one host).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ldpc_tpu.channel import awgn_llr, puncture_llr
from ldpc_tpu.decode.early_exit import onehot_select
from ldpc_tpu.decode.variants import Decoder
from ldpc_tpu.sim.montecarlo import _fuse_opts

__all__ = ["make_spmd_wave_fn", "make_spmd_compacting_wave_fn",
           "make_spmd_two_checkpoint_stats_fn"]


def make_spmd_wave_fn(decoder: Decoder, wave_size: int, mesh: Mesh,
                      axis_name: str = "batch",
                      punctured=None) -> Callable:
    """Build the jitted SPMD wave kernel:
    (key, snr_db, weights) -> (frame_errors, bit_errors, iter_sum,
    success_count) — replicated scalars summed across the mesh.

    ``wave_size`` is the GLOBAL wave; each device decodes
    ``wave_size // mesh.size`` frames. All-zero codewords (the simulator's
    ground truth, ``simulation_framework.py:107``).
    """
    n_dev = mesh.size
    if wave_size % n_dev:
        raise ValueError(f"wave_size {wave_size} not divisible by "
                         f"{n_dev} devices")
    per_dev = wave_size // n_dev
    n = decoder.code.n

    def device_wave(key, snr_db, weights):
        # independent noise per device: fold the mesh position into the key
        key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        llr = awgn_llr(key, jnp.zeros((per_dev, n), jnp.float32), snr_db)
        if punctured is not None:
            llr = puncture_llr(llr, punctured)
        # Decoder.__call__ dispatches to the right engine (general /
        # QC roll / layered QC / bucketed / fused Pallas kernel) exactly
        # as on one chip — shard_map wraps the same per-device program,
        # so the fused whole-decode kernel scales across the mesh too
        out = decoder(llr, weights)
        wrong = jnp.sum(out.bits, axis=-1)
        local = (jnp.sum(wrong > 0), jnp.sum(wrong),
                 jnp.sum(out.iterations), jnp.sum(out.success))
        return tuple(jax.lax.psum(s, axis_name) for s in local)

    sharded = shard_map(
        device_wave, mesh=mesh,
        in_specs=(P(), P(), P()),       # key, snr, weights all replicated
        out_specs=(P(), P(), P(), P()),  # psum'd scalars, replicated
        check_vma=False,
    )
    return jax.jit(sharded)


def make_spmd_compacting_wave_fn(decoder: Decoder, wave_size: int,
                                 early_iters: int, survivor_budget: int,
                                 mesh: Mesh, axis_name: str = "batch",
                                 stage1_fused: bool = False,
                                 stage1_batch_tile: int | None = None,
                                 punctured=None) -> Callable:
    """SPMD early-termination compaction: every device compacts its own
    shard locally (truncated decode -> cumsum-ranked one-hot-matmul
    survivor extraction -> full-depth re-decode), stats cross the mesh as
    one psum. No survivor data ever crosses the interconnect — compaction
    is embarrassingly local, the answer to the reference's total absence
    of parallel simulation (SURVEY §2c).

    Per-device survivor overflow falls back to a full-depth decode of that
    device's whole shard via ``lax.cond`` (device-local, still exact), so
    the host contract stays the plain 4-scalar wave — unlike the
    single-chip path, no host round-trip is needed for the fallback.

    ``survivor_budget`` is the GLOBAL budget; each device keeps
    ``survivor_budget // mesh.size`` slots.
    """
    import dataclasses as _dc

    n_dev = mesh.size
    if wave_size % n_dev or survivor_budget % n_dev:
        raise ValueError(
            f"wave_size {wave_size} and survivor_budget {survivor_budget} "
            f"must be divisible by {n_dev} devices")
    per_dev = wave_size // n_dev
    S = max(1, survivor_budget // n_dev)
    n = decoder.code.n
    T1 = early_iters
    ce = (decoder.qc_options or {}).get("check_every")
    if ce and early_iters % ce:
        raise ValueError(
            f"early_iters={early_iters} must be a multiple of the "
            f"decoder's check_every={ce} (freezing equivalence)")
    short = decoder.truncated(early_iters)
    if stage1_fused:
        if decoder.qc is None or ce != T1:
            raise ValueError("stage1_fused needs a QC decoder with "
                             "check_every == early_iters")
        short = _dc.replace(short, qc_options=_fuse_opts(
            short.qc_options or {}, stage1_batch_tile))

    def _cut(w):
        return jax.tree_util.tree_map(lambda a: a[:T1], w)

    def _stats(bits, iters, success, mask):
        wrong = jnp.sum(bits, axis=-1)
        return (jnp.sum((wrong > 0) & mask),
                jnp.sum(jnp.where(mask, wrong, 0)),
                jnp.sum(jnp.where(mask, iters, 0)),
                jnp.sum(success & mask))

    def device_wave(key, snr_db, weights):
        key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
        llr = awgn_llr(key, jnp.zeros((per_dev, n), jnp.float32), snr_db)
        if punctured is not None:
            llr = puncture_llr(llr, punctured)
        out1 = short(llr, _cut(weights))
        conv = out1.success
        fe, be, it, sc = _stats(out1.bits, out1.iterations, conv, conv)
        n_surv = per_dev - sc

        def compacted(_):
            unconv = ~conv
            rank = jnp.cumsum(unconv.astype(jnp.int32)) - 1
            sel = ((rank[None, :] == jnp.arange(S)[:, None]) &
                   unconv[None, :]).astype(jnp.float32)
            out2 = decoder(onehot_select(sel, llr), weights)
            valid = jnp.arange(S) < n_surv
            fe2, be2, it2, sc2 = _stats(out2.bits, out2.iterations,
                                        out2.success, valid)
            return fe + fe2, be + be2, it + it2, sc + sc2

        def fallback(_):
            outf = decoder(llr, weights)
            ones = jnp.ones((per_dev,), bool)
            return _stats(outf.bits, outf.iterations, outf.success, ones)

        local = jax.lax.cond(n_surv <= S, compacted, fallback, None)
        return tuple(jax.lax.psum(s, axis_name) for s in local)

    sharded = shard_map(
        device_wave, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_spmd_two_checkpoint_stats_fn(decoder: Decoder, *, t1: int,
                                      survivor_budget: int, mesh: Mesh,
                                      axis_name: str = "batch") -> Callable:
    """The SHIPPED BENCH PROGRAM on the mesh: the exact {t1, T}
    two-checkpoint construction (``decode.early_exit.
    make_two_checkpoint_decoder`` — fused stage-1 at t1 iterations,
    one-hot-matmul survivor compaction, full-depth stage 2) dispatched
    per device under ``shard_map`` over a BATCH-SHARDED llr tensor.

    ``survivor_budget`` is PER DEVICE (compaction is embarrassingly
    local; nothing but the five stat scalars crosses the interconnect).
    Returns ``fn(llr, weights) -> (frame_errors, bit_errors, iter_sum,
    successes, n_survivors)``, each psum'd over the mesh — bit-equal to
    the single-device two-checkpoint decode of the same llr batch when
    no device overflows its budget (tests/test_parallel.py).
    """
    from ldpc_tpu.decode.early_exit import make_two_checkpoint_decoder

    two_ck = make_two_checkpoint_decoder(decoder,
                                         t1=t1,
                                         survivor_budget=survivor_budget)

    def device_stats(llr, weights):
        out, n_surv = two_ck(llr, weights)
        wrong = jnp.sum(out.bits.astype(jnp.int32), axis=-1)
        stats = (jnp.sum(wrong > 0), jnp.sum(wrong),
                 jnp.sum(out.iterations), jnp.sum(out.success), n_surv)
        return tuple(jax.lax.psum(s, axis_name) for s in stats)

    sharded = shard_map(
        device_stats, mesh=mesh,
        in_specs=(P(axis_name), P()),
        out_specs=(P(),) * 5,
        check_vma=False,
    )
    return jax.jit(sharded)
