"""Early-termination decoding at fused-kernel speed: the two-checkpoint
decoder as a public API.

The whole-decode Pallas kernels check the syndrome once, after the final
iteration — that keeps them one kernel, but it forfeits the classic
LDPC early exit (most frames at operating SNR converge in 1-3
iterations; reference contract ``ldpc_decoder.py:79-153`` checks every
iteration). This module restores early termination WITHOUT giving up the
kernel: a **{T1, T} two-checkpoint decoder**.

1. stage 1 decodes every frame for ``t1`` iterations in the fused kernel;
   frames whose syndrome passes there are done (first-convergence
   freezing makes their output identical to a full-depth decode);
2. the (few) survivors are compacted into a fixed ``survivor_budget``-row
   batch by a cumsum-ranked one-hot matmul and re-decoded at full depth;
3. outputs are scattered back with the transposed one-hot.

The one-hot products run at ``Precision.HIGHEST``: a float32 matmul may
otherwise run in TF32 on the GPU, and the survivors would be re-decoded
on LLRs rounded to a 10-bit mantissa. One-hot selection is exact at full
precision in any float dtype.

This is the same construction the Monte-Carlo simulator uses internally
(``sim/montecarlo.py::_make_compacting_wave_fn``), packaged to return the
full merged :class:`DecodeResult` so serving paths get the ~T/t1
arithmetic saving too.

Budget overflow: with more than ``survivor_budget`` unconverged frames
(operating far below the design SNR), out-of-budget frames keep their
stage-1 output with ``success=False`` — detectable via the returned
``n_survivors`` scalar; pick the budget from the stage-1 FER at the
operating point (a few sigma above ``B * FER_t1``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ldpc_tpu.decode.engine import DecodeResult

__all__ = ["make_two_checkpoint_decoder", "onehot_select"]


def onehot_select(P, x):
    """``P @ x`` for a one-hot selection matrix, exact in any float dtype
    (full precision: no TF32 rounding of float32 operands)."""
    return jnp.matmul(P, x, precision=jax.lax.Precision.HIGHEST)


def make_two_checkpoint_decoder(decoder, *, t1: int, survivor_budget: int):
    """Build ``fn(llr, weights=None) -> (DecodeResult, n_survivors)`` with
    the {t1, T} checkpoint schedule.

    ``decoder`` should be a fused-kernel QC decoder
    (``qc_options={'fused': True, ...}``) — the configuration whose
    syndrome schedule is {T}; any Decoder whose ``truncated(t1)`` is valid
    works. ``survivor_budget`` is static (one compiled program); any
    budget works — the fused kernels zero-pad batches up to their tile.
    """
    T = decoder.max_iterations
    if not 0 < t1 < T:
        raise ValueError(f"need 0 < t1={t1} < max_iterations={T}")
    S = int(survivor_budget)
    if S <= 0:
        raise ValueError(f"survivor_budget must be positive, got {S}")

    # like sim/montecarlo._make_compacting_wave_fn: build the truncated
    # stage engine-side (Decoder.truncated rejects fused decoders because
    # their check schedule is {T}), then re-attach the fused options so
    # stage 1 runs in the kernel with its single check at t1
    opts = dict(decoder.qc_options or {})
    opts.pop("check_every", None)
    opts.pop("unroll", None)
    short = dataclasses.replace(decoder, qc_options=None).truncated(t1)
    short = dataclasses.replace(short, qc_options=opts or None)
    # stage 2's batch is the survivor budget; the fused kernels zero-pad
    # any batch up to the tile, so the parent's tile is kept as-is
    full = dataclasses.replace(decoder, qc_options=opts or None)

    def _cut(w):
        return jax.tree_util.tree_map(lambda a: a[:t1], w)

    # the fused kernels cast their llr input to the kernel dtype anyway
    # (pallas_fused: ``llr.astype(dtype)``), so running the one-hot
    # gather/scatter matmuls in that dtype changes nothing numerically —
    # one-hot selection is exact in any float — and halves the bytes of
    # the two [S, B] x [B, n] products
    mm_dtype = opts.get("dtype") if opts.get("fused") else None

    @jax.jit
    def fn(llr, weights=None):
        w = decoder.weights if weights is None else weights
        out1 = short(llr, _cut(w))
        conv = out1.success
        unconv = ~conv
        n_surv = jnp.sum(unconv)

        rank = jnp.cumsum(unconv.astype(jnp.int32)) - 1
        inbud = unconv & (rank < S)
        # P[r, i] = 1 iff frame i is the r-th unconverged frame (r < S)
        P = ((rank[None, :] == jnp.arange(S)[:, None]) & unconv[None, :]
             ).astype(mm_dtype or llr.dtype)
        out2 = full(onehot_select(P, llr.astype(mm_dtype or llr.dtype)), w)

        scat_succ = onehot_select(P.T, out2.success.astype(P.dtype)) > 0.5
        if out1.posterior is None:
            # lean fused epilogue: no [B, n] posterior exists on either
            # stage — merge the int8 bits directly (same scatter algebra)
            scat_bits = onehot_select(P.T, out2.bits.astype(P.dtype)) > 0.5
            bits = jnp.where(inbud[:, None], scat_bits,
                             out1.bits.astype(bool)).astype(jnp.int8)
            post = None
        else:
            scat_post = onehot_select(
                P.T, out2.posterior.astype(P.dtype)).astype(
                    out1.posterior.dtype)
            post = jnp.where(inbud[:, None], scat_post, out1.posterior)
            bits = (post < 0).astype(jnp.int32)
        success = jnp.where(inbud, scat_succ, conv)
        iterations = jnp.where(conv, out1.iterations,
                               jnp.where(inbud,
                                         jnp.full_like(out1.iterations, T),
                                         out1.iterations))
        return DecodeResult(bits=bits, posterior=post,
                            iterations=iterations, success=success), n_surv

    return fn
