"""Whole-decode Pallas kernels for QC codes, compiled through Triton.

The XLA engines (``qc_engine``) stream the whole message state through
device memory on every layer of every iteration: at B=32768 on the bench
code (5x37 base, lift 256) that is ~3.1 GB of bf16 c2v state per
iteration, plus the column sums. These kernels decode one frame at a
time per grid program and keep that frame's state in a per-program
scratch for all ``T`` iterations; only the LLRs come in and the
posterior (or int8 bits) and a success flag go out.

- grid = ``ceil(B / batch_tile)`` programs. Program ``g`` decodes frames
  ``g*batch_tile ...`` one after another. Programs run in parallel in any
  order; nothing carries from one to another.
- The scratch is an extra, discarded output holding one frame's state
  per program, reused for every frame of the program. One bench frame is
  113,664 B in bf16 (layered: 185x256 c2v + 37x256 column sums).
  :func:`auto_batch_tile` sizes the grid for occupancy, as measured on an
  H100 at the bench shape; the grid's scratch is far larger than L2.
- A base row (a layer) is processed as ``[Dp, Lc]`` tiles: the row's
  blocks on the first axis, padded to a power of two and masked, and
  ``Lc`` lanes of the lift on the second. Circulant shifts are indexed
  loads and stores (``ref[col*L + (lane + s) % L]``); a lift that is not
  a power of two is padded to the next one with masked lanes.
- ``debug_barrier`` separates dependent phases (CN -> VN, layer ->
  layer), because the threads of a program exchange state through the
  scratch. Interpret mode runs the body in program order and has no
  barrier lowering, so the barrier is emitted only when compiling.

Semantics: flooding == ``qc_decode_batch(..., check_every=T)``; layered
== the iteration-``T`` posterior of ``qc_decode_batch_layered``. The
syndrome is checked once, after the final iteration, inside the kernel,
on the stored (dtype-rounded) posterior; ``iterations`` is ``T`` for
every frame. Arithmetic follows the XLA engines op for op, with the same
storage-dtype rounding (tests/test_pallas_fused.py). Inference-only:
training uses the differentiable XLA engines.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ldpc_tpu.decode.engine import DecodeResult, VariantSpec
from ldpc_tpu.decode.qc_engine import QCGraph
from ldpc_tpu.quantizer import QDQ_SIGN_TINY, power_qdq, uniform_qdq

__all__ = ["qc_fused_decode_batch", "qc_fused_decode_batch_layered",
           "auto_batch_tile"]

# Grid and tile sizes, measured on an H100 (80GB HBM3, 400 W) at the bench
# shape: 32768 frames, layered T=3, bf16, lean. By frames per program
# (2048-element tiles), 8 (4096 programs) took 44.6 ms, 32 (1024) 46.4 ms
# and 112 (293) 59.3 ms: more programs keep the SMs fuller, though the
# scratch of 4096 programs (~465 MB) is far past L2. By elements per
# [Dp, Lc] layer tile (4 warps, 293 programs), 2048 took 59.3 ms, 1024
# 70.6 and 4096 66.4.
_FRAMES_PER_PROGRAM = 8
_MIN_PROGRAMS = 4096
_TILE_ELEMS = 2048
_NUM_WARPS = 4
_INF = float("inf")


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def auto_batch_tile(batch: int) -> int:
    """Frames per grid program: up to :data:`_FRAMES_PER_PROGRAM`, fewer
    when that would leave fewer than :data:`_MIN_PROGRAMS` programs (a
    small batch, such as a 128-frame survivor stage, gets one frame per
    program)."""
    return max(1, min(_FRAMES_PER_PROGRAM, batch // _MIN_PROGRAMS))


def _check_int32(B: int, n: int, G: int, state_words: int) -> None:
    """The kernels address their flat buffers with int32 offsets: the
    [B, n] LLRs and outputs, and the grid's scratch of ``G`` programs of
    ``state_words`` each (the layered column sums, ``G * n`` words, are
    smaller). Refuse a shape whose offsets would wrap."""
    for what, words in (("frames x bits", B * n),
                        ("programs x state words", G * state_words)):
        if words >= 2 ** 31:
            raise ValueError(
                f"{what} = {words} exceeds int32 indexing; decode in "
                "smaller waves or with a larger batch_tile")


def _qdq_mode(qparams, levels: int, closed: bool = False) -> str:
    """Mirror ``engine._make_qdq``'s static routing: 'uniform' (gamma==1
    closed form), 'power', or the exact 'staircase'. ``closed=True``
    forces the closed form for small LUTs too whenever (C, gamma) are
    known: O(1) ops per message instead of ``levels-1`` compare+add
    pairs, with the same quantizer index as the LUT scan."""
    if qparams is not None and (closed or levels > 16):
        if np.all(np.asarray(qparams)[:, 1] == 1.0):
            return "uniform"
        return "power"
    return "staircase"


def _kernel_qdq(x, t, thr_ref, qp_ref, levels: int, mode: str):
    """Iteration ``t``'s quantize-dequantize (``engine._make_qdq``): the
    threshold and (C, gamma) tables are flat ``[T * levels]`` and
    ``[T * 2]`` refs read as scalars."""
    if mode == "uniform":
        return uniform_qdq(x, qp_ref[t * 2], levels)
    if mode == "power":
        return power_qdq(x, qp_ref[t * 2], qp_ref[t * 2 + 1], levels)
    mag = jnp.abs(x)
    snapped = jnp.zeros_like(mag)
    for j in range(1, levels):
        tj = thr_ref[t * levels + j]
        step = tj - thr_ref[t * levels + j - 1]
        snapped = snapped + jnp.where(mag >= tj, step, 0.0)
    snapped = jnp.maximum(snapped, QDQ_SIGN_TINY)
    return jnp.where(x < 0, -snapped, snapped)


def _cn_transform(x, valid, deg, spec: VariantSpec, bb, ab, qdq):
    """Check-node update of one ``[Dp, Lc]`` tile of check-aligned v2c
    (blocks on axis 0): min1/min2/first-argmin, leave-one-out sign
    parity, variant transform — ``qc_engine``'s CN, vectorized over the
    row's blocks. Padded rows (``valid`` False) contribute nothing."""
    dp = x.shape[0]
    kk = jnp.arange(dp)[:, None]
    negi = ((x < 0) & valid).astype(jnp.int32)
    mag = jnp.where(valid, jnp.abs(x), _INF)
    min1 = jnp.min(mag, axis=0)
    argm = jnp.min(jnp.where(mag == min1[None, :], kk, dp), axis=0)
    min2 = jnp.min(jnp.where(kk == argm[None, :], _INF, mag), axis=0)
    # degree-1 checks (ldpc_decoder.py:112-115)
    min2 = jnp.where(deg == 1, min1, min2)
    neg_cnt = jnp.sum(negi, axis=0)
    loo_mag = jnp.where(kk == argm[None, :], min2[None, :], min1[None, :])
    loo_neg = (neg_cnt[None, :] - negi) & 1
    loo_sign = 1.0 - 2.0 * loo_neg.astype(jnp.float32)
    if spec.kind == "nms":
        return bb * loo_sign * loo_mag
    if spec.kind == "rcq":
        return qdq(loo_sign * loo_mag)
    if spec.kind == "wrcq":
        return qdq(bb * loo_sign * loo_mag)
    off = jnp.maximum(loo_mag - bb, 0.0)   # oms / orcq
    if spec.alpha_in_cn:
        off = off - ab
    return loo_sign * off if spec.kind == "oms" else qdq(loo_sign * off)


def _tables(qc: QCGraph):
    """Structure tables, one flat int32 array read inside the kernel.

    Rows: ``[mb, 4, dm]`` — per base row its blocks' ids, columns and
    shifts, zero-padded to the widest row's power of two ``dm``, and the
    row degree at ``[r, 3, 0]``. Columns (flooding VN): ``[nb, 3, dvm]``
    — per base column its blocks' ids and shifts, and the column degree
    at ``[j, 2, 0]``. Returns (table, dm, dvm, offset of the columns)."""
    dm = _pow2(max(len(r) for r in qc.row_blocks))
    dvm = max(len(c) for c in qc.col_blocks)
    rows = np.zeros((qc.mb, 4, dm), np.int32)
    for r, blocks in enumerate(qc.row_blocks):
        for k, b in enumerate(blocks):
            rows[r, :3, k] = (b, qc.block_col[b], qc.block_shift[b])
        rows[r, 3, 0] = len(blocks)
    cols = np.zeros((qc.nb, 3, dvm), np.int32)
    for j, blocks in enumerate(qc.col_blocks):
        for k, b in enumerate(blocks):
            cols[j, :2, k] = (b, qc.block_shift[b])
        cols[j, 2, 0] = len(blocks)
    return (np.concatenate([rows.reshape(-1), cols.reshape(-1)]), dm, dvm,
            rows.size)


def _make_kernel(qc: QCGraph, spec: VariantSpec, T: int, bt: int, B: int,
                 dtype, lean: bool, closed_qdq: bool, interpret: bool,
                 layered: bool, dm: int, dvm: int, col_off: int):
    L, Lp = qc.lift, _pow2(qc.lift)
    lc = max(1, min(Lp, _TILE_ELEMS // dm))   # lanes per layer tile
    nch = Lp // lc
    n, NB = qc.n, qc.num_blocks
    chunk = min(_pow2(n), _TILE_ELEMS)
    closed = closed_qdq or spec.closed_qdq
    q_mode = _qdq_mode(spec.qparams, spec.q_levels, closed)
    with_vqdq = (spec.v2c_qparams is not None or
                 spec.v2c_thresholds is not None)
    v_mode = _qdq_mode(spec.v2c_qparams, spec.v2c_levels, closed)
    state_words = NB * L

    def rnd(x):  # round to the storage dtype, as the XLA engines store
        return x.astype(dtype).astype(jnp.float32)

    def barrier():
        if not interpret:
            plt.debug_barrier()

    def ld(ref, idx, mask):
        return plt.load(ref.at[idx], mask=mask, other=0).astype(jnp.float32)

    def st(ref, idx, val, mask):
        # masked lanes aim at the buffer's spare last word: in interpret
        # mode a masked store is a read-modify-write scatter, and a
        # padded lane aliasing a live address would race with it
        trash = ref.shape[0] - 1
        plt.store(ref.at[jnp.where(mask, idx, trash)], val, mask=mask)

    def loop(n_steps, body, carry=0):
        return jax.lax.fori_loop(0, n_steps, body, carry)

    def kernel(llr_ref, tab_ref, beta_ref, alpha_ref, thr_ref, qp_ref,
               vthr_ref, vqp_ref, out_ref, ok_ref, c_ref, *cs_refs):
        g = pl.program_id(0)
        cbase = g * state_words

        def qdq(x, t):
            return _kernel_qdq(x, t, thr_ref, qp_ref, spec.q_levels, q_mode)

        def vqdq(x, t):
            return _kernel_qdq(x, t, vthr_ref, vqp_ref, spec.v2c_levels,
                               v_mode)

        def row_tile(r, c):
            """Row ``r``'s lane chunk ``c``: block ids, var positions
            (check lane i reads var (i + s) % L of its column), state
            positions, the mask, and the row degree."""
            k = jnp.arange(dm)
            base = r * 4 * dm
            blk = tab_ref[base + k][:, None]
            col = tab_ref[base + dm + k][:, None]
            sh = tab_ref[base + 2 * dm + k][:, None]
            deg = tab_ref[base + 3 * dm]
            u = c * lc + jnp.arange(lc)[None, :]
            valid = (k[:, None] < deg) & (u < L)
            uu = jnp.minimum(u, L - 1)
            return blk, col * L + (uu + sh) % L, blk * L + uu, valid, deg

        def row_chunks(body, carry=0):
            """``body(r, c, carry)`` over every (row, lane chunk); a
            barrier after each row when ``layered`` (rows depend)."""
            def per_row(r, carry):
                carry = loop(nch, lambda c, cr: body(r, c, cr), carry)
                if layered:
                    barrier()
                return carry
            return loop(qc.mb, per_row, carry)

        def flat_chunks(size, body):
            def step(i, carry):
                idx = i * chunk + jnp.arange(chunk)
                body(jnp.minimum(idx, size - 1), idx < size)
                return carry
            loop(-(-size // chunk), step)

        def store_post(lbase, idx, post, mask):
            if lean:
                st(out_ref, lbase + idx, (post < 0).astype(jnp.int8), mask)
            else:
                st(out_ref, lbase + idx, post.astype(dtype), mask)

        def syndrome_ok(lbase):
            """All checks satisfied, from the stored posterior's signs."""
            def body(r, c, fail):
                _, vpos, _, valid, _ = row_tile(r, c)
                x = plt.load(out_ref.at[lbase + vpos], mask=valid, other=0)
                neg = (x > 0) if lean else (x < 0)
                par = jnp.sum((neg & valid).astype(jnp.int32), axis=0) & 1
                return jnp.maximum(fail, jnp.max(par))
            fail = loop(qc.mb, lambda r, f: loop(
                nch, lambda c, f2: body(r, c, f2), f), jnp.int32(0))
            return (fail == 0).astype(jnp.int32)

        def decode_layered(f):
            lbase = f * n
            sbase = g * n
            cs_ref, = cs_refs
            zero = jnp.zeros((chunk,), dtype)
            flat_chunks(state_words,
                        lambda idx, m: st(c_ref, cbase + idx, zero, m))
            flat_chunks(n, lambda idx, m: st(cs_ref, sbase + idx, zero, m))
            barrier()

            def iteration(t, carry):
                def layer(r, c, carry):
                    blk, vpos, cidx, valid, deg = row_tile(r, c)
                    bb = beta_ref[t * NB + blk]
                    ab = alpha_ref[t * NB + blk]
                    llr = ld(llr_ref, lbase + vpos, valid)
                    cs = ld(cs_ref, sbase + vpos, valid)
                    old = ld(c_ref, cbase + cidx, valid)
                    ext = rnd(cs - old)
                    if spec.alpha_in_cn:
                        nv = rnd(llr + ext)
                    else:
                        nv = llr + ab * ext
                    out = _cn_transform(nv, valid, deg, spec, bb, ab,
                                        lambda v: qdq(v, t))
                    new = rnd(out)
                    st(c_ref, cbase + cidx, new.astype(dtype), valid)
                    st(cs_ref, sbase + vpos,
                       rnd(cs + rnd(new - old)).astype(dtype), valid)
                    return carry
                return row_chunks(layer, carry)

            loop(T, iteration)

            def posterior(idx, m):
                post = rnd(ld(llr_ref, lbase + idx, m) +
                           ld(cs_ref, sbase + idx, m))
                if with_vqdq:
                    post = rnd(vqdq(post, T - 1))
                store_post(lbase, idx, post, m)
            flat_chunks(n, posterior)
            barrier()
            ok_ref[f] = syndrome_ok(lbase)

        def decode_flooding(f):
            lbase = f * n

            def init(r, c, carry):  # v2c := channel LLRs, check-aligned
                _, vpos, cidx, valid, _ = row_tile(r, c)
                st(c_ref, cbase + cidx,
                   plt.load(llr_ref.at[lbase + vpos], mask=valid, other=0),
                   valid)
                return carry
            row_chunks(init)
            barrier()
            u = jnp.arange(Lp)
            um = u < L
            uu = jnp.minimum(u, L - 1)

            def iteration(t, carry):
                def cn(r, c, carry):  # CN, in place
                    blk, _, cidx, valid, deg = row_tile(r, c)
                    bb = beta_ref[t * NB + blk]
                    ab = alpha_ref[t * NB + blk]
                    x = ld(c_ref, cbase + cidx, valid)
                    out = _cn_transform(x, valid, deg, spec, bb, ab,
                                        lambda v: qdq(v, t))
                    st(c_ref, cbase + cidx, out.astype(dtype), valid)
                    return carry
                row_chunks(cn)
                barrier()

                def vn(j, carry):  # VN, in place, blocks in column order
                    base = col_off + j * 3 * dvm
                    deg = tab_ref[base + 2 * dvm]
                    llr = ld(llr_ref, lbase + j * L + uu, um)
                    blks, idxs, cv, ms = [], [], [], []
                    for k in range(dvm):
                        b = tab_ref[base + k]
                        i = cbase + b * L + (uu + L - tab_ref[base + dvm + k]) % L
                        m = um & (k < deg)
                        blks.append(b)
                        idxs.append(i)
                        ms.append(m)
                        cv.append(ld(c_ref, i, m))
                    colsum = cv[0]
                    for v in cv[1:]:  # padded blocks add an exact 0
                        colsum = rnd(colsum + v)
                    for b, i, v, m in zip(blks, idxs, cv, ms):
                        ext = rnd(colsum - v)
                        if spec.alpha_in_cn:
                            nv = rnd(llr + ext)
                        else:
                            nv = llr + alpha_ref[t * NB + b] * ext
                        if with_vqdq:
                            nv = vqdq(nv, t)
                        st(c_ref, i, nv.astype(dtype), m)

                    @pl.when(t == T - 1)
                    def _():
                        post = rnd(llr + colsum)
                        if with_vqdq:
                            post = rnd(vqdq(post, T - 1))
                        store_post(lbase, j * L + uu, post, um)
                    return carry
                loop(qc.nb, vn)
                barrier()
                return carry

            loop(T, iteration)
            ok_ref[f] = syndrome_ok(lbase)

        decode = decode_layered if layered else decode_flooding

        def frame(i, carry):
            f = g * bt + i

            @pl.when(f < B)
            def _():
                decode(f)
            return carry

        loop(bt, frame)

    return kernel


def _decode(llr, weights, *, qc, spec, max_iterations, dtype, batch_tile,
            interpret, lean, closed_qdq, layered):
    if not interpret and jax.default_backend() == "cpu":
        raise RuntimeError(
            "the fused QC kernels compile for a GPU (Pallas through "
            "Triton); on the CPU pass interpret=True, e.g. "
            "qc_options={'fused': True, 'interpret': True}")
    T = max_iterations
    B, n = llr.shape
    bt = auto_batch_tile(B) if batch_tile is None else int(batch_tile)
    if bt < 1:
        raise ValueError(f"batch_tile must be >= 1 or None, got {bt}")
    G = -(-B // bt)
    NB = qc.num_blocks
    _check_int32(B, n, G, NB * qc.lift)

    def flat(a, w):
        return (jnp.asarray(a, jnp.float32).reshape(-1) if a is not None
                else jnp.zeros((T * w,), jnp.float32))

    # per-(iteration, block) weight tables, read by flat gathers
    if spec.beta_idx is not None:
        beta = weights["beta"][:, jnp.asarray(spec.beta_idx)]
    else:
        beta = jnp.full((T, NB), spec.fixed_beta, jnp.float32)
    if spec.alpha_idx is not None:
        alpha = weights["alpha"][:, jnp.asarray(spec.alpha_idx)]
    else:
        alpha = jnp.full((T, NB), spec.fixed_alpha, jnp.float32)
    tab, dm, dvm, col_off = _tables(qc)

    kernel = _make_kernel(qc, spec, T, bt, B, dtype, lean, closed_qdq,
                          interpret, layered, dm, dvm, col_off)
    out_dtype = jnp.int8 if lean else dtype
    # every stored buffer has one spare word at its end (see ``st``)
    out_shape = [jax.ShapeDtypeStruct((B * n + 1,), out_dtype),
                 jax.ShapeDtypeStruct((B,), jnp.int32),
                 jax.ShapeDtypeStruct((G * NB * qc.lift + 1,), dtype)]
    if layered:
        out_shape.append(jax.ShapeDtypeStruct((G * n + 1,), dtype))
    out, ok, *_ = pl.pallas_call(
        kernel,
        grid=(G,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="qc_fused_layered" if layered else "qc_fused_flooding",
    )(llr.astype(dtype).reshape(-1), jnp.asarray(tab),
      beta.astype(jnp.float32).reshape(-1),
      alpha.astype(jnp.float32).reshape(-1),
      flat(spec.thresholds, max(spec.q_levels, 1)), flat(spec.qparams, 2),
      flat(spec.v2c_thresholds, max(spec.v2c_levels, 1)),
      flat(spec.v2c_qparams, 2))

    out = out[:B * n].reshape(B, n)
    success = ok > 0
    iters = jnp.full((B,), T, jnp.int32)
    if lean:
        return DecodeResult(bits=out, posterior=None, iterations=iters,
                            success=success)
    return DecodeResult(bits=(out < 0).astype(jnp.int32), posterior=out,
                        iterations=iters, success=success)


_STATIC = ("qc", "spec", "max_iterations", "dtype", "batch_tile",
           "interpret", "lean", "closed_qdq")


@partial(jax.jit, static_argnames=_STATIC)
def qc_fused_decode_batch(
    llr: jnp.ndarray,            # [B, n]
    weights,                     # {'beta': [T, n_beta], 'alpha': [T, n_alpha]}
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    dtype=jnp.bfloat16,
    batch_tile: int | None = None,
    interpret: bool = False,
    lean: bool = False,
    closed_qdq: bool = False,
) -> DecodeResult:
    """Flooding QC decode in one whole-decode kernel.

    Contract == ``qc_decode_batch(..., check_every=max_iterations)``:
    bits/posterior from the final iteration, ``success`` = final syndrome,
    ``iterations`` = T for every frame. Any batch size works.
    ``batch_tile``: frames per grid program (None: :func:`auto_batch_tile`).
    ``lean=True`` returns int8 bits and no posterior. ``interpret=True``
    runs the kernel on the CPU; without it the CPU is refused.
    """
    return _decode(llr, weights, qc=qc, spec=spec,
                   max_iterations=max_iterations, dtype=dtype,
                   batch_tile=batch_tile, interpret=interpret, lean=lean,
                   closed_qdq=closed_qdq, layered=False)


@partial(jax.jit, static_argnames=_STATIC)
def qc_fused_decode_batch_layered(
    llr: jnp.ndarray,            # [B, n]
    weights,
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    dtype=jnp.bfloat16,
    batch_tile: int | None = None,
    interpret: bool = False,
    lean: bool = False,
    closed_qdq: bool = False,
) -> DecodeResult:
    """Layered-schedule whole-decode kernel.

    Same layered semantics as ``qc_decode_batch_layered`` (persistent
    per-block c2v memory, incrementally maintained column sums, fresh v2c
    from the current posterior state row by row — the schedule of the
    paper's FPGA, §VII-B), with the check-at-the-end contract: the
    returned posterior is iteration T's, ``success`` is its syndrome,
    ``iterations`` is T for every frame. Options as
    :func:`qc_fused_decode_batch`.
    """
    return _decode(llr, weights, qc=qc, spec=spec,
                   max_iterations=max_iterations, dtype=dtype,
                   batch_tile=batch_tile, interpret=interpret, lean=lean,
                   closed_qdq=closed_qdq, layered=True)
