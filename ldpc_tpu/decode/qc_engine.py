"""QC-structured decode engine: circulant rolls instead of gathers.

For quasi-cyclic codes (every real deployment target: the paper's
(9472,8192) QC family, 5G NR, DVB-S2), the Tanner graph is a protograph
expanded by ``lift x lift`` circulant shifts. That structure makes every
edge permutation in message passing a **circular roll** of a ``[lift, B]``
block — which XLA lowers to two contiguous slices + a concat, instead of
the general engine's per-edge gathers. All compute is elementwise work
over ``[lift, B]`` tiles; there are NO gather/scatter ops anywhere in the
iteration loop.

Message state is ``v2c[NB, lift, B]`` (NB = nonzero protograph blocks),
*variable-aligned*: ``v2c[b, u, :]`` is the message from variable
``col(b)*lift + u`` along block ``b``. Check-aligned views are
``roll(v2c[b], -shift(b))`` (check ``r`` of row ``row(b)`` connects to
variable ``(r + shift(b)) % lift`` of col ``col(b)``).

Semantics are IDENTICAL to the general engine (`engine.decode_batch`) —
same CN min1/min2/first-argmin, leave-one-out sign parity, variant
transforms, bv-bit quantization, convergence freezing — verified bit-exact
in tests. Reference behavioral contract: SURVEY.md §2b
(``ldpc_decoder.py:79-153``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.decode.engine import DecodeResult, VariantSpec, _make_qdq, _scan_xs

__all__ = ["QCGraph", "build_qc_graph", "qc_decode_batch",
           "qc_decode_batch_layered"]

# python float, NOT a jnp scalar: a module-level jnp constant
# forces backend init at import; where/full_like accept python scalars
_INF = float("inf")


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: static jit arg
class QCGraph:
    """Static protograph structure of a QC-lifted code.

    Blocks are ordered row-major over the base matrix — the same (check,
    var)-major order as ``DecoderGraph`` edges, so per-edge weight-bucket
    vectors translate to per-block vectors by taking each block's first edge.
    """

    mb: int          # base rows
    nb: int          # base cols
    lift: int
    num_blocks: int
    block_row: np.ndarray    # [NB] int32
    block_col: np.ndarray    # [NB] int32
    block_shift: np.ndarray  # [NB] int32
    row_blocks: Tuple[Tuple[int, ...], ...]  # blocks per base row
    col_blocks: Tuple[Tuple[int, ...], ...]  # blocks per base col
    # per-block weight-bucket indices (same universes as DecoderGraph)
    block_dc_bucket: np.ndarray
    block_dv_bucket: np.ndarray
    block_dcdv_bucket: np.ndarray
    unique_dc: Tuple[int, ...]
    unique_dv: Tuple[int, ...]

    @property
    def n(self) -> int:
        return self.nb * self.lift

    @property
    def m(self) -> int:
        return self.mb * self.lift


def build_qc_graph(base_matrix: np.ndarray, lift: int) -> QCGraph:
    """Host-side analysis of a protograph (entries: -1 = zero block,
    s >= 0 = identity right-shifted by s, as ``codes.create_qc_code``)."""
    B = np.asarray(base_matrix, dtype=np.int64)
    mb, nb = B.shape
    rows, cols = np.nonzero(B >= 0)
    order = np.lexsort((cols, rows))  # row-major over the base matrix
    rows, cols = rows[order], cols[order]
    shifts = B[rows, cols] % lift

    row_deg = (B >= 0).sum(axis=1)
    col_deg = (B >= 0).sum(axis=0)
    # node degrees in the lifted graph equal base-row/-col degrees
    unique_dc = tuple(sorted(int(d) for d in np.unique(row_deg[row_deg > 0])))
    unique_dv = tuple(sorted(int(d) for d in np.unique(col_deg[col_deg > 0])))
    dc_to_bucket = {d: i for i, d in enumerate(unique_dc)}
    dv_to_bucket = {d: i for i, d in enumerate(unique_dv)}
    bdc = np.array([dc_to_bucket[int(row_deg[r])] for r in rows], np.int32)
    bdv = np.array([dv_to_bucket[int(col_deg[c])] for c in cols], np.int32)

    row_blocks = tuple(
        tuple(int(b) for b in np.flatnonzero(rows == i)) for i in range(mb))
    col_blocks = tuple(
        tuple(int(b) for b in np.flatnonzero(cols == j)) for j in range(nb))

    return QCGraph(
        mb=mb, nb=nb, lift=lift, num_blocks=len(rows),
        block_row=rows.astype(np.int32), block_col=cols.astype(np.int32),
        block_shift=shifts.astype(np.int32),
        row_blocks=row_blocks, col_blocks=col_blocks,
        block_dc_bucket=bdc, block_dv_bucket=bdv,
        block_dcdv_bucket=(bdc * len(unique_dv) + bdv).astype(np.int32),
        unique_dc=unique_dc, unique_dv=unique_dv,
    )


def _per_block_weights(spec: VariantSpec, qc: QCGraph, t_beta, t_alpha):
    """Per-block beta/alpha scalars for this iteration ([NB] or scalar).

    The spec's ``beta_idx``/``alpha_idx`` must be per-BLOCK bucket vectors
    (length NB) — built by ``variants.make_decoder(..., qc=...)``. Degree
    buckets are block-constant (a block = one protograph edge; every lifted
    edge shares its (dc, dv)), so sharing types 1-4 translate exactly;
    per-edge type 0 is not block-constant and uses the general engine.
    """
    if spec.beta_idx is not None:
        assert np.asarray(spec.beta_idx).shape[0] == qc.num_blocks, (
            "QC decode needs per-block weight wiring; build the decoder "
            "with make_decoder(..., qc=qc_graph)")
        beta_b = t_beta[jnp.asarray(spec.beta_idx)]
    else:
        beta_b = jnp.float32(spec.fixed_beta)
    if spec.alpha_idx is not None:
        alpha_b = t_alpha[jnp.asarray(spec.alpha_idx)]
    else:
        alpha_b = jnp.float32(spec.fixed_alpha)
    return beta_b, alpha_b


@partial(jax.jit, static_argnames=("qc", "spec", "max_iterations", "ste",
                                   "return_trajectory", "check_every",
                                   "dtype", "unroll"))
def qc_decode_batch(
    llr: jnp.ndarray,            # [B, n]
    weights,                     # {'beta': [T, n_beta], 'alpha': [T, n_alpha]}
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
    check_every: int = 1,
    dtype=jnp.float32,
    unroll: bool = False,
) -> DecodeResult:
    """Flooding decode over the QC structure; contract == decode_batch.

    ``check_every``: amortize the syndrome check over chunks of that many
    iterations (must divide T). Final bits/success are unaffected; the
    per-frame ``iterations`` stat and output freezing round up to the chunk
    boundary. ``dtype``: message/posterior storage type (bfloat16 halves
    HBM traffic; hard decisions and syndrome stay exact). ``unroll``:
    unroll the intra-chunk scan — XLA fuses across iterations (~1.5x
    runtime) at the cost of a much larger graph to compile; the persistent
    compilation cache makes that a one-time cost per config.
    """
    T = max_iterations
    if T % check_every:
        raise ValueError(f"check_every={check_every} must divide T={T}")
    Bsz = llr.shape[0]
    L = qc.lift
    NB = qc.num_blocks

    # [nb, lift, B]: per-base-col LLR tiles
    llr_T = llr.T.astype(dtype).reshape(qc.nb, L, Bsz)

    shifts = [int(s) for s in qc.block_shift]
    rows = [int(r) for r in qc.block_row]
    cols = [int(c) for c in qc.block_col]

    # v2c var-aligned per block
    v2c0 = jnp.stack([llr_T[cols[b]] for b in range(NB)])  # [NB, L, B]

    # row-batched CN path: when every base row has the same block count,
    # the k-th blocks of all rows stack into one [mb, L, B] array and the
    # min tree / transforms run once per k instead of once per block —
    # ~3x fewer (and mb-x bigger) fusions, for the launch-overhead-bound
    # regime
    row_dcs = {len(b) for b in qc.row_blocks}
    row_regular = len(row_dcs) == 1 and qc.mb > 1

    def cn_and_vn(v2c, beta_b, alpha_b, qdq, vqdq):
        """One flooding iteration; returns (v2c', posterior [nb, L, B])."""
        beta_is_vec = jnp.ndim(beta_b) > 0
        alpha_is_vec = jnp.ndim(alpha_b) > 0

        if row_regular:
            return cn_and_vn_row_batched(v2c, beta_b, alpha_b, qdq, vqdq,
                                         beta_is_vec, alpha_is_vec)

        # ---- check-node update, per base row ----
        c2v_va: List[Optional[jnp.ndarray]] = [None] * NB
        for i in range(qc.mb):
            blocks = qc.row_blocks[i]
            # check-aligned magnitudes/signs via rolls
            ca = [jnp.roll(v2c[b], -shifts[b], axis=0) for b in blocks]
            mags = [jnp.abs(x) for x in ca]
            negs = [(x < 0) for x in ca]
            # running (min1, min2, argmin) across the row's blocks
            min1 = mags[0]
            min2 = jnp.full_like(mags[0], _INF)
            argm = jnp.zeros(mags[0].shape, jnp.int32)
            for k in range(1, len(blocks)):
                mk = mags[k]
                new_min = mk < min1
                min2 = jnp.where(new_min, min1, jnp.minimum(min2, mk))
                min1 = jnp.where(new_min, mk, min1)
                argm = jnp.where(new_min, k, argm)
            if len(blocks) == 1:
                min2 = min1  # degree-1 checks (ldpc_decoder.py:112-115)
            # sign parity
            neg_cnt = negs[0].astype(jnp.int32)
            for k in range(1, len(blocks)):
                neg_cnt = neg_cnt + negs[k].astype(jnp.int32)
            for k, b in enumerate(blocks):
                loo_mag = jnp.where(argm == k, min2, min1)
                loo_neg = (neg_cnt - negs[k].astype(jnp.int32)) & 1
                loo_sign = 1.0 - 2.0 * loo_neg.astype(jnp.float32)
                bb = beta_b[b] if beta_is_vec else beta_b
                ab = alpha_b[b] if alpha_is_vec else alpha_b
                if spec.kind == "nms":
                    out = bb * loo_sign * loo_mag
                elif spec.kind == "oms":
                    off = jax.nn.relu(loo_mag - bb)
                    if spec.alpha_in_cn:
                        off = off - ab
                    out = loo_sign * off
                elif spec.kind == "rcq":
                    out = qdq(loo_sign * loo_mag)
                elif spec.kind == "wrcq":
                    out = qdq(bb * loo_sign * loo_mag)
                else:  # orcq: W-OMS-RCQ (paper §VII-B)
                    off = jax.nn.relu(loo_mag - bb)
                    if spec.alpha_in_cn:
                        off = off - ab
                    out = qdq(loo_sign * off)
                c2v_va[b] = jnp.roll(out.astype(v2c.dtype), shifts[b], axis=0)

        # ---- variable-node update, per base col ----
        v2c_new = [None] * NB
        post = [None] * qc.nb
        for j in range(qc.nb):
            blocks = qc.col_blocks[j]
            colsum = c2v_va[blocks[0]]
            for b in blocks[1:]:
                colsum = colsum + c2v_va[b]
            post[j] = llr_T[j] + colsum
            for b in blocks:
                ext = colsum - c2v_va[b]
                ab = alpha_b[b] if alpha_is_vec else alpha_b
                if spec.alpha_in_cn:
                    nv = llr_T[j] + ext
                else:
                    nv = llr_T[j] + ab * ext
                if vqdq is not None:
                    nv = vqdq(nv)
                v2c_new[b] = nv.astype(v2c.dtype)
        posterior = jnp.stack(post)  # [nb, L, B]
        if vqdq is not None:
            posterior = vqdq(posterior)
        return jnp.stack(v2c_new), posterior.astype(v2c.dtype)

    def cn_and_vn_row_batched(v2c, beta_b, alpha_b, qdq, vqdq,
                              beta_is_vec, alpha_is_vec):
        dc = len(qc.row_blocks[0])
        # blk[i][k] = block id of row i's k-th block
        blk = [list(qc.row_blocks[i]) for i in range(qc.mb)]

        def ca_k(k):
            return jnp.stack([
                jnp.roll(v2c[blk[i][k]], -shifts[blk[i][k]], axis=0)
                for i in range(qc.mb)])  # [mb, L, B]

        x0 = ca_k(0).astype(jnp.float32)
        min1 = jnp.abs(x0)
        min2 = jnp.full_like(min1, _INF)
        argm = jnp.zeros(min1.shape, jnp.int32)
        neg_cnt = (x0 < 0).astype(jnp.int32)
        for k in range(1, dc):
            xk = ca_k(k).astype(jnp.float32)
            mk = jnp.abs(xk)
            new_min = mk < min1
            min2 = jnp.where(new_min, min1, jnp.minimum(min2, mk))
            min1 = jnp.where(new_min, mk, min1)
            argm = jnp.where(new_min, k, argm)
            neg_cnt = neg_cnt + (xk < 0).astype(jnp.int32)
        if dc == 1:
            min2 = min1

        c2v_va = [None] * NB
        for k in range(dc):
            xk = ca_k(k).astype(jnp.float32)
            loo_mag = jnp.where(argm == k, min2, min1)
            loo_neg = (neg_cnt - (xk < 0).astype(jnp.int32)) & 1
            loo_sign = 1.0 - 2.0 * loo_neg.astype(jnp.float32)
            ids = [blk[i][k] for i in range(qc.mb)]
            if beta_is_vec:
                bb = beta_b[jnp.asarray(ids)][:, None, None]
            else:
                bb = beta_b
            if alpha_is_vec:
                ab = alpha_b[jnp.asarray(ids)][:, None, None]
            else:
                ab = alpha_b
            if spec.kind == "nms":
                out = bb * loo_sign * loo_mag
            elif spec.kind == "oms":
                off = jax.nn.relu(loo_mag - bb)
                if spec.alpha_in_cn:
                    off = off - ab
                out = loo_sign * off
            elif spec.kind == "rcq":
                out = qdq(loo_sign * loo_mag)
            elif spec.kind == "wrcq":
                out = qdq(bb * loo_sign * loo_mag)
            else:  # orcq: W-OMS-RCQ (paper §VII-B)
                off = jax.nn.relu(loo_mag - bb)
                if spec.alpha_in_cn:
                    off = off - ab
                out = qdq(loo_sign * off)
            out = out.astype(v2c.dtype)
            for i in range(qc.mb):
                c2v_va[ids[i]] = jnp.roll(out[i], shifts[ids[i]], axis=0)

        # ---- variable-node update ----
        v2c_new = [None] * NB
        post = [None] * qc.nb
        for j in range(qc.nb):
            blocks = qc.col_blocks[j]
            colsum = c2v_va[blocks[0]]
            for b in blocks[1:]:
                colsum = colsum + c2v_va[b]
            post[j] = llr_T[j] + colsum
            for b in blocks:
                ext = colsum - c2v_va[b]
                ab = alpha_b[b] if alpha_is_vec else alpha_b
                if spec.alpha_in_cn:
                    nv = llr_T[j] + ext
                else:
                    nv = llr_T[j] + ab * ext
                if vqdq is not None:
                    nv = vqdq(nv)
                v2c_new[b] = nv.astype(v2c.dtype)
        posterior = jnp.stack(post)
        if vqdq is not None:
            posterior = vqdq(posterior)
        return jnp.stack(v2c_new), posterior.astype(v2c.dtype)

    def syndrome_ok(bits_blocks):
        """bits_blocks [nb, L, B] int32 -> [B] all-checks-zero."""
        ok = jnp.ones((Bsz,), bool)
        for i in range(qc.mb):
            blocks = qc.row_blocks[i]
            par = jnp.zeros((L, Bsz), jnp.int32)
            for b in blocks:
                par = par ^ jnp.roll(bits_blocks[cols[b]], -shifts[b], axis=0)
            ok = ok & ~jnp.any(par > 0, axis=0)
        return ok

    carry0 = dict(
        v2c=v2c0,
        post=llr_T,
        done=jnp.zeros((Bsz,), bool),
        iters=jnp.zeros((Bsz,), jnp.int32),
    )

    k = check_every
    xs = _scan_xs(spec, weights, T)
    if k > 1:  # chunk the per-iteration inputs: [T, ...] -> [T//k, k, ...]
        xs = jax.tree_util.tree_map(
            lambda a: a.reshape((T // k, k) + a.shape[1:]), xs)

    def body(carry, xc):
        # inner scan over the chunk's k iterations: the compiled graph stays
        # single-iteration-sized regardless of check_every (compile time
        # scales with graph size)
        def inner(state, x):
            v2c, _ = state
            beta_b, alpha_b = _per_block_weights(spec, qc, x["beta"],
                                                 x["alpha"])
            qdq = _make_qdq(spec, x, ste, v2c=False)
            vqdq = _make_qdq(spec, x, ste, v2c=True)
            v2c, post = cn_and_vn(v2c, beta_b, alpha_b, qdq, vqdq)
            ys = post.reshape(qc.n, Bsz).T if return_trajectory else None
            return (v2c, post), ys

        xc_stacked = (xc if k > 1 else
                      jax.tree_util.tree_map(lambda a: a[None], xc))
        (v2c, post), posts = jax.lax.scan(
            inner, (carry["v2c"], carry["post"]), xc_stacked,
            unroll=k if unroll else 1)
        t_last = (x := xc)["t"] if k == 1 else xc["t"][-1]
        bits = (post < 0).astype(jnp.int32)
        ok = syndrome_ok(bits)
        done_prev = carry["done"]
        post_out = jnp.where(done_prev[None, None, :], carry["post"], post)
        iters = jnp.where(done_prev, carry["iters"], t_last + 1)
        new = dict(v2c=v2c, post=post_out, done=done_prev | ok, iters=iters)
        return new, posts

    carry, ys = jax.lax.scan(body, carry0, xs)
    if return_trajectory:  # [T//k, k, B, n] -> [T, B, n]
        ys = ys.reshape((T,) + ys.shape[2:])
    post = carry["post"].reshape(qc.n, Bsz).T  # [B, n]
    bits = (post < 0).astype(jnp.int32)
    return DecodeResult(
        bits=bits, posterior=post, iterations=carry["iters"],
        success=carry["done"],
        posteriors_all=ys if return_trajectory else None,
    )


@partial(jax.jit, static_argnames=("qc", "spec", "max_iterations", "ste",
                                   "dtype", "return_trajectory"))
def qc_decode_batch_layered(
    llr: jnp.ndarray,            # [B, n]
    weights,
    *,
    qc: QCGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    dtype=jnp.float32,
    return_trajectory: bool = False,
) -> DecodeResult:
    """Layered-schedule QC decode: base rows are the natural layers.

    Correct layered semantics (what the reference's ``_decode_layered``
    intended before zeroing its own message memory, ``rcq_decoder.py:
    281-350`` / SURVEY §8.3): persistent per-block c2v memory, an
    incrementally-maintained per-column sum, fresh v2c formed from the
    *current* posterior state layer by layer. Each base row's ``lift``
    checks update in parallel (they share no variable within a block
    column), so a layer is one fused roll+min-tree pass — the classic
    row-layered hardware schedule, vectorized.

    The bv-bit quantizer applies to the posterior at iteration end (same
    as ``decode_batch_layered``); contract otherwise matches
    ``qc_decode_batch``.
    """
    T = max_iterations
    Bsz = llr.shape[0]
    L = qc.lift
    NB = qc.num_blocks

    llr_T = llr.T.astype(dtype).reshape(qc.nb, L, Bsz)
    shifts = [int(s) for s in qc.block_shift]
    cols = [int(c) for c in qc.block_col]

    def one_iteration(c2v, colsum, x):
        beta_b, alpha_b = _per_block_weights(spec, qc, x["beta"], x["alpha"])
        beta_is_vec = jnp.ndim(beta_b) > 0
        alpha_is_vec = jnp.ndim(alpha_b) > 0
        qdq = _make_qdq(spec, x, ste, v2c=False)
        vqdq = _make_qdq(spec, x, ste, v2c=True)

        c2v_list = [c2v[b] for b in range(NB)]
        colsum_list = [colsum[j] for j in range(qc.nb)]
        for i in range(qc.mb):
            blocks = qc.row_blocks[i]
            # fresh v2c from current posterior state, check-aligned
            ca = []
            for b in blocks:
                j = cols[b]
                ab = alpha_b[b] if alpha_is_vec else alpha_b
                ext = colsum_list[j] - c2v_list[b]
                if spec.alpha_in_cn:
                    nv = llr_T[j] + ext
                else:
                    nv = llr_T[j] + ab * ext
                ca.append(jnp.roll(nv.astype(jnp.float32), -shifts[b],
                                   axis=0))
            mags = [jnp.abs(v) for v in ca]
            min1 = mags[0]
            min2 = jnp.full_like(min1, _INF)
            argm = jnp.zeros(min1.shape, jnp.int32)
            for k in range(1, len(blocks)):
                mk = mags[k]
                new_min = mk < min1
                min2 = jnp.where(new_min, min1, jnp.minimum(min2, mk))
                min1 = jnp.where(new_min, mk, min1)
                argm = jnp.where(new_min, k, argm)
            if len(blocks) == 1:
                min2 = min1
            neg_cnt = (ca[0] < 0).astype(jnp.int32)
            for k in range(1, len(blocks)):
                neg_cnt = neg_cnt + (ca[k] < 0).astype(jnp.int32)
            for k, b in enumerate(blocks):
                loo_mag = jnp.where(argm == k, min2, min1)
                loo_neg = (neg_cnt - (ca[k] < 0).astype(jnp.int32)) & 1
                loo_sign = 1.0 - 2.0 * loo_neg.astype(jnp.float32)
                bb = beta_b[b] if beta_is_vec else beta_b
                ab = alpha_b[b] if alpha_is_vec else alpha_b
                if spec.kind == "nms":
                    out = bb * loo_sign * loo_mag
                elif spec.kind == "oms":
                    off = jax.nn.relu(loo_mag - bb)
                    if spec.alpha_in_cn:
                        off = off - ab
                    out = loo_sign * off
                elif spec.kind == "rcq":
                    out = qdq(loo_sign * loo_mag)
                elif spec.kind == "wrcq":
                    out = qdq(bb * loo_sign * loo_mag)
                else:  # orcq: W-OMS-RCQ (paper §VII-B)
                    off = jax.nn.relu(loo_mag - bb)
                    if spec.alpha_in_cn:
                        off = off - ab
                    out = qdq(loo_sign * off)
                new = jnp.roll(out, shifts[b], axis=0).astype(dtype)
                j = cols[b]
                colsum_list[j] = colsum_list[j] + (new - c2v_list[b])
                c2v_list[b] = new

        posterior = jnp.stack([llr_T[j] + colsum_list[j]
                               for j in range(qc.nb)])
        if vqdq is not None:
            posterior = vqdq(posterior)
        return (jnp.stack(c2v_list), jnp.stack(colsum_list),
                posterior.astype(dtype))

    def syndrome_ok(bits_blocks):
        ok = jnp.ones((Bsz,), bool)
        for i in range(qc.mb):
            par = jnp.zeros((L, Bsz), jnp.int32)
            for b in qc.row_blocks[i]:
                par = par ^ jnp.roll(bits_blocks[cols[b]], -shifts[b], axis=0)
            ok = ok & ~jnp.any(par > 0, axis=0)
        return ok

    carry0 = dict(
        c2v=jnp.zeros((NB, L, Bsz), dtype),
        colsum=jnp.zeros((qc.nb, L, Bsz), dtype),
        post=llr_T,
        done=jnp.zeros((Bsz,), bool),
        iters=jnp.zeros((Bsz,), jnp.int32),
    )

    def body(carry, x):
        c2v, colsum, post = one_iteration(carry["c2v"], carry["colsum"], x)
        bits = (post < 0).astype(jnp.int32)
        ok = syndrome_ok(bits)
        done_prev = carry["done"]
        post_out = jnp.where(done_prev[None, None, :], carry["post"], post)
        iters = jnp.where(done_prev, carry["iters"], x["t"] + 1)
        ys = post.reshape(qc.n, Bsz).T if return_trajectory else None
        return dict(c2v=c2v, colsum=colsum, post=post_out,
                    done=done_prev | ok, iters=iters), ys

    carry, ys = jax.lax.scan(body, carry0, _scan_xs(spec, weights, T))
    post = carry["post"].reshape(qc.n, Bsz).T
    bits = (post < 0).astype(jnp.int32)
    return DecodeResult(bits=bits, posterior=post,
                        iterations=carry["iters"], success=carry["done"],
                        posteriors_all=ys if return_trajectory else None)
