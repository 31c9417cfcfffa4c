"""Degree-bucketed decode engine: the irregular-code fast path.

The general engine (``engine.py``) pays for irregularity twice: every
check-node update gathers a ``[m, max_dc, B]`` slot block (padded to the
MAX check degree) and every variable-node update gathers ``[n, max_dv,
B]`` (padded to the max variable degree — 4.3x waste on the PBRL family,
whose incremental-redundancy columns are degree 1 while core columns
reach degree 13).

This engine removes both the padding and almost all the gathers with one
host-side precomputation: edges are laid out twice, once sorted by
(check degree, check, slot) and once by (variable degree, variable,
slot). In each order, every same-degree group is a CONTIGUOUS block that
reshapes — for free — into ``[nodes_d, d, B]``, so the CN min-tree and
the VN column sum are pure dense reductions with no slot tables, no
masks, no pad lanes. The only per-iteration data movement is the two
``[E, B]`` row permutations between the orders (lane-major contiguous
rows, the contiguous gather shape), versus the general engine's
``m*max_dc + E + n*max_dv + 2E`` gathered rows.

Semantics are IDENTICAL to ``engine.decode_batch`` — same CN
min1/min2/first-argmin and leave-one-out sign parity, same variant
transforms and bv quantization, same convergence freezing (verified in
``tests/test_bucketed_engine.py``; posterior tolerance is ~1 ulp because
XLA associates the padded vs dense column sums differently). Reference
behavioral contract: SURVEY.md §2b (``ldpc_decoder.py:79-153``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.codes import DecoderGraph
from ldpc_tpu.decode.engine import (
    DecodeResult,
    VariantSpec,
    _make_qdq,
    _scan_xs,
    _syndrome_ok,
)

__all__ = ["BucketedGraph", "build_bucketed_graph", "bucketed_decode_batch"]


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: static jit arg
class BucketedGraph:
    """Degree-bucketed edge layouts for one code (host-side, static)."""

    graph: DecoderGraph
    # CN-sorted order: edges sorted by (check degree, check id, slot)
    cn_buckets: Tuple[Tuple[int, int, int], ...]  # (degree, n_checks, offset)
    cn_order: np.ndarray       # [E] edge id at each CN-sorted position
    # VN-sorted order: edges sorted by (var degree, var id, slot)
    vn_buckets: Tuple[Tuple[int, int, int], ...]  # (degree, n_vars, offset)
    vn_order: np.ndarray       # [E] edge id at each VN-sorted position
    cn_to_vn: np.ndarray       # [E] perm: vn_pos -> cn_pos
    vn_to_cn: np.ndarray       # [E] perm: cn_pos -> vn_pos
    var_order: np.ndarray      # [n] variable id at each sorted-var position
    var_rank: np.ndarray       # [n] sorted position of each variable
    llr_edge_var: np.ndarray   # [n] == var_order (llr rows per sorted var)
    cn_var_slots_sorted: np.ndarray  # [m, max_dc] sorted-var ids, pad n


def build_bucketed_graph(graph: DecoderGraph) -> BucketedGraph:
    """Precompute the two degree-sorted edge layouts (host-side)."""
    E = graph.num_edges

    # CN order: stable sort of edges by (check degree, check id); within a
    # check, edge ids are already in slot order (row-major build)
    cdeg_e = graph.check_degree[graph.edge_check]
    cn_order = np.lexsort((np.arange(E), graph.edge_check, cdeg_e))
    cn_buckets = []
    off = 0
    for d in graph.unique_dc:
        cnt = int((graph.check_degree == d).sum())
        cn_buckets.append((int(d), cnt, off))
        off += cnt * d
    assert off == E

    vdeg_e = graph.var_degree[graph.edge_var]
    vn_order = np.lexsort((np.arange(E), graph.edge_var, vdeg_e))
    vn_buckets = []
    off = 0
    for d in graph.unique_dv:
        cnt = int((graph.var_degree == d).sum())
        vn_buckets.append((int(d), cnt, off))
        off += cnt * d
    assert off == E

    pos_in_cn = np.empty(E, np.int64)
    pos_in_cn[cn_order] = np.arange(E)
    pos_in_vn = np.empty(E, np.int64)
    pos_in_vn[vn_order] = np.arange(E)
    # cn_to_vn[p] = CN-sorted position of the edge at VN-sorted position p
    cn_to_vn = pos_in_cn[vn_order].astype(np.int32)
    vn_to_cn = pos_in_vn[cn_order].astype(np.int32)

    var_order = np.lexsort((np.arange(graph.n), graph.var_degree)).astype(
        np.int32)
    var_rank = np.empty(graph.n, np.int32)
    var_rank[var_order] = np.arange(graph.n, dtype=np.int32)
    # syndrome in sorted-var space: remap slot table entries (pad n -> n)
    var_rank_ext = np.concatenate([var_rank, np.int32([graph.n])])
    cn_var_slots_sorted = var_rank_ext[graph.cn_var_slots].astype(np.int32)

    return BucketedGraph(
        graph=graph,
        cn_buckets=tuple(cn_buckets), cn_order=cn_order.astype(np.int32),
        vn_buckets=tuple(vn_buckets), vn_order=vn_order.astype(np.int32),
        cn_to_vn=cn_to_vn, vn_to_cn=vn_to_cn,
        var_order=var_order, var_rank=var_rank,
        llr_edge_var=var_order,
        cn_var_slots_sorted=cn_var_slots_sorted,
    )


def _perm_weights(spec: VariantSpec, order: np.ndarray):
    """Per-edge bucket indices re-laid into an edge order (or None)."""
    beta = (None if spec.beta_idx is None
            else np.asarray(spec.beta_idx)[order])
    alpha = (None if spec.alpha_idx is None
             else np.asarray(spec.alpha_idx)[order])
    return beta, alpha


@partial(jax.jit, static_argnames=("bg", "spec", "max_iterations", "ste",
                                   "return_trajectory", "check_every",
                                   "dtype"))
def bucketed_decode_batch(
    llr: jnp.ndarray,            # [B, n]
    weights,                     # {'beta': [T, n_beta], 'alpha': [T, n_alpha]}
    *,
    bg: BucketedGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
    check_every: int = 1,
    dtype=jnp.float32,
) -> DecodeResult:
    """Flooding decode via degree buckets; contract == ``decode_batch``
    (with ``check_every`` freezing granularity as in ``qc_decode_batch``).

    ``dtype`` is the MESSAGE-STATE dtype: the two [E, B] permutations per
    iteration and the scan carry move in it (bf16 halves the dominant
    data movement — the open bucketed-engine perf thread), while all CN/VN
    arithmetic widens to float32 first. f32 (default) is bit-exact with
    ``decode_batch``."""
    T = max_iterations
    if T % check_every:
        raise ValueError(f"check_every={check_every} must divide T={T}")
    graph = bg.graph
    llr_T = llr.T.astype(jnp.float32)             # [n, B] real var order
    llr_s = llr_T[jnp.asarray(bg.var_order)]      # [n, B] sorted-var order
    B = llr_T.shape[-1]
    E = graph.num_edges

    beta_cn, alpha_cn = _perm_weights(spec, bg.cn_order)
    _, alpha_vn = _perm_weights(spec, bg.vn_order)
    cn_to_vn = jnp.asarray(bg.cn_to_vn)
    vn_to_cn = jnp.asarray(bg.vn_to_cn)

    # init v2c in VN-sorted order: each sorted var's llr row repeated over
    # its bucket's degree — pure contiguous broadcast, no gather
    def llr_rows_vn():
        parts = []
        voff = 0
        for d, cnt, off in bg.vn_buckets:
            rows = jax.lax.slice_in_dim(llr_s, voff, voff + cnt)  # [cnt, B]
            parts.append(jnp.broadcast_to(rows[:, None, :],
                                          (cnt, d, B)).reshape(cnt * d, B))
            voff += cnt
        return jnp.concatenate(parts, axis=0)  # [E, B] VN-sorted

    llr_e_vn = llr_rows_vn()
    v2c_cn0 = llr_e_vn.astype(dtype)[vn_to_cn]  # CN-sorted initial msgs

    def cn_update(v2c_cn, x, qdq):
        """All CN buckets; returns c2v in CN-sorted order."""
        outs = []
        coff = 0  # check offset within the sorted-check sequence
        for d, cnt, off in bg.cn_buckets:
            blk = jax.lax.slice_in_dim(v2c_cn, off, off + cnt * d)
            msgs = blk.reshape(cnt, d, B).astype(jnp.float32)
            mag = jnp.abs(msgs)
            min1 = jnp.min(mag, axis=1)
            argmin = jnp.argmin(mag, axis=1)
            slot_iota = jax.lax.broadcasted_iota(jnp.int32, mag.shape, 1)
            is_min = slot_iota == argmin[:, None, :]
            if d > 1:
                min2 = jnp.min(jnp.where(is_min, jnp.float32(jnp.inf), mag),
                               axis=1)
            else:
                min2 = min1  # degree-1 checks (ldpc_decoder.py:112-115)
            neg = (msgs < 0).astype(jnp.int32)
            neg_cnt = jnp.sum(neg, axis=1, keepdims=True)
            loo_sign = 1.0 - 2.0 * ((neg_cnt - neg) & 1).astype(jnp.float32)
            loo_mag = jnp.where(is_min, min2[:, None, :], min1[:, None, :])

            if beta_cn is not None:
                b_col = x["beta"][jnp.asarray(
                    beta_cn[off:off + cnt * d])].reshape(cnt, d, 1)
            else:
                b_col = jnp.float32(spec.fixed_beta)
            if alpha_cn is not None and spec.alpha_in_cn:
                a_col = x["alpha"][jnp.asarray(
                    alpha_cn[off:off + cnt * d])].reshape(cnt, d, 1)
            else:
                a_col = jnp.float32(0.0 if spec.alpha_in_cn
                                    else spec.fixed_alpha)

            if spec.kind == "nms":
                c2v = b_col * loo_sign * loo_mag
            elif spec.kind == "oms":
                off_t = jax.nn.relu(loo_mag - b_col)
                if spec.alpha_in_cn:
                    off_t = off_t - a_col
                c2v = loo_sign * off_t
            elif spec.kind == "rcq":
                c2v = qdq(loo_sign * loo_mag)
            elif spec.kind == "wrcq":
                c2v = qdq(b_col * loo_sign * loo_mag)
            else:  # orcq: W-OMS-RCQ (paper §VII-B)
                off_t = jax.nn.relu(loo_mag - b_col)
                if spec.alpha_in_cn:
                    off_t = off_t - a_col
                c2v = qdq(loo_sign * off_t)
            outs.append(c2v.reshape(cnt * d, B))
            coff += cnt
        return jnp.concatenate(outs, axis=0)

    def vn_update(c2v_vn, x, vqdq):
        """All VN buckets; returns (v2c VN-sorted, posterior sorted-var)."""
        v2c_parts = []
        post_parts = []
        voff = 0
        for d, cnt, off in bg.vn_buckets:
            blk = jax.lax.slice_in_dim(c2v_vn, off, off + cnt * d)
            msgs = blk.reshape(cnt, d, B).astype(jnp.float32)
            colsum = jnp.sum(msgs, axis=1)                     # [cnt, B]
            rows = jax.lax.slice_in_dim(llr_s, voff, voff + cnt)
            post_parts.append(rows + colsum)
            ext = colsum[:, None, :] - msgs
            if alpha_vn is not None and not spec.alpha_in_cn:
                a_col = x["alpha"][jnp.asarray(
                    alpha_vn[off:off + cnt * d])].reshape(cnt, d, 1)
            elif not spec.alpha_in_cn:
                a_col = jnp.float32(spec.fixed_alpha)
            else:
                a_col = None
            if a_col is None:
                v2c = rows[:, None, :] + ext
            else:
                v2c = rows[:, None, :] + a_col * ext
            if vqdq is not None:
                v2c = vqdq(v2c)
            v2c_parts.append(v2c.reshape(cnt * d, B))
            voff += cnt
        posterior = jnp.concatenate(post_parts, axis=0)        # [n, B] sorted
        if vqdq is not None:
            posterior = vqdq(posterior)
        return jnp.concatenate(v2c_parts, axis=0), posterior

    def syndrome_ok_sorted(bits_sorted):
        """bits in sorted-var order [n, B] -> [B] all-checks-zero."""
        bits_ext = jnp.concatenate(
            [bits_sorted, jnp.zeros((1, B), bits_sorted.dtype)], axis=0)
        parity = jnp.sum(
            bits_ext[jnp.asarray(bg.cn_var_slots_sorted)], axis=1) % 2
        return ~jnp.any(parity > 0, axis=0)

    carry0 = dict(
        v2c=v2c_cn0,
        post=llr_s,
        done=jnp.zeros((B,), bool),
        iters=jnp.zeros((B,), jnp.int32),
    )

    k = check_every
    xs = _scan_xs(spec, weights, T)
    if k > 1:
        xs = jax.tree_util.tree_map(
            lambda a: a.reshape((T // k, k) + a.shape[1:]), xs)
    inv_var = jnp.asarray(bg.var_rank)  # sorted -> real: post_s[var_rank]

    def body(carry, xc):
        def inner(state, x):
            v2c_cn, _ = state
            qdq = _make_qdq(spec, x, ste, v2c=False)
            vqdq = _make_qdq(spec, x, ste, v2c=True)
            c2v_cn = cn_update(v2c_cn, x, qdq)
            c2v_vn = c2v_cn.astype(dtype)[cn_to_vn]
            v2c_vn, post_s = vn_update(c2v_vn, x, vqdq)
            v2c_cn = v2c_vn.astype(dtype)[vn_to_cn]
            ys = post_s[inv_var].T if return_trajectory else None
            return (v2c_cn, post_s), ys

        xc_stacked = (xc if k > 1 else
                      jax.tree_util.tree_map(lambda a: a[None], xc))
        (v2c_cn, post_s), posts = jax.lax.scan(
            inner, (carry["v2c"], carry["post"]), xc_stacked)
        t_last = xc["t"] if k == 1 else xc["t"][-1]
        bits = (post_s < 0).astype(jnp.int32)
        ok = syndrome_ok_sorted(bits)
        done_prev = carry["done"]
        post_out = jnp.where(done_prev[None, :], carry["post"], post_s)
        iters = jnp.where(done_prev, carry["iters"], t_last + 1)
        return dict(v2c=v2c_cn, post=post_out, done=done_prev | ok,
                    iters=iters), posts

    carry, ys = jax.lax.scan(body, carry0, xs)
    if return_trajectory:
        ys = ys.reshape((T,) + ys.shape[2:])
    post = carry["post"][inv_var].T  # sorted -> real var order, then [B, n]
    bits = (post < 0).astype(jnp.int32)
    return DecodeResult(
        bits=bits, posterior=post, iterations=carry["iters"],
        success=carry["done"],
        posteriors_all=ys if return_trajectory else None,
    )
