"""Batched LDPC decode engine — one engine, many variants.

The reference implements seven near-duplicate decoder classes, each a nest of
per-node Python loops over a dense H (e.g. ``ldpc_decoder.py:79-153``,
``neural_2d_decoder.py:133-225``). Here there is ONE engine built from
edge-parallel array ops over the padded slot tables of
:class:`ldpc_tpu.codes.DecoderGraph`:

- check-node update: gather v2c into ``[m, max_dc, B]`` slots, running
  (min1, argmin, min2) reduction + sign product, leave-one-out by select;
- variant transform (NMS scale / OMS offset / RCQ quantize-dequantize) applied
  edge-parallel with per-edge weights gathered from dense ``[T, buckets]``
  tables (replacing the reference's string-keyed ``ParameterDict``);
- variable-node update: column sums via zero-padded gather, leave-one-out by
  subtraction;
- ``lax.scan`` over iterations, convergence handled as a frozen-output mask
  (no data-dependent control flow — SPMD/vmap/jit friendly).

Internal layout is ``[nodes/edges, B]`` — batch on the minor dimension, so
every gather/scatter moves contiguous rows.

Behavioral contract matches SURVEY.md §2b: init v2c from channel LLRs; per
iteration {CN update, VN update, posterior, syndrome, early exit}; decision
``bits = posterior < 0``; returns (bits, posterior, iterations, success) with
``iterations = first converged iteration + 1`` or ``max_iterations``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.codes import DecoderGraph
from ldpc_tpu.quantizer import (
    power_qdq,
    power_qdq_ste,
    staircase_qdq,
    staircase_qdq_ste,
    uniform_qdq,
    uniform_qdq_ste,
)

__all__ = ["VariantSpec", "DecodeResult", "decode_batch", "decode_batch_layered",
           "make_layers"]

# python float, NOT a jnp scalar: a module-level jnp constant
# forces backend init at import; where/full_like accept python scalars
_INF = float("inf")


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: static jit arg
class VariantSpec:
    """Static wiring of a decoder variant.

    ``kind``:
      - ``'nms'``  — c2v = beta * sign * mag  (basic min-sum, N-NMS, N-2D-NMS)
      - ``'oms'``  — c2v = sign * (relu(mag - beta) - alpha_cn)
                     (N-OMS with alpha_cn = 0; N-2D-OMS per
                     ``neural_2d_decoder.py:400-401``)
      - ``'rcq'``  — c2v = qdq(sign * mag)         (``rcq_decoder.py:244-246``)
      - ``'wrcq'`` — c2v = qdq(beta * sign * mag)  (``rcq_decoder.py:559-563``)
      - ``'orcq'`` — c2v = qdq(sign * (relu(mag - beta) - alpha_cn)) —
                     W-OMS-RCQ, the paper's FPGA headline decoder (§VII-B,
                     Table III); absent from the reference, whose
                     ``WeightedRCQDecoder`` is beta-multiply only

    ``beta_idx`` / ``alpha_idx``: per-edge int32 bucket indices into the
    trainable ``weights['beta'][T, n_beta]`` / ``weights['alpha'][T, n_alpha]``
    tables, or None for a fixed scalar (``fixed_beta`` / ``fixed_alpha``).

    ``alpha_in_cn``: True for OMS variants (alpha subtracts inside the CN
    transform); False for NMS/W-RCQ variants (alpha scales the VN sum, per
    ``neural_2d_decoder.py:203`` / ``rcq_decoder.py:575``).

    ``thresholds``: [T, L] per-iteration quantizer LUT (RCQ/W-RCQ), else None.

    ``v2c_thresholds``: optional [T, Lv] LUT for bv-bit V2C/posterior
    quantization — the reference accepts ``bv`` but never uses it
    (``rcq_decoder.py:143,374``, SURVEY §8.5); we implement it for real as the
    paper's msRCQ intends.
    """

    kind: str
    beta_idx: Optional[np.ndarray] = None
    alpha_idx: Optional[np.ndarray] = None
    fixed_beta: float = 0.7
    fixed_alpha: float = 1.0
    n_beta: int = 0
    n_alpha: int = 0
    alpha_in_cn: bool = False
    thresholds: Optional[np.ndarray] = None
    v2c_thresholds: Optional[np.ndarray] = None
    # power-law fast path: when the quantizer family is tau_j = C*(j/M)^gamma
    # (every quantizer in this framework), qdq is computed closed-form
    # elementwise (quantizer.power_qdq) instead of via the LUT — the LUT
    # forms gather/compare over L entries per message.
    # qparams: [T, 2] per-iteration (C, gamma); q_levels = 2^(bc-1).
    qparams: Optional[np.ndarray] = None
    q_levels: int = 0
    v2c_qparams: Optional[np.ndarray] = None
    v2c_levels: int = 0
    # force the closed-form qdq for SMALL LUTs too (all engines AND the
    # fused kernels read this, keeping the three implementations
    # bit-exact). Exists for bc>=5: the exact small-LUT forms make the
    # fused kernel's Mosaic compile pathological (>35 min), while the
    # closed form picks the identical quantizer index in O(1) ops.
    closed_qdq: bool = False

    def __post_init__(self):
        if self.kind not in ("nms", "oms", "rcq", "wrcq", "orcq"):
            raise ValueError(f"unknown variant kind {self.kind!r}")


class DecodeResult(NamedTuple):
    bits: jnp.ndarray        # [B, n] int32 hard decisions
    posterior: jnp.ndarray   # [B, n] float posterior LLRs (at convergence)
    iterations: jnp.ndarray  # [B] int32, first-converged iter + 1 or T
    success: jnp.ndarray     # [B] bool, syndrome == 0
    posteriors_all: Optional[jnp.ndarray] = None  # [T, B, n] if requested


def _per_edge_weights(spec: VariantSpec, weights, t_beta, t_alpha):
    """Resolve this iteration's per-edge beta/alpha vectors ([E] or scalar)."""
    if spec.beta_idx is not None:
        beta_e = t_beta[jnp.asarray(spec.beta_idx)]
    else:
        beta_e = jnp.float32(spec.fixed_beta)
    if spec.alpha_idx is not None:
        alpha_e = t_alpha[jnp.asarray(spec.alpha_idx)]
    else:
        alpha_e = jnp.float32(spec.fixed_alpha)
    return beta_e, alpha_e


def _make_qdq(spec: VariantSpec, x, ste: bool, v2c: bool):
    """Resolve this iteration's quantize∘dequantize callable (or None).

    Small LUTs (levels <= 16, i.e. bc <= 5) use the exact broadcast-compare
    path — bit-identical to the reference's threshold scan, and only L
    compares wide. Large LUTs (bv=8 -> L=128) use the closed-form power-law
    path (``quantizer.power_qdq``): elementwise math instead of a 128x
    compare blowup or per-element dynamic gathers, at the cost of <=1 ulp
    reconstruction rounding on knife-edge inputs (measure-zero for message
    arithmetic).
    """
    if v2c:
        qparams, levels, thr_key, qp_key = (
            spec.v2c_qparams, spec.v2c_levels, "vthr", "vqp")
        if spec.v2c_qparams is None and spec.v2c_thresholds is None:
            return None
    else:
        if spec.kind not in ("rcq", "wrcq", "orcq"):
            return None
        qparams, levels, thr_key, qp_key = (
            spec.qparams, spec.q_levels, "thr", "qp")
    if qparams is not None and (spec.closed_qdq or levels > 16):
        if np.all(np.asarray(qparams)[:, 1] == 1.0):
            # gamma == 1 for every iteration (static): uniform thresholds —
            # pure arithmetic, no transcendentals (quantizer.uniform_qdq)
            f = uniform_qdq_ste if ste else uniform_qdq
            return lambda v: f(v, x[qp_key][0], levels)
        f = power_qdq_ste if ste else power_qdq
        return lambda v: f(v, x[qp_key][0], x[qp_key][1], levels)
    f = staircase_qdq_ste if ste else staircase_qdq
    return lambda v: f(v, x[thr_key])


def _cn_update(
    v2c_ext: jnp.ndarray,  # [E+1, B]
    graph: DecoderGraph,
    spec: VariantSpec,
    beta_e,                # [E] or scalar
    alpha_e,               # [E] or scalar (OMS only)
    qdq,                   # callable or None: this iteration's quantizer
) -> jnp.ndarray:
    """One flooding check-node update; returns c2v [E, B]."""
    cn_slots = jnp.asarray(graph.cn_slots)          # [m, max_dc]
    cn_mask = jnp.asarray(graph.cn_mask)[..., None]  # [m, max_dc, 1]

    msgs = v2c_ext[cn_slots]                         # [m, max_dc, B]
    mag = jnp.where(cn_mask, jnp.abs(msgs), _INF)

    min1 = jnp.min(mag, axis=1)                      # [m, B]
    argmin = jnp.argmin(mag, axis=1)                 # [m, B] first-min, as torch
    slot_iota = jax.lax.broadcasted_iota(jnp.int32, mag.shape, 1)
    is_min = slot_iota == argmin[:, None, :]
    mag2 = jnp.where(is_min, _INF, mag)
    min2 = jnp.min(mag2, axis=1)
    # degree-1 checks: reference sets min2 = min1 (ldpc_decoder.py:112-115)
    min2 = jnp.where(jnp.isinf(min2), min1, min2)

    # leave-one-out sign via negative-count parity (integer adds + bit-and
    # instead of a float product of signs)
    neg = ((msgs < 0) & cn_mask).astype(jnp.int32)   # [m, max_dc, B]
    neg_cnt = jnp.sum(neg, axis=1, keepdims=True)    # [m, 1, B]
    loo_sign = 1.0 - 2.0 * ((neg_cnt - neg) & 1).astype(jnp.float32)
    loo_mag = jnp.where(is_min, min2[:, None, :], min1[:, None, :])

    # back to edge order (pure gather via precomputed inverse slots)
    flat = graph.m * graph.max_dc
    sign_e = loo_sign.reshape(flat, -1)[jnp.asarray(graph.edge_cn_slot)]  # [E, B]
    mag_e = loo_mag.reshape(flat, -1)[jnp.asarray(graph.edge_cn_slot)]    # [E, B]

    beta_col = beta_e[:, None] if jnp.ndim(beta_e) else beta_e
    alpha_col = alpha_e[:, None] if jnp.ndim(alpha_e) else alpha_e

    if spec.kind == "nms":
        c2v = beta_col * sign_e * mag_e
    elif spec.kind == "oms":
        # N-OMS: sign * relu(mag - beta); N-2D-OMS additionally subtracts
        # alpha inside the CN (neural_2d_decoder.py:400-401)
        off = jax.nn.relu(mag_e - beta_col)
        if spec.alpha_in_cn:
            off = off - alpha_col
        c2v = sign_e * off
    elif spec.kind == "rcq":
        c2v = qdq(sign_e * mag_e)
    elif spec.kind == "wrcq":
        c2v = qdq(beta_col * sign_e * mag_e)
    elif spec.kind == "orcq":
        off = jax.nn.relu(mag_e - beta_col)
        if spec.alpha_in_cn:
            off = off - alpha_col
        c2v = qdq(sign_e * off)
    else:  # pragma: no cover
        raise AssertionError(spec.kind)
    return c2v


def _vn_update(
    c2v: jnp.ndarray,   # [E, B]
    llr_T: jnp.ndarray,  # [n, B]
    graph: DecoderGraph,
    spec: VariantSpec,
    alpha_e,             # [E] or scalar
    vqdq,                # callable or None: bv-bit V2C/posterior quantizer
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Variable-node update; returns (v2c [E, B], posterior [n, B])."""
    B = c2v.shape[-1]
    c2v_ext = jnp.concatenate([c2v, jnp.zeros((1, B), c2v.dtype)], axis=0)
    colsum = jnp.sum(c2v_ext[jnp.asarray(graph.vn_slots)], axis=1)  # [n, B]
    posterior = llr_T + colsum  # plain sum, no alpha (neural_2d_decoder.py:206-209)

    edge_var = jnp.asarray(graph.edge_var)
    ext = colsum[edge_var] - c2v  # leave-one-out by subtraction
    alpha_col = alpha_e[:, None] if jnp.ndim(alpha_e) else alpha_e
    if spec.alpha_in_cn:  # OMS variants: VN is unweighted
        v2c = llr_T[edge_var] + ext
    else:
        v2c = llr_T[edge_var] + alpha_col * ext

    if vqdq is not None:
        v2c = vqdq(v2c)
        posterior = vqdq(posterior)
    return v2c, posterior


def _syndrome_ok(bits: jnp.ndarray, graph: DecoderGraph) -> jnp.ndarray:
    """bits [n, B] int32 -> success [B] (all parity checks zero)."""
    B = bits.shape[-1]
    bits_ext = jnp.concatenate([bits, jnp.zeros((1, B), bits.dtype)], axis=0)
    parity = jnp.sum(bits_ext[jnp.asarray(graph.cn_var_slots)], axis=1) % 2
    return ~jnp.any(parity > 0, axis=0)


def _scan_xs(spec: VariantSpec, weights, T: int):
    """Stacked per-iteration inputs for lax.scan."""
    xs = {}
    xs["beta"] = (weights["beta"] if spec.beta_idx is not None
                  else jnp.zeros((T, 1), jnp.float32))
    xs["alpha"] = (weights["alpha"] if spec.alpha_idx is not None
                   else jnp.zeros((T, 1), jnp.float32))
    xs["thr"] = (jnp.asarray(spec.thresholds) if spec.thresholds is not None
                 else jnp.zeros((T, 1), jnp.float32))
    xs["vthr"] = (jnp.asarray(spec.v2c_thresholds)
                  if spec.v2c_thresholds is not None
                  else jnp.zeros((T, 1), jnp.float32))
    xs["qp"] = (jnp.asarray(spec.qparams) if spec.qparams is not None
                else jnp.zeros((T, 2), jnp.float32))
    xs["vqp"] = (jnp.asarray(spec.v2c_qparams)
                 if spec.v2c_qparams is not None
                 else jnp.zeros((T, 2), jnp.float32))
    xs["t"] = jnp.arange(T, dtype=jnp.int32)
    return xs


@partial(jax.jit, static_argnames=("graph", "spec", "max_iterations", "ste",
                                   "return_trajectory"))
def decode_batch(
    llr: jnp.ndarray,            # [B, n] channel LLRs
    weights,                     # {'beta': [T, n_beta], 'alpha': [T, n_alpha]}
    *,
    graph: DecoderGraph,
    spec: VariantSpec,
    max_iterations: int,
    ste: bool = False,
    return_trajectory: bool = False,
) -> DecodeResult:
    """Flooding-schedule batched decode of ``llr`` [B, n].

    Differentiable w.r.t. ``weights`` (STE through quantizers when
    ``ste=True``); early exit realized as output freezing, so per-frame
    ``iterations`` matches the reference's first-convergence contract.
    """
    T = max_iterations
    llr_T = llr.T.astype(jnp.float32)  # [n, B]
    B = llr_T.shape[-1]
    E = graph.num_edges

    edge_var = jnp.asarray(graph.edge_var)
    v2c0 = llr_T[edge_var]  # init per-edge with channel LLR (§2b step 2)

    def pad(x):
        return jnp.concatenate([x, jnp.zeros((1, B), x.dtype)], axis=0)

    carry0 = dict(
        v2c=v2c0,
        post=llr_T,
        done=jnp.zeros((B,), bool),
        iters=jnp.zeros((B,), jnp.int32),
    )

    def body(carry, x):
        beta_e, alpha_e = _per_edge_weights(spec, None, x["beta"], x["alpha"])
        qdq = _make_qdq(spec, x, ste, v2c=False)
        vqdq = _make_qdq(spec, x, ste, v2c=True)

        c2v = _cn_update(pad(carry["v2c"]), graph, spec, beta_e, alpha_e, qdq)
        v2c, post = _vn_update(c2v, llr_T, graph, spec, alpha_e, vqdq)
        bits = (post < 0).astype(jnp.int32)
        ok = _syndrome_ok(bits, graph)

        done_prev = carry["done"]
        post_out = jnp.where(done_prev[None, :], carry["post"], post)
        iters = jnp.where(done_prev, carry["iters"], x["t"] + 1)
        done = done_prev | ok
        new = dict(v2c=v2c, post=post_out, done=done, iters=iters)
        ys = post.T if return_trajectory else None
        return new, ys

    carry, ys = jax.lax.scan(body, carry0, _scan_xs(spec, weights, T))

    post = carry["post"].T  # [B, n]
    bits = (post < 0).astype(jnp.int32)
    return DecodeResult(
        bits=bits,
        posterior=post,
        iterations=carry["iters"],
        success=carry["done"],
        posteriors_all=ys if return_trajectory else None,
    )


# ---------------------------------------------------------------------------
# Layered schedule
# ---------------------------------------------------------------------------


def make_layers(graph: DecoderGraph, num_layers: Optional[int] = None):
    """Partition checks into layers for layered decoding.

    Greedy: checks are assigned to the first layer in which they share no
    variable with an already-placed check (classic row-layering); extra empty
    layers are never created beyond ``num_layers`` if given (then collisions
    are tolerated — still correct, just less sequential benefit). Returns
    ``layer_checks [L, m_per_layer]`` padded with ``m`` (a dummy check).

    This replaces the reference's broken ``_decode_layered``
    (``rcq_decoder.py:281-350``), which re-zeroes the entire c2v matrix
    inside the per-check loop (SURVEY §8.3).
    """
    m = graph.m
    var_sets = [set(graph.cn_var_slots[i][graph.cn_mask[i]].tolist())
                for i in range(m)]
    layers: list[list[int]] = []
    layer_vars: list[set] = []
    for i in range(m):
        placed = False
        for li, lv in enumerate(layer_vars):
            if not (lv & var_sets[i]):
                layers[li].append(i)
                lv.update(var_sets[i])
                placed = True
                break
        if not placed:
            if num_layers is not None and len(layers) >= num_layers:
                # tolerate collision in the smallest layer
                li = min(range(len(layers)), key=lambda x: len(layers[x]))
                layers[li].append(i)
                layer_vars[li].update(var_sets[i])
            else:
                layers.append([i])
                layer_vars.append(set(var_sets[i]))
    width = max(len(l) for l in layers)
    out = np.full((len(layers), width), m, dtype=np.int32)
    for li, l in enumerate(layers):
        out[li, : len(l)] = l
    return out


@partial(jax.jit, static_argnames=("graph", "spec", "max_iterations", "ste",
                                   "layers_key", "return_trajectory"))
def _decode_layered_impl(llr, weights, layer_checks, *, graph, spec,
                         max_iterations, ste, layers_key,
                         return_trajectory=False):
    T = max_iterations
    llr_T = llr.T.astype(jnp.float32)
    B = llr_T.shape[-1]
    E = graph.num_edges
    m = graph.m

    # padded-by-one tables: dummy check row m maps to all-padding slots
    cn_slots_p = jnp.concatenate(
        [jnp.asarray(graph.cn_slots),
         jnp.full((1, graph.max_dc), E, jnp.int32)], axis=0)  # [m+1, max_dc]
    cn_mask_p = jnp.concatenate(
        [jnp.asarray(graph.cn_mask), jnp.zeros((1, graph.max_dc), bool)], axis=0)
    edge_var_p = jnp.concatenate(
        [jnp.asarray(graph.edge_var), jnp.full((1,), graph.n, jnp.int32)])

    edge_beta = (jnp.asarray(spec.beta_idx) if spec.beta_idx is not None else None)
    edge_alpha = (jnp.asarray(spec.alpha_idx) if spec.alpha_idx is not None else None)

    def one_iteration(state, x):
        c2v_ext, colsum, done, iters, post_frozen = state
        beta_t, alpha_t, t = x["beta"], x["alpha"], x["t"]
        qdq = _make_qdq(spec, x, ste, v2c=False)
        vqdq = _make_qdq(spec, x, ste, v2c=True)

        def layer_step(inner, checks):
            c2v_ext, colsum = inner
            slots = cn_slots_p[checks]            # [ml, max_dc] edge ids (pad E)
            mask = cn_mask_p[checks][..., None]   # [ml, max_dc, 1]
            evar = edge_var_p[slots]              # [ml, max_dc] var ids (pad n)

            old = c2v_ext[slots]                  # [ml, max_dc, B]
            colsum_ext = jnp.concatenate(
                [colsum, jnp.zeros((1, B), colsum.dtype)], axis=0)
            llr_ext = jnp.concatenate(
                [llr_T, jnp.zeros((1, B), llr_T.dtype)], axis=0)
            # fresh v2c from the *current* posterior state (layered semantics)
            if edge_alpha is not None and not spec.alpha_in_cn:
                a_e = alpha_t[edge_alpha]
                a_e = jnp.concatenate([a_e, jnp.zeros((1,), a_e.dtype)])[slots]
                a_col = a_e[..., None]
            elif not spec.alpha_in_cn:
                a_col = jnp.float32(spec.fixed_alpha)
            else:
                a_col = 1.0
            v2c = llr_ext[evar] + a_col * (colsum_ext[evar] - old)

            mag = jnp.where(mask, jnp.abs(v2c), _INF)
            min1 = jnp.min(mag, axis=1)
            argmin = jnp.argmin(mag, axis=1)
            slot_iota = jax.lax.broadcasted_iota(jnp.int32, mag.shape, 1)
            is_min = slot_iota == argmin[:, None, :]
            min2 = jnp.min(jnp.where(is_min, _INF, mag), axis=1)
            min2 = jnp.where(jnp.isinf(min2), min1, min2)
            # negative-count parity (see _cn_update for why not a float prod)
            neg = ((v2c < 0) & mask).astype(jnp.int32)
            neg_cnt = jnp.sum(neg, axis=1, keepdims=True)
            loo_sign = 1.0 - 2.0 * ((neg_cnt - neg) & 1).astype(jnp.float32)
            loo_mag = jnp.where(is_min, min2[:, None, :], min1[:, None, :])

            if edge_beta is not None:
                b_e = beta_t[edge_beta]
                b_e = jnp.concatenate([b_e, jnp.zeros((1,), b_e.dtype)])[slots]
                b_col = b_e[..., None]
            else:
                b_col = jnp.float32(spec.fixed_beta)
            if edge_alpha is not None and spec.alpha_in_cn:
                ac_e = alpha_t[edge_alpha]
                ac_e = jnp.concatenate([ac_e, jnp.zeros((1,), ac_e.dtype)])[slots]
                ac_col = ac_e[..., None]
            else:
                ac_col = jnp.float32(0.0 if spec.alpha_in_cn else spec.fixed_alpha)

            if spec.kind == "nms":
                new = b_col * loo_sign * loo_mag
            elif spec.kind == "oms":
                off = jax.nn.relu(loo_mag - b_col)
                if spec.alpha_in_cn:
                    off = off - ac_col
                new = loo_sign * off
            elif spec.kind == "rcq":
                new = qdq(loo_sign * loo_mag)
            elif spec.kind == "wrcq":
                new = qdq(b_col * loo_sign * loo_mag)
            else:  # orcq
                off = jax.nn.relu(loo_mag - b_col)
                if spec.alpha_in_cn:
                    off = off - ac_col
                new = qdq(loo_sign * off)
            new = jnp.where(mask, new, 0.0)

            delta = (new - jnp.where(mask, old, 0.0)).reshape(-1, B)
            evar_flat = evar.reshape(-1)
            colsum = jnp.concatenate(
                [colsum, jnp.zeros((1, B), colsum.dtype)], axis=0
            ).at[evar_flat].add(delta)[:-1]
            c2v_ext = c2v_ext.at[slots.reshape(-1)].set(new.reshape(-1, B))
            # restore the padding row to zero (pad writes land on row E)
            c2v_ext = c2v_ext.at[E].set(0.0)
            return (c2v_ext, colsum), None

        (c2v_ext, colsum), _ = jax.lax.scan(
            layer_step, (c2v_ext, colsum), jnp.asarray(layer_checks))

        post = llr_T + colsum
        if vqdq is not None:
            post = vqdq(post)
        bits = (post < 0).astype(jnp.int32)
        ok = _syndrome_ok(bits, graph)
        post_out = jnp.where(done[None, :], post_frozen, post)
        iters = jnp.where(done, iters, t + 1)
        done = done | ok
        ys = post.T if return_trajectory else None
        return (c2v_ext, colsum, done, iters, post_out), ys

    c2v_ext0 = jnp.zeros((E + 1, B), jnp.float32)
    colsum0 = jnp.zeros((graph.n, B), jnp.float32)
    state0 = (c2v_ext0, colsum0, jnp.zeros((B,), bool),
              jnp.zeros((B,), jnp.int32), llr_T)
    state, ys = jax.lax.scan(one_iteration, state0,
                             _scan_xs(spec, weights, T))
    _, _, done, iters, post = state
    post = post.T
    bits = (post < 0).astype(jnp.int32)
    return DecodeResult(bits=bits, posterior=post, iterations=iters,
                        success=done,
                        posteriors_all=ys if return_trajectory else None)


def decode_batch_layered(llr, weights, layer_checks, *, graph, spec,
                         max_iterations, ste=False,
                         return_trajectory=False):
    """Layered-schedule batched decode.

    Correct layered semantics — persistent per-edge c2v memory and an
    incrementally-maintained posterior/column-sum, updated layer by layer —
    i.e. what the reference's ``_decode_layered`` *tried* to do
    (``rcq_decoder.py:281-350``) before zeroing its own message memory
    (SURVEY §8.3). ``return_trajectory`` exposes every iteration's
    end-of-sweep posterior so posterior-joint training works on layered
    decoders too.
    """
    return _decode_layered_impl(
        llr, weights, np.asarray(layer_checks), graph=graph, spec=spec,
        max_iterations=max_iterations, ste=ste,
        return_trajectory=return_trajectory,
        layers_key=(layer_checks.shape if hasattr(layer_checks, "shape")
                    else len(layer_checks)),
    )
