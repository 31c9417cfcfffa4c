"""Decoder variant registry: wiring + weight initialization + param counts.

Replaces the reference's seven near-duplicate decoder classes
(``ldpc_decoder.py``, ``neural_minsum_decoder.py``, ``neural_2d_decoder.py``,
``rcq_decoder.py``) with one spec builder over the shared engine.

Weight-sharing types (paper Table I; reference ``neural_2d_decoder.py:46-131``):

====  =======================================  =========================
type  beta (CN weight) keyed by                alpha (VN weight) keyed by
====  =======================================  =========================
0     every edge (N-NMS / N-OMS)               — (1.0 / 0.0)
1     (deg(c), deg(v)) pair, full cartesian    — fixed
2     deg(c)                                   deg(v)
3     deg(c)                                   — fixed
4     — fixed (0.7 NMS / 0.0 OMS)              deg(v)
====  =======================================  =========================

Bucket universes for type 1 are the full cartesian product of unique degrees
(present or not), matching the reference's parameter counts exactly
(goldens: 130/40/40/20/20 params for N-NMS / types 1-4 on the (7,4) code at
10 iterations, ``IMPLEMENTATION_SUMMARY.md:165-172``).

Initialization matches the reference:
- N-NMS: ``0.7 + 0.1*randn`` (``neural_minsum_decoder.py:53``)
- N-OMS beta, all 2D types, W-RCQ: ``0.1*randn``
  (``neural_minsum_decoder.py``, ``neural_2d_decoder.py:54-79``,
  ``rcq_decoder.py:398-431``)
``init='nms'`` additionally offsets shared betas by +0.7 / alphas by +1.0 so
an *untrained* decoder behaves like normalized min-sum (the reference's
near-zero init makes untrained 2D decoders emit near-zero messages —
SURVEY §2a note).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.codes import DecoderGraph, LDPCCode, build_graph
from ldpc_tpu.decode.engine import (
    DecodeResult,
    VariantSpec,
    decode_batch,
    decode_batch_layered,
    make_layers,
)
from ldpc_tpu.decode.qc_engine import (
    QCGraph,
    build_qc_graph,
    qc_decode_batch,
    qc_decode_batch_layered,
)
from ldpc_tpu.quantizer import (
    stack_quantizer_params,
    stack_quantizer_thresholds,
)

__all__ = [
    "Decoder",
    "make_decoder",
    "basic_min_sum",
    "neural_min_sum",
    "neural_offset_min_sum",
    "neural_2d_min_sum",
    "neural_2d_offset_min_sum",
    "rcq_min_sum",
    "weighted_rcq",
    "weighted_oms_rcq",
    "param_count",
]


def _bucket_wiring(graph: DecoderGraph, sharing_type: int, offset_style: bool):
    """Return (beta_idx, n_beta, alpha_idx, n_alpha, fixed_beta, fixed_alpha,
    alpha_in_cn) for a sharing type."""
    n_dc = len(graph.unique_dc)
    n_dv = len(graph.unique_dv)
    fixed_beta = 0.0 if offset_style else 0.7
    fixed_alpha = 0.0 if offset_style else 1.0
    if sharing_type == 0:
        E = graph.num_edges
        return (np.arange(E, dtype=np.int32), E, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 1:
        return (graph.edge_dcdv_bucket, n_dc * n_dv, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 2:
        return (graph.edge_dc_bucket, n_dc, graph.edge_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 3:
        return (graph.edge_dc_bucket, n_dc, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 4:
        return (None, 0, graph.edge_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    raise ValueError(f"Invalid weight sharing type: {sharing_type}")


def _qc_bucket_wiring(qc: QCGraph, sharing_type: int, offset_style: bool):
    """Per-BLOCK analogue of :func:`_bucket_wiring` for the QC fast path.

    Bucket universes are identical to the lifted graph's (a lifted node's
    degree equals its protograph node's degree), so weight tables are
    interchangeable between the two engines.
    """
    n_dc = len(qc.unique_dc)
    n_dv = len(qc.unique_dv)
    fixed_beta = 0.0 if offset_style else 0.7
    fixed_alpha = 0.0 if offset_style else 1.0
    if sharing_type == 0:
        raise ValueError(
            "per-edge (type 0) weights are not block-constant; use the "
            "general engine for N-NMS/N-OMS on QC codes")
    if sharing_type == 1:
        return (qc.block_dcdv_bucket, n_dc * n_dv, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 2:
        return (qc.block_dc_bucket, n_dc, qc.block_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 3:
        return (qc.block_dc_bucket, n_dc, None, 0,
                fixed_beta, fixed_alpha, offset_style)
    if sharing_type == 4:
        return (None, 0, qc.block_dv_bucket, n_dv,
                fixed_beta, fixed_alpha, offset_style)
    raise ValueError(f"Invalid weight sharing type: {sharing_type}")


@dataclasses.dataclass(eq=False)
class Decoder:
    """A configured decoder: static spec + trainable weights + call surface.

    Return contract matches the reference's ``forward``
    (``neural_2d_decoder.py:133-225``): hard bits, posterior, iterations-used,
    plus an explicit per-frame ``success`` flag (the plain decoders' second
    return, ``ldpc_decoder.py:63``).
    """

    name: str
    code: LDPCCode
    graph: DecoderGraph
    spec: VariantSpec
    max_iterations: int
    weights: Dict[str, Optional[jnp.ndarray]]
    layered: bool = False
    layer_checks: Optional[np.ndarray] = None
    qc: Optional[QCGraph] = None  # set -> roll-based QC fast path
    # extra static kwargs for the QC flooding engine (check_every, dtype,
    # unroll — see qc_engine.qc_decode_batch); inference-path tuning only
    qc_options: Optional[dict] = None
    # degree-bucketed fast path for irregular non-QC codes (zero-padding
    # dense reductions; see decode/bucketed_engine.py)
    bucketed_graph: Optional[object] = None
    # the JSON-able make_decoder kwargs that built this decoder — lets
    # ldpc_tpu.zoo persist/rebuild it (None for hand-assembled Decoders)
    recipe: Optional[dict] = None

    def __call__(self, llr: jnp.ndarray, weights=None, *, ste: bool = False,
                 return_trajectory: bool = False) -> DecodeResult:
        """Decode ``llr`` of shape [B, n] (or [n] — auto-promoted)."""
        w = self.weights if weights is None else weights
        squeeze = llr.ndim == 1
        if squeeze:
            llr = llr[None, :]
        if self.layered and self.qc is not None:
            opts = dict(self.qc_options or {})
            if opts.get("fused") and not (ste or return_trajectory):
                from ldpc_tpu.decode.pallas_fused import \
                    qc_fused_decode_batch_layered
                opts.pop("fused")
                opts.pop("check_every", None)
                opts.pop("unroll", None)
                out = qc_fused_decode_batch_layered(
                    llr, w, qc=self.qc, spec=self.spec,
                    max_iterations=self.max_iterations, **opts)
            else:
                # the lean contract (int8 bits, no posterior) is a fused-
                # kernel epilogue option; the training/trajectory fallback
                # always returns the full result in float32
                kw = ({} if ste or return_trajectory or "dtype" not in opts
                      else {"dtype": opts["dtype"]})
                out = qc_decode_batch_layered(
                    llr, w, qc=self.qc, spec=self.spec,
                    max_iterations=self.max_iterations, ste=ste,
                    return_trajectory=return_trajectory, **kw)
        elif self.layered:
            out = decode_batch_layered(
                llr, w, self.layer_checks, graph=self.graph, spec=self.spec,
                max_iterations=self.max_iterations, ste=ste,
                return_trajectory=return_trajectory)
        elif self.qc is not None:
            opts = dict(self.qc_options or {})
            fused = opts.pop("fused", False)
            if ste or return_trajectory:
                # training path: keep per-iteration semantics + f32 grads
                # (the fused kernel is inference-only)
                opts.pop("check_every", None)
                opts.pop("dtype", None)
                opts.pop("batch_tile", None)
                opts.pop("interpret", None)
                opts.pop("lean", None)
                opts.pop("closed_qdq", None)
                fused = False
            if fused:
                # whole-decode Pallas kernel; contract ==
                # qc_decode_batch(check_every=T), so require that schedule
                from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch
                ce = opts.pop("check_every", self.max_iterations)
                if ce != self.max_iterations:
                    raise ValueError(
                        f"fused kernel checks the syndrome once at T="
                        f"{self.max_iterations}; qc_options check_every="
                        f"{ce} is incompatible")
                opts.pop("unroll", None)
                out = qc_fused_decode_batch(
                    llr, w, qc=self.qc, spec=self.spec,
                    max_iterations=self.max_iterations, **opts)
            else:
                for k in ("lean", "closed_qdq", "batch_tile", "interpret"):
                    opts.pop(k, None)      # fused-kernel options only
                out = qc_decode_batch(
                    llr, w, qc=self.qc, spec=self.spec,
                    max_iterations=self.max_iterations, ste=ste,
                    return_trajectory=return_trajectory, **opts)
        elif self.bucketed_graph is not None:
            from ldpc_tpu.decode.bucketed_engine import bucketed_decode_batch
            opts = dict(self.qc_options or {})
            bopts = {k: opts[k] for k in ("dtype", "check_every")
                     if k in opts}
            if ste or return_trajectory:
                bopts.pop("dtype", None)  # training keeps f32 messages
            out = bucketed_decode_batch(
                llr, w, bg=self.bucketed_graph, spec=self.spec,
                max_iterations=self.max_iterations, ste=ste,
                return_trajectory=return_trajectory, **bopts)
        else:
            out = decode_batch(
                llr, w, graph=self.graph, spec=self.spec,
                max_iterations=self.max_iterations, ste=ste,
                return_trajectory=return_trajectory)
        if squeeze:
            out = DecodeResult(
                bits=out.bits[0],
                posterior=(out.posterior[0]
                           if out.posterior is not None else None),
                iterations=out.iterations[0], success=out.success[0],
                posteriors_all=(out.posteriors_all[:, 0]
                                if out.posteriors_all is not None else None))
        return out

    def decode(self, llr: jnp.ndarray):
        """Plain-decoder calling convention (``ldpc_decoder.py:63``):
        returns (bits, success, iterations)."""
        r = self(llr)
        return r.bits, r.success, r.iterations

    def param_count(self) -> int:
        return param_count(self.weights)

    def truncated(self, T1: int) -> "Decoder":
        """A decoder identical to this one for the FIRST ``T1`` iterations
        (weights, quantizer schedule, thresholds all sliced). Because early
        exit freezes a frame at first convergence, any frame converged by
        iteration T1 decodes identically under the truncated and the full
        decoder — the exactness property behind the simulator's
        early-termination wave compaction."""
        if T1 > self.max_iterations:
            raise ValueError(f"T1={T1} > max_iterations={self.max_iterations}")

        def cut(a):
            return None if a is None else a[:T1]

        spec = dataclasses.replace(
            self.spec,
            thresholds=cut(self.spec.thresholds),
            v2c_thresholds=cut(self.spec.v2c_thresholds),
            qparams=cut(self.spec.qparams),
            v2c_qparams=cut(self.spec.v2c_qparams),
        )
        weights = {k: cut(w) for k, w in self.weights.items()}
        opts = dict(self.qc_options or {})
        if opts.get("fused") and T1 != self.max_iterations:
            # the fused kernel's only syndrome check is at T, so any T1 < T
            # checks at an iteration the parent never does
            raise ValueError(
                "cannot truncate a fused-kernel decoder (its check schedule "
                "is {T}); build the truncated stage on the XLA engine")
        ce = opts.get("check_every")
        if ce and T1 % ce:
            # Silently changing the check schedule would break the freezing
            # equivalence this method exists for: the truncated decoder must
            # check the syndrome at exactly the iterations the full decoder
            # does (a prefix of its schedule), or a frame can freeze at an
            # iteration the parent never checks. Callers must pick T1 as a
            # multiple of check_every.
            raise ValueError(
                f"T1={T1} is not a multiple of this decoder's "
                f"check_every={ce}; the truncated decoder would check/freeze "
                "on a different schedule than the full decoder")
        return dataclasses.replace(self, spec=spec, weights=weights,
                                   max_iterations=T1,
                                   qc_options=(opts or None))

    def replace_weights(self, weights) -> "Decoder":
        return dataclasses.replace(self, weights=weights)


def param_count(weights) -> int:
    return int(sum(np.prod(w.shape) for w in jax.tree_util.tree_leaves(weights)))


def _init_weights(
    key: jax.Array,
    T: int,
    n_beta: int,
    n_alpha: int,
    *,
    beta_mean: float,
    alpha_mean: float,
    std: float = 0.1,
) -> Dict[str, Optional[jnp.ndarray]]:
    kb, ka = jax.random.split(key)
    w: Dict[str, Optional[jnp.ndarray]] = {"beta": None, "alpha": None}
    if n_beta:
        w["beta"] = beta_mean + std * jax.random.normal(kb, (T, n_beta))
    if n_alpha:
        w["alpha"] = alpha_mean + std * jax.random.normal(ka, (T, n_alpha))
    return w


def make_decoder(
    code: LDPCCode,
    *,
    kind: str = "nms",
    sharing_type: Optional[int] = None,
    factor: float = 0.7,
    max_iterations: Optional[int] = None,
    bc: int = 3,
    bv: Optional[int] = None,
    quantizer_params: Sequence[Tuple[float, float]] = ((5.0, 1.3),),
    v2c_quantizer_params: Optional[Sequence[Tuple[float, float]]] = None,
    layered: bool = False,
    num_layers: Optional[int] = None,
    init: str = "reference",
    seed: int = 0,
    name: Optional[str] = None,
    graph: Optional[DecoderGraph] = None,
    qc: Optional[QCGraph] = None,
    qc_options: Optional[dict] = None,
    bucketed: bool = False,
    per_layer: bool = False,
    closed_qdq: bool = False,
) -> Decoder:
    """Build any decoder variant.

    kind: 'ms' (fixed factor) | 'nms' | 'oms' | 'rcq' | 'wrcq'.
    sharing_type: None/0 = per-edge (types 0); 1-4 = degree sharing.
    init: 'reference' reproduces the reference's initializers;
          'nms' centers shared weights at NMS-equivalent values.
    bv: if given (with v2c_quantizer_params or reusing quantizer_params),
        actually quantizes V2C messages and posteriors to bv bits — the
        capability the reference's ``bv`` knob pretends to have (SURVEY §8.5).
    qc: a :class:`QCGraph` for quasi-cyclic codes — switches decoding to the
        roll-based QC fast path (no gathers; see ``qc_engine``). Requires
        sharing types 1-4 or weightless kinds ('ms'/'rcq'); per-edge type 0
        needs the general engine. With ``layered=True``, base rows are the
        layers (``qc_decode_batch_layered``).
    bucketed: degree-bucketed fast path for IRREGULAR non-QC codes
        (PBRL/PEG families): CN/VN updates become unpadded dense reductions
        over degree groups (``bucketed_engine``). Flooding only; mutually
        exclusive with ``qc``/``layered``.
    per_layer: give each LAYER (base row) its own weight buckets —
        beta/alpha universes become (row x degree-bucket), multiplying
        the parameter count by ``mb``. Layered neural decoding commonly
        needs layer-specific weights because each layer sees a different
        point of the convergence trajectory within one iteration; plain
        degree sharing forces all rows of an iteration to share. QC
        layered decoders only (the layers are base rows).
    """
    if bucketed and (qc is not None or layered):
        raise ValueError("bucketed engine is flooding-only and non-QC; "
                         "drop bucketed=, or drop qc=/layered=")
    if kind not in ("ms", "nms", "oms", "rcq", "wrcq", "orcq"):
        raise ValueError(
            f"unknown decoder kind {kind!r}; expected one of "
            "'ms', 'nms', 'oms', 'rcq', 'wrcq', 'orcq'")
    if qc is not None and kind in ("nms", "oms", "wrcq", "orcq") and \
            (sharing_type is None or sharing_type == 0):
        raise ValueError("per-edge (type 0) weights need the general "
                         "engine; omit qc= or use sharing types 1-4")
    if per_layer and (qc is None or not layered):
        raise ValueError("per_layer weights need a QC layered decoder "
                         "(layers are base rows); pass qc= and "
                         "layered=True")
    if per_layer and kind in ("ms", "rcq"):
        raise ValueError("per_layer needs a weighted kind "
                         "('nms'/'oms'/'wrcq'/'orcq')")
    graph = graph if graph is not None else build_graph(code)
    T = max_iterations if max_iterations is not None else code.max_iterations
    key = jax.random.PRNGKey(seed)

    offset_style = kind in ("oms", "orcq")
    thresholds = None
    v2c_thresholds = None
    qparams = None
    q_levels = 0
    v2c_qparams = None
    v2c_levels = 0
    if closed_qdq and kind not in ("rcq", "wrcq", "orcq"):
        raise ValueError("closed_qdq only applies to quantized kinds")
    if kind in ("rcq", "wrcq", "orcq"):
        thresholds = stack_quantizer_thresholds(bc, quantizer_params, T)
        qparams = stack_quantizer_params(quantizer_params, T)
        q_levels = 2 ** (bc - 1)
    if bv is not None and kind in ("rcq", "wrcq", "orcq"):
        vparams = (v2c_quantizer_params if v2c_quantizer_params is not None
                   else [(C * 2.0, g) for C, g in quantizer_params])
        v2c_thresholds = stack_quantizer_thresholds(bv, vparams, T)
        v2c_qparams = stack_quantizer_params(vparams, T)
        v2c_levels = 2 ** (bv - 1)

    if kind == "ms":
        spec = VariantSpec(kind="nms", fixed_beta=factor, fixed_alpha=1.0)
        weights: Dict[str, Optional[jnp.ndarray]] = {"beta": None, "alpha": None}
        dname = name or f"MS(factor={factor})"
    elif kind == "rcq" and (sharing_type is None or sharing_type == 0):
        spec = VariantSpec(kind="rcq", fixed_beta=1.0, fixed_alpha=1.0,
                           thresholds=thresholds, v2c_thresholds=v2c_thresholds,
                           qparams=qparams, q_levels=q_levels,
                           v2c_qparams=v2c_qparams, v2c_levels=v2c_levels,
                           closed_qdq=closed_qdq)
        weights = {"beta": None, "alpha": None}
        dname = name or f"RCQ(bc={bc})"
    else:
        st = 0 if sharing_type is None else sharing_type
        wiring = (_qc_bucket_wiring(qc, st, offset_style) if qc is not None
                  else _bucket_wiring(graph, st, offset_style))
        (beta_idx, n_beta, alpha_idx, n_alpha,
         fixed_beta, fixed_alpha, alpha_in_cn) = wiring
        if per_layer:
            # expand bucket universes to (base row x degree bucket): a
            # block's weight is keyed by its LAYER as well as its degree
            row = np.asarray(qc.block_row, dtype=np.int32)
            if beta_idx is not None:
                beta_idx = row * n_beta + np.asarray(beta_idx,
                                                     dtype=np.int32)
                n_beta *= qc.mb
            if alpha_idx is not None:
                alpha_idx = row * n_alpha + np.asarray(alpha_idx,
                                                       dtype=np.int32)
                n_alpha *= qc.mb
        engine_kind = {"nms": "nms", "oms": "oms", "wrcq": "wrcq",
                       "orcq": "orcq"}[kind]
        spec = VariantSpec(
            kind=engine_kind,
            beta_idx=beta_idx,
            alpha_idx=alpha_idx,
            fixed_beta=fixed_beta,
            fixed_alpha=fixed_alpha,
            n_beta=n_beta,
            n_alpha=n_alpha,
            alpha_in_cn=offset_style,
            thresholds=thresholds,
            v2c_thresholds=v2c_thresholds,
            qparams=qparams,
            q_levels=q_levels,
            v2c_qparams=v2c_qparams,
            v2c_levels=v2c_levels,
            closed_qdq=closed_qdq,
        )
        if init == "reference":
            if kind == "nms" and st == 0:
                beta_mean, alpha_mean = 0.7, 1.0  # neural_minsum_decoder.py:53
            else:
                beta_mean, alpha_mean = 0.0, 0.0  # 0.1*randn everywhere else
        elif init == "nms":
            beta_mean = 0.0 if offset_style else 0.7
            alpha_mean = 0.0 if offset_style else 1.0
        else:
            raise ValueError(f"unknown init {init!r}")
        weights = _init_weights(key, T, n_beta, n_alpha,
                                beta_mean=beta_mean, alpha_mean=alpha_mean)
        base = {"nms": "N-NMS" if st == 0 else f"N-2D-NMS(t{st})",
                "oms": "N-OMS" if st == 0 else f"N-2D-OMS(t{st})",
                "wrcq": f"W-RCQ(t{st},bc={bc})",
                "orcq": f"W-OMS-RCQ(t{st},bc={bc})"}[kind]
        if per_layer:
            base += "+perlayer"
        dname = name or base

    layer_checks = (make_layers(graph, num_layers)
                    if layered and qc is None else None)
    bg = None
    if bucketed:
        from ldpc_tpu.decode.bucketed_engine import build_bucketed_graph
        bg = build_bucketed_graph(graph)
    recipe = dict(
        kind=kind, sharing_type=sharing_type, factor=factor,
        max_iterations=T, bc=bc, bv=bv,
        quantizer_params=[list(p) for p in quantizer_params],
        v2c_quantizer_params=(None if v2c_quantizer_params is None
                              else [list(p) for p in v2c_quantizer_params]),
        layered=layered, num_layers=num_layers, init=init, seed=seed,
        name=dname, bucketed=bucketed, per_layer=per_layer,
        closed_qdq=closed_qdq)
    return Decoder(
        name=dname, code=code, graph=graph, spec=spec, max_iterations=T,
        weights=weights, layered=layered, layer_checks=layer_checks, qc=qc,
        qc_options=qc_options, bucketed_graph=bg, recipe=recipe)


# -- reference-parity constructors -----------------------------------------


def basic_min_sum(code, factor: float = 0.7, max_iterations=None, **kw):
    """Fixed-factor normalized min-sum (``ldpc_decoder.py:56-153``)."""
    return make_decoder(code, kind="ms", factor=factor,
                        max_iterations=max_iterations, **kw)


def neural_min_sum(code, max_iterations=None, seed=0, **kw):
    """N-NMS: one weight per (iteration, edge)
    (``neural_minsum_decoder.py:19-150``)."""
    return make_decoder(code, kind="nms", sharing_type=0,
                        max_iterations=max_iterations, seed=seed, **kw)


def neural_offset_min_sum(code, max_iterations=None, seed=0, **kw):
    """N-OMS: per-edge offsets, c2v = sign * relu(mag - beta)
    (``neural_minsum_decoder.py:152-286``)."""
    return make_decoder(code, kind="oms", sharing_type=0,
                        max_iterations=max_iterations, seed=seed, **kw)


def neural_2d_min_sum(code, weight_sharing_type: int = 2, max_iterations=None,
                      seed=0, **kw):
    """N-2D-NMS types 1-4 (``neural_2d_decoder.py:16-225``)."""
    return make_decoder(code, kind="nms", sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, seed=seed, **kw)


def neural_2d_offset_min_sum(code, weight_sharing_type: int = 2,
                             max_iterations=None, seed=0, **kw):
    """N-2D-OMS types 1-4 (``neural_2d_decoder.py:227-434``)."""
    return make_decoder(code, kind="oms", sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, seed=seed, **kw)


def rcq_min_sum(code, bc: int = 3, bv: Optional[int] = None,
                quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
                max_iterations=None, layered: bool = False, **kw):
    """RCQ min-sum (``rcq_decoder.py:123-350``); ``bv`` actually works here."""
    return make_decoder(code, kind="rcq", bc=bc, bv=bv,
                        quantizer_params=quantizer_params,
                        max_iterations=max_iterations, layered=layered, **kw)


def weighted_oms_rcq(code, bc: int = 3, bv: Optional[int] = None,
                     quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
                     weight_sharing_type: int = 2, max_iterations=None,
                     layered: bool = False, seed=0, **kw):
    """W-OMS-RCQ: degree-shared OMS offsets + RCQ quantization —
    ``c2v = qdq(sign * (relu(mag - beta) - alpha))``.

    The paper's FPGA headline decoder (§VII-B, Table III: W-OMS-RCQ(3,8)
    saves 22.8% LUTs vs 5-bit OMS). NOT in the reference — its
    ``WeightedRCQDecoder`` is beta-multiply only (``rcq_decoder.py:559-563``);
    this combines that RCQ skeleton with the reference's 2D-OMS transform
    (``neural_2d_decoder.py:400-401``)."""
    return make_decoder(code, kind="orcq", bc=bc, bv=bv,
                        quantizer_params=quantizer_params,
                        sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, layered=layered,
                        seed=seed, **kw)


def weighted_rcq(code, bc: int = 3, bv: Optional[int] = None,
                 quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
                 weight_sharing_type: int = 2, max_iterations=None,
                 layered: bool = False, seed=0, **kw):
    """W-RCQ: degree-shared weights + RCQ (``rcq_decoder.py:352-597``)."""
    return make_decoder(code, kind="wrcq", bc=bc, bv=bv,
                        quantizer_params=quantizer_params,
                        sharing_type=weight_sharing_type,
                        max_iterations=max_iterations, layered=layered,
                        seed=seed, **kw)
