"""Slow, loopy numpy oracle decoder for testing the batched engines.

Implements the behavioral contract of SURVEY.md §2b with straightforward
per-node Python loops over a dense H — deliberately written in a *different*
style from the engine (dense matrix, explicit loops, no slot tables) so that
agreement between the two is meaningful evidence of correctness.

Sign convention for zero messages: sign(0) = +1 (the engine's convention;
differs from torch.sign(0)=0 only on measure-zero inputs — see
``engine._cn_update`` notes).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["oracle_decode"]


def oracle_decode(
    H: np.ndarray,
    llr: np.ndarray,
    max_iterations: int,
    *,
    beta_fn: Optional[Callable[[int, int, int], float]] = None,
    alpha_fn: Optional[Callable[[int, int, int], float]] = None,
    alpha_in_cn: bool = False,
    transform: str = "nms",  # 'nms' | 'oms' | 'rcq' | 'wrcq' | 'orcq'
    qdq: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
    quantize_v2c: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray, int, bool]:
    """Flooding min-sum with per-(iteration, check, var) weights.

    beta_fn(t, i, j) / alpha_fn(t, i, j) return scalar weights (defaults:
    0.7 / 1.0 for nms-style, 0.0 / 0.0 for oms-style). ``qdq(x, t)`` is the
    quantize-dequantize op for iteration t (rcq/wrcq).
    Returns (bits, posterior, iterations, success).
    """
    H = np.asarray(H)
    m, n = H.shape
    if beta_fn is None:
        beta_fn = (lambda t, i, j: 0.0) if transform == "oms" else (
            lambda t, i, j: 0.7)
    if alpha_fn is None:
        alpha_fn = (lambda t, i, j: 0.0) if transform == "oms" else (
            lambda t, i, j: 1.0)

    nbrs_of_check = [np.flatnonzero(H[i]) for i in range(m)]
    nbrs_of_var = [np.flatnonzero(H[:, j]) for j in range(n)]

    v2c = np.zeros((n, m))
    c2v = np.zeros((m, n))
    for j in range(n):
        for i in nbrs_of_var[j]:
            v2c[j, i] = llr[j]

    def posterior_now():
        post = llr.astype(np.float64).copy()
        for j in range(n):
            post[j] += sum(c2v[i, j] for i in nbrs_of_var[j])
        return post

    for t in range(max_iterations):
        # CN update
        for i in range(m):
            nb = nbrs_of_check[i]
            incoming = np.array([v2c[j, i] for j in nb])
            signs = np.where(incoming < 0, -1.0, 1.0)
            mags = np.abs(incoming)
            kmin = int(np.argmin(mags))
            min1 = mags[kmin]
            if len(nb) > 1:
                tmp = mags.copy()
                tmp[kmin] = np.inf
                min2 = tmp.min()
            else:
                min2 = min1
            for kk, j in enumerate(nb):
                raw = min2 if kk == kmin else min1
                sgn = np.prod(np.delete(signs, kk))
                beta = beta_fn(t, i, j)
                if transform == "nms":
                    val = beta * sgn * raw
                elif transform == "oms":
                    val = max(raw - beta, 0.0)
                    if alpha_in_cn:
                        val = val - alpha_fn(t, i, j)
                    val = sgn * val
                elif transform == "rcq":
                    val = qdq(np.asarray(sgn * raw), t)
                elif transform == "wrcq":
                    val = qdq(np.asarray(beta * sgn * raw), t)
                elif transform == "orcq":
                    # W-OMS-RCQ (paper §VII-B, the FPGA headline decoder):
                    # OMS offset transform followed by RCQ quantization
                    val = max(raw - beta, 0.0)
                    if alpha_in_cn:
                        val = val - alpha_fn(t, i, j)
                    val = qdq(np.asarray(sgn * val), t)
                else:
                    raise ValueError(transform)
                c2v[i, j] = val

        # VN update
        for j in range(n):
            nb = nbrs_of_var[j]
            for i in nb:
                others = sum(c2v[i2, j] for i2 in nb if i2 != i)
                if alpha_in_cn:
                    v2c[j, i] = llr[j] + others
                else:
                    v2c[j, i] = llr[j] + alpha_fn(t, i, j) * others
                if quantize_v2c is not None:
                    v2c[j, i] = quantize_v2c(np.asarray(v2c[j, i]), t)

        post = posterior_now()
        if quantize_v2c is not None:
            post = quantize_v2c(post, t)
        bits = (post < 0).astype(np.int32)
        syndrome = (H @ bits) % 2
        if syndrome.sum() == 0:
            return bits, post, t + 1, True

    post = posterior_now()
    if quantize_v2c is not None:
        post = quantize_v2c(post, max_iterations - 1)
    bits = (post < 0).astype(np.int32)
    return bits, post, max_iterations, False
