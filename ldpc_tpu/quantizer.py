"""Non-uniform (RCQ) quantization as vectorized LUT ops.

Semantics match the reference ``NonUniformQuantizer`` exactly
(``rcq_decoder.py:22-121``):

- thresholds ``tau_j = C * (j / (2^(bc-1) - 1))^gamma`` for
  ``j = 0 .. 2^(bc-1)-1`` (so ``tau_0 = 0``, ``tau_max = C``);
- quantize: magnitude index = largest ``j`` with ``|x| >= tau_j``
  (inclusive compare), packed sign-magnitude as
  ``code = (x < 0) * 2^(bc-1) + idx``;
- dequantize: value = ``(1 - 2*sign_bit) * tau_idx`` — reconstruction *to the
  threshold itself*, not a midpoint.

One deliberate deviation in the fused qdq forms (``quantize_dequantize``
and the closed-form/staircase kernels): the reconstructed magnitude is
floored at ``QDQ_SIGN_TINY`` (1e-30) instead of ``tau_0 = 0``. Hardware
sign-magnitude words keep the sign bit even at magnitude 0; a float
``-0.0`` loses it at every ``< 0`` consumer (bit decisions, CN sign
counts, the syndrome), which makes the decoder ASYMMETRIC inside the
dead zone ``|x| < tau_1`` — deciding bit 0 for uncertain-but-negative
posteriors. That breaks the all-zero-codeword symmetry argument Monte
Carlo relies on, and lets dead-zone bit patterns trivially satisfy the
syndrome. The 1e-30 floor preserves the sign bit through every compare
while being exactly absorbed by any add/min against real message
magnitudes (documented impact: zero measured FER change at operating
points, experiments/bias_probe.json; design-time DE previously
predicted below-capacity "convergence" from the biased decision —
docs/RESULTS.md §33).

Implemented as a branch-free compare-count (equivalent to
``searchsorted(..., side='right') - 1``) so it fuses into the surrounding
decode kernel, plus a straight-through-estimator wrapper for training
(the reference never solved STE — its RCQ path is inference-only and its
trainer is broken, SURVEY §7 "hard parts").
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "QDQ_SIGN_TINY",
    "NonUniformQuantizer",
    "power_thresholds",
    "power_thresholds_for_levels",
    "quantize",
    "dequantize",
    "quantize_dequantize",
    "qdq_ste",
    "power_qdq",
    "power_qdq_ste",
    "uniform_qdq",
    "uniform_qdq_ste",
    "staircase_qdq",
    "staircase_qdq_ste",
    "phase_schedule",
    "stack_quantizer_params",
    "stack_quantizer_thresholds",
]


# sign-preserving dead-zone floor (see module docstring): python float so
# importing never touches a jax backend; representable in bf16 (~9.9e-31)
QDQ_SIGN_TINY = 1e-30


def power_thresholds_for_levels(levels: int, C: float,
                                gamma: float) -> np.ndarray:
    """tau_j = C * (j / (levels-1))^gamma, j = 0..levels-1 — the ladder
    parameterized by its level count (= 2^(bc-1)) directly."""
    max_idx = levels - 1
    j = np.arange(levels, dtype=np.float64)
    return (C * (j / max_idx) ** gamma).astype(np.float32)


def power_thresholds(bc: int, C: float, gamma: float) -> np.ndarray:
    """tau_j = C * (j / (2^(bc-1)-1))^gamma, j = 0..2^(bc-1)-1
    (reference ``rcq_decoder.py:48-57``)."""
    return power_thresholds_for_levels(2 ** (bc - 1), C, gamma)


def _threshold_index(mag: jnp.ndarray, thresholds: jnp.ndarray) -> jnp.ndarray:
    """Largest ``j`` with ``tau_j <= mag`` (the reference's inclusive ``>=``
    scan, ``rcq_decoder.py:59-91``), computed in O(log L).

    ``jnp.searchsorted(side='right') - 1`` is exactly that index for a sorted
    LUT. The naive broadcast compare materializes an ``[..., L]`` intermediate
    — at bv=8 that is a 128x blowup of the message tensor and dominated the
    whole decode; binary search keeps the working set at the message
    size times log2(L) steps.
    """
    if thresholds.ndim == 1:
        idx = jnp.searchsorted(thresholds, mag, side="right") - 1
    else:
        # per-element threshold rows: fall back to compare-count (only used
        # by small-L calls)
        idx = jnp.sum(
            (mag[..., None] >= thresholds).astype(jnp.int32), axis=-1) - 1
    return jnp.maximum(idx, 0)  # tau_0 = 0 makes this a no-op; keep for safety


def quantize(x: jnp.ndarray, thresholds: jnp.ndarray) -> jnp.ndarray:
    """Sign-magnitude quantize against a threshold LUT.

    ``thresholds`` has shape [..., L] broadcastable against ``x[..., None]``
    (L = 2^(bc-1)); returns int32 codes in [0, 2^bc).
    Matches reference ``rcq_decoder.py:59-91`` (>= compare, first-threshold 0).
    """
    mag = jnp.abs(x)
    idx = _threshold_index(mag, thresholds)
    levels = thresholds.shape[-1]
    sign_bit = (x < 0).astype(jnp.int32)
    return sign_bit * levels + idx


def dequantize(code: jnp.ndarray, thresholds: jnp.ndarray) -> jnp.ndarray:
    """Invert :func:`quantize`: reconstruct to the threshold value with sign
    (reference ``rcq_decoder.py:93-121``)."""
    levels = thresholds.shape[-1]
    sign_bit = (code >= levels).astype(jnp.int32)
    idx = code % levels
    mag = jnp.take_along_axis(
        jnp.broadcast_to(thresholds, code.shape[:-0] + (levels,))
        if thresholds.ndim == 1
        else thresholds,
        idx[..., None],
        axis=-1,
    )[..., 0] if thresholds.ndim > 1 else thresholds[idx]
    return (1.0 - 2.0 * sign_bit.astype(jnp.float32)) * mag


def quantize_dequantize(x: jnp.ndarray, thresholds: jnp.ndarray) -> jnp.ndarray:
    """Fused quantize∘dequantize without materializing integer codes:
    snap |x| down to the largest threshold <= |x|, keep the sign.

    Bit-exact with ``dequantize(quantize(x))`` for all x (including x == 0,
    where the reference's ``sign_bit = (x < 0)`` yields +tau_0 = +0).
    """
    mag = jnp.abs(x)
    idx = _threshold_index(mag, thresholds)
    snapped = thresholds[idx] if thresholds.ndim == 1 else jnp.take_along_axis(
        thresholds, idx[..., None], axis=-1
    )[..., 0]
    snapped = jnp.maximum(snapped, QDQ_SIGN_TINY)  # sign-preserving dead zone
    sign = jnp.where(x < 0, -1.0, 1.0)
    return sign * snapped


def qdq_ste(x: jnp.ndarray, thresholds: jnp.ndarray) -> jnp.ndarray:
    """Straight-through estimator: forward = quantize∘dequantize, backward =
    identity clipped to the quantizer's dynamic range [-C, C].

    This is the standard fake-quant rule that makes W-RCQ trainable (a stated
    capability of the paper the reference never delivered — SURVEY §7).
    """
    C = thresholds[..., -1]
    clipped = jnp.clip(x, -C, C)
    return clipped + jax.lax.stop_gradient(quantize_dequantize(x, thresholds) - clipped)


def staircase_qdq(x: jnp.ndarray, thresholds: jnp.ndarray) -> jnp.ndarray:
    """Exact quantize∘dequantize for SMALL threshold LUTs as a staircase sum:

        qdq(x) = sign(x) * sum_j (|x| >= tau_j) * (tau_j - tau_{j-1})

    Bit-identical to ``quantize_dequantize`` (inclusive ``>=`` compare,
    snap-down-to-threshold, tau_0 = 0) but with no index computation and no
    gather — just L-1 compares and fused multiply-adds, which XLA fuses
    straight into the surrounding decode kernel. Intended for the bc-bit C2V
    LUTs (L = 2^(bc-1) <= 16); cost grows linearly in L, so large LUTs
    should use :func:`power_qdq` instead.

    ``thresholds`` is a rank-1 [L] array (may be traced per-iteration).
    """
    mag = jnp.abs(x)
    L = thresholds.shape[-1]
    snapped = jnp.zeros_like(mag)
    for j in range(1, L):
        step = thresholds[j] - thresholds[j - 1]
        snapped = snapped + jnp.where(mag >= thresholds[j], step, 0.0)
    snapped = jnp.maximum(snapped, QDQ_SIGN_TINY)  # sign-preserving dead zone
    return jnp.where(x < 0, -snapped, snapped)


def staircase_qdq_ste(x: jnp.ndarray, thresholds: jnp.ndarray) -> jnp.ndarray:
    """STE companion of :func:`staircase_qdq` (see :func:`qdq_ste`)."""
    C = thresholds[..., -1]
    clipped = jnp.clip(x, -C, C)
    return clipped + jax.lax.stop_gradient(
        staircase_qdq(x, thresholds) - clipped)


def power_qdq(x: jnp.ndarray, C, gamma, levels: int) -> jnp.ndarray:
    """Closed-form quantize∘dequantize for *power-law* thresholds.

    Mathematically identical to ``quantize_dequantize(x, power_thresholds
    (b, C, gamma))`` — snap |x| down to the largest ``tau_j = C*(j/M)^gamma``
    with ``tau_j <= |x|`` (M = levels-1) — but computed elementwise by
    inverting the power law instead of scanning/searching a LUT. The
    LUT forms are costly: broadcast-compare materializes an
    ``[..., L]`` intermediate (128x blowup at bv=8) and ``searchsorted``
    lowers to per-element dynamic gathers; this version is pure elementwise math
    that XLA fuses into the surrounding kernel.

    Two boundary-correction selects make the index exact under float
    rounding of the ``(|x|/C)**(1/gamma)`` inversion.

    ``C``/``gamma`` may be traced scalars (per-iteration values inside a
    scan). ``levels`` is static (= 2^(b-1)).
    """
    M = levels - 1
    mag = jnp.abs(x)
    r = jnp.clip(mag / C, 0.0, 1.0)
    idx = jnp.floor(M * r ** (1.0 / gamma))
    idx = jnp.clip(idx, 0.0, float(M))
    # correct a one-low index: the next threshold may still be <= mag
    up = C * (jnp.minimum(idx + 1.0, float(M)) / M) ** gamma
    idx = jnp.where((mag >= up) & (idx < M), idx + 1.0, idx)
    # correct a one-high index: our own threshold may exceed mag
    down = C * (idx / M) ** gamma
    idx = jnp.where(mag < down, jnp.maximum(idx - 1.0, 0.0), idx)
    snapped = jnp.maximum(C * (idx / M) ** gamma,
                          QDQ_SIGN_TINY)   # sign-preserving dead zone
    return jnp.where(x < 0, -snapped, snapped)


def uniform_qdq(x: jnp.ndarray, C, levels: int) -> jnp.ndarray:
    """Closed-form quantize∘dequantize for UNIFORM thresholds (the gamma=1
    special case of :func:`power_qdq`): ``tau_j = C*j/M``. Pure arithmetic
    — no transcendentals — so it is the preferred form for the
    high-resolution bv-bit internal quantizer (bv=8 uniform is visually
    indistinguishable from bv=8 power-law in FER; measure per code with
    ``experiments/accuracy_bc3.py``-style sweeps).

    Same boundary-correction selects as :func:`power_qdq`: the selected
    quantizer index matches the LUT scan for every input; the reconstructed
    value is ``C*idx/M`` rounded once in f32 (within 1 ulp of the
    float64-computed LUT entry).
    """
    M = levels - 1
    scale = M / C   # scalar: hoists the division out of the per-element path
    step = C / M
    mag = jnp.abs(x)
    idx = jnp.clip(jnp.floor(mag * scale), 0.0, float(M))
    up = jnp.minimum(idx + 1.0, float(M)) * step
    idx = jnp.where((mag >= up) & (idx < M), idx + 1.0, idx)
    down = idx * step
    idx = jnp.where(mag < down, jnp.maximum(idx - 1.0, 0.0), idx)
    snapped = jnp.maximum(idx * step,
                          QDQ_SIGN_TINY)   # sign-preserving dead zone
    return jnp.where(x < 0, -snapped, snapped)


def uniform_qdq_ste(x: jnp.ndarray, C, levels: int) -> jnp.ndarray:
    """STE companion of :func:`uniform_qdq` (see :func:`qdq_ste`)."""
    clipped = jnp.clip(x, -C, C)
    return clipped + jax.lax.stop_gradient(
        uniform_qdq(x, C, levels) - clipped)


def power_qdq_ste(x: jnp.ndarray, C, gamma, levels: int) -> jnp.ndarray:
    """STE companion of :func:`power_qdq` (forward quantized, backward
    identity clipped to the quantizer range [-C, C]) — see :func:`qdq_ste`."""
    clipped = jnp.clip(x, -C, C)
    return clipped + jax.lax.stop_gradient(
        power_qdq(x, C, gamma, levels) - clipped)


@dataclasses.dataclass(frozen=True)
class NonUniformQuantizer:
    """API-parity wrapper bundling (bc, C, gamma) with its LUT.

    Mirrors the reference class surface: ``.bc``, ``.C``, ``.gamma``,
    ``.thresholds``, ``.quantize(x)``, ``.dequantize(q)``
    (``rcq_decoder.py:22-121``).
    """

    bc: int
    C: float
    gamma: float

    @property
    def thresholds(self) -> np.ndarray:
        return power_thresholds(self.bc, self.C, self.gamma)

    def quantize(self, x: jnp.ndarray) -> jnp.ndarray:
        return quantize(jnp.asarray(x), jnp.asarray(self.thresholds))

    def dequantize(self, code: jnp.ndarray) -> jnp.ndarray:
        return dequantize(jnp.asarray(code), jnp.asarray(self.thresholds))

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return quantize_dequantize(jnp.asarray(x), jnp.asarray(self.thresholds))


def phase_schedule(max_iterations: int, num_quantizers: int) -> np.ndarray:
    """Per-iteration quantizer index.

    For up to 3 quantizers this matches the reference's thirds rule
    exactly (``rcq_decoder.py:156-167``): one quantizer -> always 0;
    otherwise iteration < T//3 -> 0, < 2T//3 -> 1, else last. More than
    3 quantizers (the paper's §VI design rule is "if an error floor
    appears above the target FER, ADD a quantizer" — the reference never
    implements Q > 3) spread evenly over the iterations; Q == T gives a
    fully per-iteration schedule."""
    T = max_iterations
    sched = np.zeros(T, dtype=np.int32)
    if num_quantizers <= 1:
        return sched
    if num_quantizers > 3:
        for t in range(T):
            sched[t] = min(t * num_quantizers // T, num_quantizers - 1)
        return sched
    for t in range(T):
        if t < T // 3:
            sched[t] = 0
        elif t < 2 * T // 3:
            sched[t] = min(1, num_quantizers - 1)
        else:
            sched[t] = num_quantizers - 1
    return sched


def stack_quantizer_params(
    quantizer_params: Sequence[Tuple[float, float]], max_iterations: int
) -> np.ndarray:
    """[T, 2] per-iteration (C, gamma) following the thirds phase schedule —
    the scan-friendly companion of :func:`stack_quantizer_thresholds` for the
    closed-form :func:`power_qdq` path."""
    params = np.asarray(quantizer_params, dtype=np.float32)  # [Q, 2]
    sched = phase_schedule(max_iterations, len(quantizer_params))
    return params[sched]


def stack_quantizer_thresholds(
    bc: int, quantizer_params: Sequence[Tuple[float, float]], max_iterations: int
) -> np.ndarray:
    """Precompute a [T, L] per-iteration threshold LUT from a list of
    (C, gamma) pairs plus the thirds phase schedule — the scan-friendly form
    consumed by the decode engine."""
    luts = np.stack([power_thresholds(bc, C, g) for C, g in quantizer_params])
    sched = phase_schedule(max_iterations, len(quantizer_params))
    return luts[sched]
