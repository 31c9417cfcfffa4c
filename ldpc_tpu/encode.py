"""Systematic GF(2) encoding for any LDPCCode.

The reference framework has NO encoder — every simulation transmits the
all-zero codeword (``simulation_framework.py``; standard practice for
linear codes over symmetric channels, and this repo's simulator does the
same). This module adds real encoding so that (a) serving paths can
encode payloads, and (b) the all-zero-codeword methodology is *testable*:
``tests/test_encode.py`` decodes noisy nonzero codewords and checks the
error statistics behave like the all-zero ones.

Construction: Gaussian elimination over GF(2) on H (bit-packed rows,
~1 ms/MB) finds ``r = rank(H)`` pivot columns; the remaining ``k = n-r``
columns are the information set. Encoding solves ``H c^T = 0`` for the
pivot bits: ``c[pivots] = (u @ P^T) mod 2`` with the dense {0,1} matrix
``P = reduce(H)[:, info]``. That is ONE [B, k] x [k, r] matmul in
float32, followed by a mod-2 — batched, jitted, no per-bit control flow.
It is exact even where a float32 matmul runs in TF32 (as it may on a
GPU): both operands are {0,1}, which TF32 represents exactly, and the
sums are accumulated in float32, where integers stay exact far below
2^24.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.codes import LDPCCode

__all__ = ["Encoder", "make_encoder", "gf2_row_reduce"]


def gf2_row_reduce(H: np.ndarray):
    """Reduced row-echelon form of a {0,1} matrix over GF(2).

    Returns ``(R, pivot_cols)`` with ``R`` dense uint8 in RREF (each
    pivot column has a single 1). Rows are bit-packed into uint64 words
    internally, so elimination on the (1280, 9472) bench matrix takes
    ~0.1 s instead of tens of seconds.
    """
    H = np.asarray(H, dtype=np.uint8)
    m, n = H.shape
    W = (n + 63) // 64
    packed = np.zeros((m, W), dtype=np.uint64)
    bits = np.packbits(H, axis=1, bitorder="little")
    packed.view(np.uint8)[:, :bits.shape[1]] = bits

    pivots = []
    row = 0
    for col in range(n):
        if row >= m:
            break
        w, b = col >> 6, np.uint64(1) << np.uint64(col & 63)
        hot = (packed[row:, w] & b) != 0
        if not hot.any():
            continue
        sel = row + int(np.argmax(hot))
        if sel != row:
            packed[[row, sel]] = packed[[sel, row]]
        # eliminate this column from every OTHER row (full RREF)
        others = (packed[:, w] & b) != 0
        others[row] = False
        packed[others] ^= packed[row]
        pivots.append(col)
        row += 1

    unpacked = np.unpackbits(packed.view(np.uint8), axis=1,
                             bitorder="little")[:, :n]
    return unpacked.astype(np.uint8), np.asarray(pivots, dtype=np.int64)


@partial(jax.jit, static_argnames=("n",))
def _encode_batch(u, P, info_pos, pivot_pos, n):
    """c[info] = u, c[pivots] = (u @ P^T) mod 2 — f32 matmul (exact for
    row sums < 2^24, i.e. any k < 16M) + mod-2, one scatter."""
    u = u.astype(jnp.float32)
    parity = jnp.mod(u @ P.T, 2.0).astype(jnp.int32)
    B = u.shape[0]
    c = jnp.zeros((B, n), jnp.int32)
    c = c.at[:, info_pos].set(u.astype(jnp.int32))
    c = c.at[:, pivot_pos].set(parity)
    return c


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Systematic encoder for one code.

    ``k_eff = n - rank(H)`` is the TRUE code dimension and can differ
    from the nominal ``code.k`` in either direction: redundant checks
    make it larger; extra independent checks make it smaller. The
    reference's "(7,4)" test code is the latter — its H
    (``ldpc_decoder.py:18-23``) has FOUR independent rows, so the code
    it defines is actually (7,3); the encoder reports what H enforces."""

    code: LDPCCode
    info_positions: np.ndarray    # [k_eff] columns carrying payload bits
    pivot_positions: np.ndarray   # [r] columns carrying parity bits
    _P: np.ndarray                # [r, k_eff] {0,1} parity map

    @property
    def k_eff(self) -> int:
        return len(self.info_positions)

    def _device_constants(self):
        """Upload P / index vectors once, lazily (P is ~40 MB on the
        bench-class code — per-call jnp.asarray would re-transfer it
        to the device on every encode)."""
        dev = getattr(self, "_dev", None)
        if dev is None:
            dev = (jnp.asarray(self._P, jnp.float32),
                   jnp.asarray(self.info_positions),
                   jnp.asarray(self.pivot_positions))
            object.__setattr__(self, "_dev", dev)
        return dev

    def __call__(self, info_bits: jnp.ndarray) -> jnp.ndarray:
        """Encode [B, k_eff] (or [k_eff]) info bits -> [B, n] codewords."""
        u = jnp.asarray(info_bits)
        squeeze = u.ndim == 1
        if squeeze:
            u = u[None]
        if u.shape[-1] != self.k_eff:
            raise ValueError(
                f"expected {self.k_eff} info bits, got {u.shape[-1]}")
        P, info, piv = self._device_constants()
        c = _encode_batch(u, P, info, piv, self.code.n)
        return c[0] if squeeze else c

    def syndrome_ok(self, codewords: jnp.ndarray) -> jnp.ndarray:
        """Per-frame parity check (dense H, small-code verification aid)."""
        H = jnp.asarray(self.code.H, jnp.float32)
        s = jnp.mod(jnp.asarray(codewords, jnp.float32) @ H.T, 2.0)
        return jnp.all(s == 0, axis=-1)


def make_encoder(code: LDPCCode) -> Encoder:
    """Build the systematic encoder (one-time GF(2) elimination on H)."""
    R, pivots = gf2_row_reduce(code.H)
    r = len(pivots)
    info = np.setdiff1d(np.arange(code.n), pivots)
    P = R[:r][:, info]  # row i of RREF: c[pivot_i] = sum(P[i] * u) mod 2
    return Encoder(code=code, info_positions=info, pivot_positions=pivots,
                   _P=P.astype(np.uint8))
