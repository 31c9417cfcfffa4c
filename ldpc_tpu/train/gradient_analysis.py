"""Gradient-explosion analysis tooling.

Capability parity with the reference's ``GradientExplosionAnalyzer``
(``training_framework.py:297-377``): measure the distribution of per-sample
gradient norms through the unrolled decoder to demonstrate the paper's
gradient-explosion claim (paper §V) and the posterior-joint-training fix.

Batched: per-sample gradients come from ``jax.vmap(jax.grad(...))`` — one
compiled program evaluates the whole batch of per-sample norms, instead of
the reference's per-sample Python loop of separate ``backward()`` calls.
"""

from __future__ import annotations

import logging
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.channel import awgn_llr
from ldpc_tpu.decode.variants import Decoder
from ldpc_tpu.train.trainer import posterior_joint_loss

logger = logging.getLogger(__name__)

__all__ = ["GradientExplosionAnalyzer"]


class GradientExplosionAnalyzer:
    """Per-sample gradient-norm statistics for a neural decoder."""

    def __init__(self, decoder: Decoder):
        if all(w is None for w in decoder.weights.values()):
            raise ValueError("decoder has no trainable weights to analyze")
        self.decoder = decoder

    def _per_sample_norms(self, llr: jnp.ndarray, joint: bool) -> np.ndarray:
        dec = self.decoder
        trainable = {k: w for k, w in dec.weights.items() if w is not None}
        frozen = {k: w for k, w in dec.weights.items() if w is None}

        def single_loss(tr, one_llr):
            w = dict(frozen)
            w.update(tr)
            loss, _ = posterior_joint_loss(
                w, one_llr[None], jnp.zeros_like(one_llr)[None],
                decoder=dec, joint=joint)
            return loss

        grad_fn = jax.vmap(jax.grad(single_loss), in_axes=(None, 0))
        grads = jax.jit(grad_fn)(trainable, llr)  # leaves: [N, ...]
        leaves = jax.tree_util.tree_leaves(grads)
        sq = sum(jnp.sum(g.reshape(g.shape[0], -1) ** 2, axis=1)
                 for g in leaves)
        return np.asarray(jnp.sqrt(sq))

    def analyze(
        self,
        num_samples: int = 64,
        snr_db: float = 2.0,
        seed: int = 0,
        compare_final_only: bool = True,
    ) -> Dict:
        """Measure per-sample gradient norms on all-zero-codeword AWGN LLRs.

        Returns stats for the posterior-joint loss and (optionally) the
        final-posterior-only loss, so the explosion contrast the paper
        describes is directly measurable.
        """
        key = jax.random.PRNGKey(seed)
        zeros = jnp.zeros((num_samples, self.decoder.code.n), jnp.float32)
        llr = awgn_llr(key, zeros, snr_db)

        def stats(norms: np.ndarray) -> Dict:
            return {
                "mean": float(norms.mean()),
                "std": float(norms.std()),
                "max": float(norms.max()),
                "min": float(norms.min()),
                "p99": float(np.percentile(norms, 99)),
                "norms": norms.tolist(),
            }

        joint = self._per_sample_norms(llr, joint=True)
        out = {"posterior_joint": stats(joint)}
        if compare_final_only:
            final = self._per_sample_norms(llr, joint=False)
            out["final_only"] = stats(final)
        logger.info(
            "gradient norms @ %.1f dB: joint mean=%.3e max=%.3e%s",
            snr_db, out["posterior_joint"]["mean"],
            out["posterior_joint"]["max"],
            (f"; final-only mean={out['final_only']['mean']:.3e} "
             f"max={out['final_only']['max']:.3e}")
            if compare_final_only else "")
        return out

    def plot_gradient_analysis(self, results: Dict,
                               path: str = "gradient_analysis.png"):
        """Histogram of per-sample gradient norms (reference
        ``training_framework.py:354-377``)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 4.5))
        for name, st in results.items():
            ax.hist(st["norms"], bins=30, alpha=0.6, label=name)
        ax.set_xlabel("per-sample gradient norm")
        ax.set_ylabel("count")
        ax.set_title(f"Gradient norms — {self.decoder.name}")
        ax.legend()
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
