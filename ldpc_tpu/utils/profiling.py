"""Profiling / throughput counters.

The reference's only observability is wall-clock deltas
(``simulation_framework.py:100,137``, SURVEY §5). Device equivalents here:
``jax.profiler`` trace capture (kernel-level timelines viewable in
XProf/TensorBoard or parseable from the emitted ``.trace.json.gz``) and a
decoded-codewords/sec counter — the BASELINE.json north-star metric.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import jax

__all__ = ["trace", "measure_throughput", "ThroughputCounter"]


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/ldpc_tpu_trace"):
    """Capture a device trace around a block:

    >>> with trace("/tmp/t"):
    ...     decoder(llr).bits.block_until_ready()
    """
    with jax.profiler.trace(log_dir):
        yield log_dir


def measure_throughput(fn: Callable, *args, reps: int = 5,
                       warmup: int = 1) -> float:
    """Per-second call throughput of ``fn`` (results block_until_ready'd).

    Returns calls/sec; multiply by the per-call batch for codewords/sec.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.time()
    out = None
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return reps / (time.time() - t0)


class ThroughputCounter:
    """Running decoded-codewords/sec across Monte-Carlo waves."""

    def __init__(self):
        self.codewords = 0
        self.seconds = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, codewords: int):
        assert self._t0 is not None, "start() not called"
        self.seconds += time.time() - self._t0
        self.codewords += codewords
        self._t0 = None

    @property
    def codewords_per_sec(self) -> float:
        return self.codewords / self.seconds if self.seconds else 0.0
