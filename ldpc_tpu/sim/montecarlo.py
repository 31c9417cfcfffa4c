"""Batched Monte-Carlo FER/BER simulation engine.

Capability parity with the reference's ``LDPSimulator``
(``simulation_framework.py:71-382``) — per-SNR frame loop until
``max_frames`` or ``max_errors``, SNR sweep, multi-decoder comparison, JSON
persistence — redesigned for batched accelerators:

- frames are decoded in large jitted *waves* (``wave_size`` codewords per
  device step) instead of one Python-loop frame at a time
  (``simulation_framework.py:110-131``);
- the all-zero-codeword trick: channel LLRs for the zero word are drawn
  directly (BPSK(0) = +1), the decoder runs batched, and error statistics
  (frame errors, bit errors, iteration counts) are reduced on device — a
  single scalar-tuple transfer per wave;
- ``min_frames`` is honored (the reference declares it and never reads it,
  SURVEY §8.9);
- optional mesh sharding: pass ``mesh`` and waves are sharded over the batch
  axis with ``jax.sharding.NamedSharding``; error counters come back via a
  replicated-sum, so multi-chip simulation is the same code path
  (see ``ldpc_tpu/parallel``).

JSON result format is key-compatible with the reference's
``save_results``/``load_results`` (``simulation_framework.py:338-382``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldpc_tpu.channel import awgn_llr, puncture_llr
from ldpc_tpu.decode.early_exit import onehot_select
from ldpc_tpu.decode.variants import Decoder

logger = logging.getLogger(__name__)

__all__ = [
    "SimulationConfig",
    "SimulationResult",
    "LDPCSimulator",
    "simulate_single_snr",
]


@dataclasses.dataclass
class SimulationConfig:
    """Mirrors the reference ``SimulationConfig``
    (``simulation_framework.py:27-38``) plus batching knobs."""

    snr_range: Tuple[float, float] = (0.0, 6.0)
    snr_step: float = 0.5
    max_frames: int = 10000
    max_errors: int = 100
    min_frames: int = 1000
    wave_size: int = 1024          # codewords per jitted device step
    seed: int = 0
    save_results: bool = True
    results_dir: str = "simulation_results"
    # early-termination wave compaction: decode every frame for
    # ``early_exit_iters`` first, then re-decode only the unconverged
    # survivors at full depth. EXACTLY equivalent to full-depth decoding
    # (first-convergence freezing), but at operating SNR most frames
    # converge in a few iterations so throughput rises ~T/early_exit_iters.
    early_exit_iters: Optional[int] = None
    survivor_budget: Optional[int] = None  # default: wave_size // 4
    # run the compaction's stage-1 (truncated) decode through the
    # whole-decode fused Pallas kernel. Exact: fused(T=T1) has the same
    # check-at-T1 contract as the truncated XLA engine when the decoder's
    # check_every equals early_exit_iters (enforced). QC decoders only.
    stage1_fused: bool = False
    # frames per kernel program (None: pallas_fused.auto_batch_tile). This
    # knob applies only when the decoder's qc_options omit "batch_tile";
    # a parent decoder that set any batch_tile wins for both stages.
    stage1_batch_tile: Optional[int] = None
    # bit positions transmitted with no channel observation (punctured,
    # LLR 0) — rate-compatible/PBRL simulation; single-device waves only
    punctured_positions: Optional[Tuple[int, ...]] = None

    def snr_points(self) -> np.ndarray:
        lo, hi = self.snr_range
        return np.arange(lo, hi + 1e-9, self.snr_step)


class SimulationResult:
    """Per-decoder result container; field names match the reference
    (``simulation_framework.py:40-69``) so saved JSON is interchangeable."""

    def __init__(self, decoder_name: str, snr_values: Sequence[float]):
        self.decoder_name = decoder_name
        self.snr_values = list(snr_values)
        self.frame_error_rates: List[float] = []
        self.bit_error_rates: List[float] = []
        self.average_iterations: List[float] = []
        self.simulation_times: List[float] = []
        self.total_frames: List[int] = []
        self.total_errors: List[int] = []

    def add_result(self, snr_idx: int, fer: float, ber: float, avg_iter: float,
                   sim_time: float, total_frames: int, total_errors: int):
        while len(self.frame_error_rates) <= snr_idx:
            for lst, fill in (
                (self.frame_error_rates, 0.0), (self.bit_error_rates, 0.0),
                (self.average_iterations, 0.0), (self.simulation_times, 0.0),
                (self.total_frames, 0), (self.total_errors, 0),
            ):
                lst.append(fill)
        self.frame_error_rates[snr_idx] = float(fer)
        self.bit_error_rates[snr_idx] = float(ber)
        self.average_iterations[snr_idx] = float(avg_iter)
        self.simulation_times[snr_idx] = float(sim_time)
        self.total_frames[snr_idx] = int(total_frames)
        self.total_errors[snr_idx] = int(total_errors)

    def to_dict(self) -> dict:
        return {
            "decoder_name": self.decoder_name,
            "snr_values": self.snr_values,
            "frame_error_rates": self.frame_error_rates,
            "bit_error_rates": self.bit_error_rates,
            "average_iterations": self.average_iterations,
            "simulation_times": self.simulation_times,
            "total_frames": self.total_frames,
            "total_errors": self.total_errors,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationResult":
        r = cls(d["decoder_name"], d["snr_values"])
        r.frame_error_rates = list(d["frame_error_rates"])
        r.bit_error_rates = list(d["bit_error_rates"])
        r.average_iterations = list(d["average_iterations"])
        r.simulation_times = list(d["simulation_times"])
        r.total_frames = list(d["total_frames"])
        r.total_errors = list(d["total_errors"])
        return r


def _make_wave_fn(decoder: Decoder, wave_size: int, mesh=None,
                  punctured=None):
    """Build the jitted one-wave kernel: key, snr, weights ->
    (frame_errors, bit_errors, iter_sum, success_count), all scalars.

    All-zero codewords are transmitted (``simulation_framework.py:107``), so
    any decoded 1-bit is an error. The whole wave — channel, decode, error
    reduction — is one XLA program; only four scalars leave the device.

    With a mesh, the SPMD shard_map path is used instead (per-device RNG,
    psum'd counters — ``ldpc_tpu.parallel.make_spmd_wave_fn``).
    """
    if mesh is not None:
        from ldpc_tpu.parallel.montecarlo import make_spmd_wave_fn
        return make_spmd_wave_fn(decoder, wave_size, mesh,
                                 punctured=punctured)

    n = decoder.code.n

    def wave(key, snr_db, weights):
        zeros = jnp.zeros((wave_size, n), jnp.float32)
        llr = awgn_llr(key, zeros, snr_db)
        if punctured is not None:
            llr = puncture_llr(llr, punctured)
        out = decoder(llr, weights)
        bit_err_per_frame = jnp.sum(out.bits, axis=-1)        # wrong bits
        frame_err = jnp.sum(bit_err_per_frame > 0)
        bit_err = jnp.sum(bit_err_per_frame)
        iter_sum = jnp.sum(out.iterations)
        succ = jnp.sum(out.success)
        return frame_err, bit_err, iter_sum, succ

    return jax.jit(wave)


def _fuse_opts(base_opts: dict, stage1_batch_tile=None) -> dict:
    """Route a decoder's options to the whole-decode kernel: the check
    schedule options go, and the parent's own ``batch_tile`` wins when it
    set one (including ``None``, auto-sizing). ``interpret`` is inherited
    from the parent, never chosen here."""
    o = dict(base_opts)
    o.pop("check_every", None)
    o.pop("unroll", None)
    o["fused"] = True
    o["batch_tile"] = base_opts.get("batch_tile", stage1_batch_tile)
    return o


def _make_compacting_wave_fn(decoder: Decoder, wave_size: int,
                             early_iters: int, survivor_budget: int,
                             stage1_fused: bool = False,
                             stage1_batch_tile: int | None = None,
                             punctured=None):
    """Two-stage wave with survivor compaction (see ``SimulationConfig``).

    Returns a callable with the same (key, snr, weights) -> 4-scalar
    contract as the plain wave. Exactness: a frame converged by iteration
    ``early_iters`` is frozen at first convergence, so the full-depth
    decode would return the identical output; survivors are re-decoded
    from scratch at full depth (deterministic message passing) — pooled
    statistics equal the full-depth wave's bit-for-bit.
    """
    import dataclasses as _dc

    n = decoder.code.n
    parent_opts = dict(decoder.qc_options or {})
    parent_fused = bool(parent_opts.get("fused"))
    ce = parent_opts.get("check_every")
    if ce and early_iters % ce:
        # stage-1 convergence must be judged on the SAME check schedule as
        # the full decoder (Decoder.truncated raises otherwise); round the
        # truncation depth up to the next check boundary — still exact,
        # just slightly deeper than requested
        early_iters = ((early_iters + ce - 1) // ce) * ce
    T1 = early_iters

    if parent_fused:
        # TWO-CHECKPOINT FUSED WAVE: the decoder under simulation is the
        # fused kernel itself, whose syndrome schedule is {T}. The
        # compaction adds an early checkpoint: the effective decoder
        # checks at {T1, T} — frames converged at T1 freeze there (their
        # stage-1 output IS their result), survivors re-decode at full
        # depth with the final check at T. This is a fully-specified
        # decoder in its own right; the equivalent single program is
        # "decode everyone at T1, decode everyone at T, select by the T1
        # syndrome" (tests/test_sim.py builds exactly that comparator).
        short = _dc.replace(decoder, qc_options=None).truncated(T1)
        fopts = _fuse_opts(parent_opts, stage1_batch_tile)
        short = _dc.replace(short, qc_options=fopts)
        # stage 2 decodes only the S survivor rows (the fused kernels take
        # any batch size, so the tile option is kept)
        decoder = _dc.replace(decoder, qc_options=fopts)
    else:
        short = decoder.truncated(early_iters)
        if stage1_fused:
            if decoder.qc is None:
                raise ValueError("stage1_fused needs a QC decoder")
            if ce != T1:
                raise ValueError(
                    f"stage1_fused requires check_every == early_exit_iters "
                    f"(got {ce} vs {T1}): the fused kernel checks once at "
                    "T1, which must be the truncated decoder's schedule")
            short = _dc.replace(short, qc_options=_fuse_opts(
                short.qc_options or {}, stage1_batch_tile))
    S = survivor_budget

    def _cut(w):  # the truncated decoder consumes [:T1]-sliced weights
        return jax.tree_util.tree_map(lambda a: a[:T1], w)

    if parent_fused:
        # overflow fallback with the SAME {T1, T} schedule: decode everyone
        # at both depths and select by the T1 syndrome
        @jax.jit
        def full_fn(key, snr_db, weights):
            llr = awgn_llr(key, jnp.zeros((wave_size, n), jnp.float32),
                           snr_db)
            if punctured is not None:
                llr = puncture_llr(llr, punctured)
            out1 = short(llr, _cut(weights))
            out2 = decoder(llr, weights)
            conv = out1.success
            bits = jnp.where(conv[:, None], out1.bits, out2.bits)
            iters = jnp.where(conv, out1.iterations, out2.iterations)
            succ = conv | out2.success
            wrong = jnp.sum(bits, axis=-1)
            return (jnp.sum(wrong > 0), jnp.sum(wrong), jnp.sum(iters),
                    jnp.sum(succ))
    else:
        full_fn = _make_wave_fn(decoder, wave_size, punctured=punctured)

    @jax.jit
    def fused(key, snr_db, weights):
        """Truncated decode + survivor compaction + full-depth re-decode in
        ONE program; a single 5-scalar host transfer per wave.

        Compaction is a cumsum-ranked one-hot MATMUL: ``P[r, i] = 1`` iff
        frame i is the r-th unconverged frame, and ``surv = P @ llr`` at
        full precision (no TF32) selects the survivor rows exactly.
        """
        llr = awgn_llr(key, jnp.zeros((wave_size, n), jnp.float32), snr_db)
        if punctured is not None:
            llr = puncture_llr(llr, punctured)
        out = short(llr, _cut(weights))
        conv = out.success
        wrong = jnp.sum(out.bits, axis=-1)
        fe = jnp.sum((wrong > 0) & conv)
        be = jnp.sum(jnp.where(conv, wrong, 0))
        it = jnp.sum(jnp.where(conv, out.iterations, 0))
        sc = jnp.sum(conv)
        n_surv = wave_size - sc

        unconv = ~conv
        rank = jnp.cumsum(unconv.astype(jnp.int32)) - 1  # stable order
        P = ((rank[None, :] == jnp.arange(S)[:, None]) & unconv[None, :]
             ).astype(jnp.float32)
        surv_llr = onehot_select(P, llr)  # [S, n]; rows >= n_surv are 0

        out2 = decoder(surv_llr, weights)
        valid = jnp.arange(S) < n_surv
        wrong2 = jnp.sum(out2.bits, axis=-1)
        fe2 = jnp.sum((wrong2 > 0) & valid)
        be2 = jnp.sum(jnp.where(valid, wrong2, 0))
        it2 = jnp.sum(jnp.where(valid, out2.iterations, 0))
        sc2 = jnp.sum(out2.success & valid)
        return fe + fe2, be + be2, it + it2, sc + sc2, n_surv

    def wave(key, snr_db, weights):
        fe, be, it, sc, n_surv = fused(key, snr_db, weights)
        if int(n_surv) > S:
            # survivor overflow (low-SNR operating point): the compaction
            # assumption doesn't hold — decode the whole wave at full depth
            return full_fn(key, snr_db, weights)
        return fe, be, it, sc

    wave.compacted = fused  # the one-program wave, for inspection
    return wave


def _build_wave(decoder: Decoder, config: "SimulationConfig", mesh=None):
    punct = config.punctured_positions
    if config.early_exit_iters is not None:
        budget = (config.survivor_budget if config.survivor_budget is not None
                  else max(1, config.wave_size // 4))
        if mesh is not None:
            from ldpc_tpu.parallel.montecarlo import \
                make_spmd_compacting_wave_fn
            return make_spmd_compacting_wave_fn(
                decoder, config.wave_size, config.early_exit_iters, budget,
                mesh, stage1_fused=config.stage1_fused,
                stage1_batch_tile=config.stage1_batch_tile,
                punctured=punct)
        return _make_compacting_wave_fn(decoder, config.wave_size,
                                        config.early_exit_iters, budget,
                                        config.stage1_fused,
                                        config.stage1_batch_tile,
                                        punctured=punct)
    return _make_wave_fn(decoder, config.wave_size, mesh,
                         punctured=punct)


def simulate_single_snr(
    decoder: Decoder,
    snr_db: float,
    config: SimulationConfig,
    key: Optional[jax.Array] = None,
    wave_fn=None,
) -> Tuple[float, float, float, int, int]:
    """Monte-Carlo at one SNR point: returns (fer, ber, avg_iter, frames,
    frame_errors).

    Stopping rule matches ``simulation_framework.py:110-131`` — run until
    ``frames >= max_frames`` or ``frame_errors >= max_errors`` — with the
    addition that ``min_frames`` is actually enforced (SURVEY §8.9) and
    frames advance in waves of ``config.wave_size``.
    """
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    if wave_fn is None:
        wave_fn = _build_wave(decoder, config, mesh=None)

    frames = 0
    frame_errors = 0
    bit_errors = 0
    iter_sum = 0
    last_beat = time.time()
    while frames < config.max_frames:
        if frame_errors >= config.max_errors and frames >= config.min_frames:
            break
        key, sub = jax.random.split(key)
        fe, be, it, _ = wave_fn(sub, jnp.float32(snr_db), decoder.weights)
        frames += config.wave_size
        frame_errors += int(fe)
        bit_errors += int(be)
        iter_sum += int(it)
        now = time.time()
        if now - last_beat >= 60:
            # heartbeat for long (deep-FER) points: lets log-staleness
            # watchdogs tell a slow healthy campaign from a hung one
            last_beat = now
            logger.info("  ... %.2f dB: %d/%d frames, %d errors",
                        snr_db, frames, config.max_frames, frame_errors)

    fer = frame_errors / frames
    ber = bit_errors / (frames * decoder.code.n)
    avg_iter = iter_sum / frames
    return fer, ber, avg_iter, frames, frame_errors


class LDPCSimulator:
    """Multi-decoder Monte-Carlo harness (reference ``LDPSimulator``,
    ``simulation_framework.py:71-382``).

    The reference parallelizes across decoders with a thread pool
    (``:192-208``); here each decoder's sweep is already device-saturating
    (batched waves), so decoders run sequentially and share the chip —
    cross-*chip* scaling is via the ``mesh`` argument instead.
    """

    def __init__(self, config: Optional[SimulationConfig] = None, mesh=None):
        self.config = config or SimulationConfig()
        self.mesh = mesh
        self.results: Dict[str, SimulationResult] = {}

    def simulate_decoder(self, decoder: Decoder,
                         decoder_name: Optional[str] = None,
                         verbose: bool = True,
                         checkpoint: Optional[str] = None) -> SimulationResult:
        """SNR sweep for one decoder (``simulation_framework.py:141-176``).

        ``checkpoint``: path of a JSON file updated after every SNR point;
        if it already exists, completed points are skipped on restart —
        resumable long Monte-Carlo campaigns (a capability the reference
        lacks entirely, SURVEY §5). RNG keys are derived per (seed, SNR
        index), so resumed and uninterrupted runs produce identical
        statistics.
        """
        name = decoder_name or decoder.name
        snrs = self.config.snr_points()
        result = SimulationResult(name, [float(s) for s in snrs])
        done_points = 0
        if checkpoint and os.path.exists(checkpoint):
            with open(checkpoint) as f:
                saved = SimulationResult.from_dict(json.load(f))
            if saved.snr_values == result.snr_values:
                result = saved
                done_points = len(saved.frame_error_rates)
                if verbose and done_points:
                    logger.info("%s: resuming after %d completed SNR points",
                                name, done_points)
        wave_fn = _build_wave(decoder, self.config, self.mesh)
        base_key = jax.random.PRNGKey(self.config.seed)
        for idx, snr in enumerate(snrs):
            if idx < done_points:
                continue
            sub = jax.random.fold_in(base_key, idx)
            t0 = time.time()
            fer, ber, avg_iter, frames, errors = simulate_single_snr(
                decoder, float(snr), self.config, key=sub, wave_fn=wave_fn)
            dt = time.time() - t0
            result.add_result(idx, fer, ber, avg_iter, dt, frames, errors)
            if checkpoint:
                with open(checkpoint, "w") as f:
                    json.dump(result.to_dict(), f)
            if verbose:
                logger.info(
                    "%s @ %.2f dB: FER=%.3e BER=%.3e iters=%.2f "
                    "(%d frames, %.2fs, %.0f fps)",
                    name, snr, fer, ber, avg_iter, frames, dt, frames / dt)
        self.results[name] = result
        return result

    def simulate_multiple_decoders(
        self, decoders: Dict[str, Decoder], verbose: bool = True
    ) -> Dict[str, SimulationResult]:
        """Compare several decoders (``simulation_framework.py:178-216``)."""
        for name, dec in decoders.items():
            try:
                self.simulate_decoder(dec, name, verbose=verbose)
            except Exception:  # parity: a failing decoder is dropped (:207)
                logger.exception("decoder %s failed; dropped from results",
                                 name)
        return self.results

    # -- plotting (reference API parity: plot_* live on the simulator,
    #    simulation_framework.py:218-336; implementations in ldpc_tpu.report)

    def plot_fer_curves(self, path: str = "fer_comparison.png",
                        results=None):
        from ldpc_tpu.report import plot_fer_curves
        return plot_fer_curves(results or self.results, path)

    def plot_ber_curves(self, path: str = "ber_comparison.png",
                        results=None):
        from ldpc_tpu.report import plot_ber_curves
        return plot_ber_curves(results or self.results, path)

    def plot_iteration_curves(self, path: str = "iterations.png",
                              results=None):
        from ldpc_tpu.report import plot_iteration_curves
        return plot_iteration_curves(results or self.results, path)

    def plot_timing_curves(self, path: str = "timing.png", results=None):
        from ldpc_tpu.report import plot_timing_curves
        return plot_timing_curves(results or self.results, path)

    # -- persistence (format-compatible with simulation_framework.py:338-382)

    def save_results(self,
                     results: Optional[Dict[str, SimulationResult]] = None,
                     filename: str = "simulation_results.json"):
        """Argument order matches the reference's ``save_results(results,
        filename)`` (``simulation_framework.py:338``) so ported callers work
        positionally; pass ``filename=`` alone to save ``self.results``."""
        results = results if results is not None else self.results
        os.makedirs(self.config.results_dir, exist_ok=True)
        path = os.path.join(self.config.results_dir, filename)
        with open(path, "w") as f:
            json.dump({k: r.to_dict() for k, r in results.items()}, f,
                      indent=2)
        logger.info("Results saved to %s", path)
        return path

    def load_results(self, filename: str) -> Dict[str, SimulationResult]:
        path = os.path.join(self.config.results_dir, filename)
        with open(path) as f:
            data = json.load(f)
        results = {k: SimulationResult.from_dict(v) for k, v in data.items()}
        self.results.update(results)
        return results


def create_test_decoders(code, max_iterations: int = 10) -> Dict[str, Decoder]:
    """The reference's 9-decoder comparison zoo
    (``simulation_framework.py:384-420``)."""
    from ldpc_tpu.decode.variants import (
        basic_min_sum, neural_2d_min_sum, neural_min_sum,
        neural_offset_min_sum, rcq_min_sum, weighted_rcq)

    zoo: Dict[str, Decoder] = {
        "Basic-MinSum": basic_min_sum(code, factor=0.7,
                                      max_iterations=max_iterations),
        "N-NMS": neural_min_sum(code, max_iterations=max_iterations),
        "N-OMS": neural_offset_min_sum(code, max_iterations=max_iterations),
    }
    for t in (1, 2, 3, 4):
        zoo[f"N-2D-NMS-T{t}"] = neural_2d_min_sum(
            code, weight_sharing_type=t, max_iterations=max_iterations)
    zoo["RCQ"] = rcq_min_sum(
        code, bc=3, bv=8,
        quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
        max_iterations=max_iterations)
    zoo["W-RCQ-T2"] = weighted_rcq(
        code, bc=3, bv=8, weight_sharing_type=2,
        quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
        max_iterations=max_iterations)
    # beyond the reference's nine: the paper's FPGA headline decoder
    # (§VII-B), which the reference never implemented
    from ldpc_tpu.decode.variants import weighted_oms_rcq
    zoo["W-OMS-RCQ-T2"] = weighted_oms_rcq(
        code, bc=3, bv=8, weight_sharing_type=2,
        quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3)),
        max_iterations=max_iterations)
    return zoo
