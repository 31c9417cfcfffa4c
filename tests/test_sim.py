"""Monte-Carlo simulator tests (reference simulation_framework.py parity)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ldpc_tpu
from ldpc_tpu.sim import (
    LDPCSimulator,
    SimulationConfig,
    SimulationResult,
    create_test_decoders,
    simulate_single_snr,
)


def test_fer_decreases_with_snr(test_code):
    """With the sign convention fixed (SURVEY §8.1) the waterfall must be
    monotone — the reference's own MC path yields FER=1.0 at 10 dB."""
    dec = ldpc_tpu.basic_min_sum(test_code, max_iterations=10)
    cfg = SimulationConfig(max_frames=2048, max_errors=10**9, min_frames=0,
                           wave_size=512)
    fers = []
    for snr in (0.0, 4.0, 8.0):
        fer, ber, avg_iter, frames, errors = simulate_single_snr(
            dec, snr, cfg, key=jax.random.PRNGKey(1))
        fers.append(fer)
        assert 0.0 <= ber <= fer <= 1.0
        assert 1.0 <= avg_iter <= 10.0
    assert fers[0] > fers[1] > fers[2]
    assert fers[2] < 0.01


def test_stops_on_max_errors(test_code):
    dec = ldpc_tpu.basic_min_sum(test_code, max_iterations=5)
    cfg = SimulationConfig(max_frames=100000, max_errors=50, min_frames=0,
                           wave_size=256)
    # at 0 dB the (7,4) code fails often: should stop far before max_frames
    _, _, _, frames, errors = simulate_single_snr(
        dec, 0.0, cfg, key=jax.random.PRNGKey(0))
    assert errors >= 50
    assert frames < 100000


def test_min_frames_honored(test_code):
    dec = ldpc_tpu.basic_min_sum(test_code, max_iterations=5)
    cfg = SimulationConfig(max_frames=100000, max_errors=1, min_frames=2048,
                           wave_size=512)
    _, _, _, frames, _ = simulate_single_snr(
        dec, 0.0, cfg, key=jax.random.PRNGKey(0))
    assert frames >= 2048


def test_sweep_and_json_roundtrip(test_code, tmp_path):
    cfg = SimulationConfig(snr_range=(2.0, 4.0), snr_step=1.0,
                           max_frames=512, max_errors=10**9, min_frames=0,
                           wave_size=256, results_dir=str(tmp_path))
    sim = LDPCSimulator(cfg)
    decs = {
        "Basic": ldpc_tpu.basic_min_sum(test_code, max_iterations=8),
        "RCQ": ldpc_tpu.rcq_min_sum(test_code, bc=4, max_iterations=8),
    }
    results = sim.simulate_multiple_decoders(decs, verbose=False)
    assert set(results) == {"Basic", "RCQ"}
    assert len(results["Basic"].frame_error_rates) == 3

    path = sim.save_results(filename="out.json")
    with open(path) as f:
        raw = json.load(f)
    # reference-compatible keys (simulation_framework.py:344-353)
    assert set(raw["Basic"]) == {
        "decoder_name", "snr_values", "frame_error_rates", "bit_error_rates",
        "average_iterations", "simulation_times", "total_frames",
        "total_errors"}

    sim2 = LDPCSimulator(cfg)
    loaded = sim2.load_results("out.json")
    assert loaded["RCQ"].frame_error_rates == results["RCQ"].frame_error_rates


def test_decoder_zoo(test_code):
    """The reference's 9-decoder comparison set
    (simulation_framework.py:384-420) + W-OMS-RCQ (the paper's FPGA
    headline decoder, which the reference lacks)."""
    zoo = create_test_decoders(test_code, max_iterations=10)
    assert set(zoo) == {
        "Basic-MinSum", "N-NMS", "N-OMS", "N-2D-NMS-T1", "N-2D-NMS-T2",
        "N-2D-NMS-T3", "N-2D-NMS-T4", "RCQ", "W-RCQ-T2", "W-OMS-RCQ-T2"}
    # param-count goldens: 130 for N-NMS on (7,4)@10 iters
    # (IMPLEMENTATION_SUMMARY.md:165-172)
    assert zoo["N-NMS"].param_count() == 130
    assert zoo["Basic-MinSum"].param_count() == 0


def test_sharded_wave_matches_stats(test_code):
    """Mesh-sharded waves produce valid pooled statistics on 8 virtual
    devices (multi-chip path, SURVEY §5 'distributed backend')."""
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:8]), ("batch",))
    dec = ldpc_tpu.basic_min_sum(test_code, max_iterations=8)
    cfg = SimulationConfig(snr_range=(4.0, 4.0), snr_step=1.0,
                           max_frames=1024, max_errors=10**9, min_frames=0,
                           wave_size=1024)
    sim = LDPCSimulator(cfg, mesh=mesh)
    res = sim.simulate_decoder(dec, verbose=False)
    assert res.total_frames[0] == 1024
    assert 0.0 <= res.frame_error_rates[0] <= 1.0


def test_truncated_decoder_prefix_equivalence(test_code):
    """decoder.truncated(T1) reproduces the full decoder's outputs for
    frames that converge within T1 (the compaction exactness property)."""
    dec = ldpc_tpu.rcq_min_sum(test_code, bc=4, bv=8, max_iterations=10)
    short = dec.truncated(3)
    llr = ldpc_tpu.awgn_llr(jax.random.PRNGKey(0),
                            np.zeros((256, 7), np.float32), 3.0)
    a, b = dec(llr), short(llr)
    conv = np.asarray(b.success)
    np.testing.assert_array_equal(np.asarray(a.bits)[conv],
                                  np.asarray(b.bits)[conv])
    np.testing.assert_array_equal(np.asarray(a.iterations)[conv],
                                  np.asarray(b.iterations)[conv])
    with pytest.raises(ValueError):
        dec.truncated(11)


def test_compacting_wave_matches_full(mid_code):
    """Early-exit compaction must give identical pooled statistics to the
    plain full-depth wave (same key -> same noise)."""
    from ldpc_tpu.sim.montecarlo import (_make_compacting_wave_fn,
                                         _make_wave_fn)

    dec = ldpc_tpu.basic_min_sum(mid_code, max_iterations=15)
    full = _make_wave_fn(dec, 512)
    comp = _make_compacting_wave_fn(dec, 512, early_iters=3,
                                    survivor_budget=256)
    key = jax.random.PRNGKey(42)
    for snr in (2.0, 3.0):
        a = tuple(int(v) for v in full(key, jnp.float32(snr), dec.weights))
        b = tuple(int(v) for v in comp(key, jnp.float32(snr), dec.weights))
        assert a == b, f"snr={snr}: {a} != {b}"


def test_compacting_wave_overflow_fallback(mid_code):
    """At low SNR survivors exceed the budget -> full-wave fallback, still
    exact."""
    from ldpc_tpu.sim.montecarlo import (_make_compacting_wave_fn,
                                         _make_wave_fn)

    dec = ldpc_tpu.basic_min_sum(mid_code, max_iterations=15)
    full = _make_wave_fn(dec, 256)
    comp = _make_compacting_wave_fn(dec, 256, early_iters=2,
                                    survivor_budget=8)
    key = jax.random.PRNGKey(1)
    a = tuple(int(v) for v in full(key, jnp.float32(0.0), dec.weights))
    b = tuple(int(v) for v in comp(key, jnp.float32(0.0), dec.weights))
    assert a == b


def test_simulator_with_compaction(test_code):
    cfg = SimulationConfig(snr_range=(4.0, 4.0), snr_step=1.0,
                           max_frames=1024, max_errors=10**9, min_frames=0,
                           wave_size=512, early_exit_iters=2)
    dec = ldpc_tpu.basic_min_sum(test_code, max_iterations=10)
    res = LDPCSimulator(cfg).simulate_decoder(dec, verbose=False)
    assert res.total_frames[0] == 1024
    assert 0 <= res.frame_error_rates[0] < 0.2


def test_simulate_decoder_resume(test_code, tmp_path):
    """Checkpointed sweeps resume after interruption with identical stats
    (per-point RNG derivation makes resumed == uninterrupted)."""
    cfg = SimulationConfig(snr_range=(2.0, 5.0), snr_step=1.0,
                           max_frames=512, max_errors=10**9, min_frames=0,
                           wave_size=256)
    dec = ldpc_tpu.basic_min_sum(test_code, max_iterations=8)
    ck = str(tmp_path / "sweep.json")

    # uninterrupted run (no checkpoint)
    full = LDPCSimulator(cfg).simulate_decoder(dec, verbose=False)

    # interrupted: run only the first 2 points, then "crash"
    cfg2 = SimulationConfig(snr_range=(2.0, 3.0), snr_step=1.0,
                            max_frames=512, max_errors=10**9, min_frames=0,
                            wave_size=256)
    partial_res = LDPCSimulator(cfg2).simulate_decoder(
        dec, verbose=False, checkpoint=ck)
    assert len(partial_res.frame_error_rates) == 2

    # resume with the full range: first 2 points must be skipped... but the
    # checkpoint's snr grid differs (2 points vs 4), so it restarts — write
    # a proper partial file for the full grid instead
    import json as _json
    d = full.to_dict()
    for k in ("frame_error_rates", "bit_error_rates", "average_iterations",
              "simulation_times", "total_frames", "total_errors"):
        d[k] = d[k][:2]
    with open(ck, "w") as f:
        _json.dump(d, f)
    resumed = LDPCSimulator(cfg).simulate_decoder(dec, verbose=False,
                                                  checkpoint=ck)
    assert resumed.frame_error_rates == full.frame_error_rates
    assert resumed.total_frames == full.total_frames


def test_truncated_raises_on_incompatible_check_every():
    """A truncation depth off the parent's syndrome-check schedule must be
    rejected (silently rescheduling checks breaks freezing equivalence)."""
    from ldpc_tpu.decode.qc_engine import build_qc_graph

    base = np.array([[0, 1, 2], [2, 0, 1]])
    code = ldpc_tpu.create_qc_code(base, lift=8, max_iterations=8)
    qc = build_qc_graph(base, 8)
    dec = ldpc_tpu.rcq_min_sum(code, bc=4, max_iterations=8, qc=qc,
                               qc_options={"check_every": 4})
    with pytest.raises(ValueError):
        dec.truncated(3)
    short = dec.truncated(4)  # on the schedule: fine
    assert short.max_iterations == 4


def test_compacting_wave_honors_passed_weights(mid_code):
    """wave(key, snr, weights) must decode with the PASSED weights on every
    path (stage1, stage2, overflow fallback), not the weights captured at
    build time."""
    from ldpc_tpu.sim.montecarlo import (_make_compacting_wave_fn,
                                         _make_wave_fn)

    dec = ldpc_tpu.neural_2d_min_sum(mid_code, weight_sharing_type=3,
                                     max_iterations=15, init="nms")
    # alternative weights that decode differently from dec.weights
    alt = {k: (None if w is None else w * 0.5)
           for k, w in dec.weights.items()}
    full = _make_wave_fn(dec, 512)
    comp = _make_compacting_wave_fn(dec, 512, early_iters=3,
                                    survivor_budget=384)
    key = jax.random.PRNGKey(7)
    a = tuple(int(v) for v in full(key, jnp.float32(2.0), alt))
    b = tuple(int(v) for v in comp(key, jnp.float32(2.0), alt))
    assert a == b


def test_compacting_wave_fused_stage1_exact():
    """stage1_fused routes the truncated decode through the whole-decode
    Pallas kernel (interpret mode here); pooled stats must equal both the
    plain wave and the XLA-stage1 compaction bit-for-bit."""
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.sim.montecarlo import (_make_compacting_wave_fn,
                                         _make_wave_fn)

    base = np.array([[0, 3, 5, 7, 2], [4, 1, 6, 0, 3]])
    code = ldpc_tpu.create_qc_code(base, lift=16, max_iterations=8)
    qc = build_qc_graph(base, 16)
    # interpret-mode kernel on CPU: the caller sets it in qc_options
    dec = ldpc_tpu.rcq_min_sum(
        code, bc=4, max_iterations=8, qc=qc,
        qc_options={"check_every": 2, "interpret": True})
    full = _make_wave_fn(dec, 256)
    comp = _make_compacting_wave_fn(dec, 256, early_iters=2,
                                    survivor_budget=192)
    compf = _make_compacting_wave_fn(dec, 256, early_iters=2,
                                     survivor_budget=192, stage1_fused=True,
                                     stage1_batch_tile=32)
    key = jax.random.PRNGKey(17)
    a = tuple(int(v) for v in full(key, jnp.float32(2.5), dec.weights))
    b = tuple(int(v) for v in comp(key, jnp.float32(2.5), dec.weights))
    c = tuple(int(v) for v in compf(key, jnp.float32(2.5), dec.weights))
    assert a == b == c, (a, b, c)

    # incompatible schedule -> refuse
    bad = ldpc_tpu.rcq_min_sum(code, bc=4, max_iterations=8, qc=qc)
    with pytest.raises(ValueError):
        _make_compacting_wave_fn(bad, 256, early_iters=2,
                                 survivor_budget=64, stage1_fused=True)


@pytest.mark.parametrize("layered", [False, True])
def test_two_checkpoint_fused_compaction_exact(layered):
    """When the decoder under simulation is itself the fused kernel, the
    compaction wave implements the {T1, T} two-checkpoint decoder. It must
    match the explicit reference program (decode everyone at T1 AND at T,
    select by the T1 syndrome) bit-for-bit — on both the compacted and the
    overflow-fallback paths, for both schedules."""
    import dataclasses

    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.sim.montecarlo import _make_compacting_wave_fn

    base = np.array([[0, 3, 5, 7, 2], [4, 1, 6, 0, 3]])
    code = ldpc_tpu.create_qc_code(base, lift=16, max_iterations=8)
    qc = build_qc_graph(base, 16)
    fdec = ldpc_tpu.rcq_min_sum(
        code, bc=4, max_iterations=8, qc=qc, layered=layered,
        qc_options={"fused": True, "batch_tile": 16, "interpret": True,
                    "dtype": jnp.float32})
    T1 = 2
    short = dataclasses.replace(fdec, qc_options=None).truncated(T1)
    short = dataclasses.replace(short, qc_options=fdec.qc_options)

    def reference(key, snr):
        llr = ldpc_tpu.awgn_llr(key, jnp.zeros((256, code.n)), snr)
        w1 = {k: (None if v is None else v[:T1])
              for k, v in fdec.weights.items()}
        o1 = short(llr, w1)
        o2 = fdec(llr)
        conv = np.asarray(o1.success)
        bits = np.where(conv[:, None], np.asarray(o1.bits),
                        np.asarray(o2.bits))
        iters = np.where(conv, np.asarray(o1.iterations),
                         np.asarray(o2.iterations))
        succ = conv | np.asarray(o2.success)
        wrong = bits.sum(-1)
        return (int((wrong > 0).sum()), int(wrong.sum()), int(iters.sum()),
                int(succ.sum()))

    for budget, snr in ((192, 2.5),   # compacted path
                        (4, 1.0)):    # overflow -> fallback path
        wave = _make_compacting_wave_fn(fdec, 256, early_iters=T1,
                                        survivor_budget=budget,
                                        stage1_batch_tile=16)
        key = jax.random.PRNGKey(33)
        got = tuple(int(v) for v in wave(key, jnp.float32(snr),
                                         fdec.weights))
        assert got == reference(key, snr), (budget, snr)


def test_punctured_simulation():
    """punctured_positions zeroes those bits' channel LLRs: FER degrades
    vs the unpunctured run, the decoder still converges at high SNR, and
    the compaction path honors the puncturing too."""
    import ldpc_tpu
    from ldpc_tpu.channel import awgn_llr, puncture_llr

    code = ldpc_tpu.create_peg_code(n=128, m=64, dv=3, seed=1,
                                    max_iterations=12)
    dec = ldpc_tpu.basic_min_sum(code)
    punct = tuple(range(0, 8))

    # channel helper semantics
    llr = awgn_llr(jax.random.PRNGKey(0), jnp.zeros((4, code.n)), 3.0)
    pl = puncture_llr(llr, punct)
    assert not np.asarray(pl[:, :8]).any()
    np.testing.assert_array_equal(np.asarray(pl[:, 8:]),
                                  np.asarray(llr[:, 8:]))

    base_cfg = dict(snr_range=(0, 0), max_frames=2048, max_errors=10 ** 9,
                    min_frames=0, wave_size=1024, seed=3)
    plain = simulate_single_snr(dec, 3.0,
                                SimulationConfig(**base_cfg))[0]
    punctured = simulate_single_snr(
        dec, 3.0, SimulationConfig(punctured_positions=punct,
                                   **base_cfg))[0]
    assert punctured > plain

    # compaction path applies the same puncturing (pooled stats match the
    # plain punctured wave statistically; exactness machinery unchanged)
    comp = simulate_single_snr(
        dec, 3.0, SimulationConfig(punctured_positions=punct,
                                   early_exit_iters=4,
                                   survivor_budget=1024, **base_cfg))[0]
    assert comp == punctured  # identical keys + exact compaction


def test_two_checkpoint_inherits_parent_batch_tile():
    """The compaction wave must honor the parent decoder's own
    batch_tile — in particular batch_tile=None (the kernel sizes its own
    grid, ``auto_batch_tile``) — over the config's stage-1 tile, and must
    add no ``interpret`` of its own: that choice is the caller's."""
    from ldpc_tpu.decode.qc_engine import build_qc_graph
    from ldpc_tpu.sim.montecarlo import _fuse_opts, _make_compacting_wave_fn

    assert _fuse_opts({"batch_tile": None}, 32)["batch_tile"] is None
    assert _fuse_opts({"dtype": jnp.float32}, 32)["batch_tile"] == 32
    rng = np.random.default_rng(3)
    base = rng.integers(0, 32, size=(3, 12))
    code = ldpc_tpu.create_qc_code(base, lift=32, max_iterations=2)
    qc = build_qc_graph(base, 32)
    dec = ldpc_tpu.rcq_min_sum(
        code, bc=3, max_iterations=2, qc=qc, layered=True,
        qc_options={"fused": True, "batch_tile": None, "interpret": True,
                    "dtype": jnp.float32})
    wave = _make_compacting_wave_fn(dec, wave_size=16, early_iters=1,
                                    survivor_budget=8, stage1_batch_tile=3)
    out = wave(jax.random.PRNGKey(0), jnp.float32(6.0), dec.weights)
    assert int(out[0]) >= 0    # ran end-to-end on the auto-sized grid


@pytest.mark.parametrize("parent", [{}, {"interpret": True}])
def test_fuse_opts_adds_no_interpret(parent):
    """Library code never turns interpret mode on by itself: the fused
    options carry ``interpret`` only when the parent decoder set it."""
    from ldpc_tpu.sim.montecarlo import _fuse_opts

    o = _fuse_opts(dict(parent, check_every=2, unroll=True), None)
    assert o["fused"] is True
    assert "check_every" not in o and "unroll" not in o
    assert o.get("interpret") == parent.get("interpret")
