"""Two-checkpoint early-exit decode API (decode/early_exit.py): exactness
against the explicit {t1, T} comparator, overflow semantics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ldpc_tpu
from ldpc_tpu.channel import awgn_llr
from ldpc_tpu.decode.early_exit import make_two_checkpoint_decoder
from ldpc_tpu.decode.qc_engine import build_qc_graph


def _fused_decoder(T=5, lift=16, seed=2):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, lift, size=(2, 5))
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    qc = build_qc_graph(base, lift)
    return ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, bv=8, max_iterations=T, qc=qc,
        qc_options={"fused": True, "batch_tile": 16, "interpret": True,
                    "dtype": jnp.float32})


def test_two_checkpoint_matches_comparator():
    T, t1 = 5, 2
    dec = _fused_decoder(T=T)
    B = 64
    llr = awgn_llr(jax.random.PRNGKey(0), jnp.zeros((B, dec.code.n)), 1.5)

    fn = make_two_checkpoint_decoder(dec, t1=t1, survivor_budget=B)
    out, n_surv = fn(llr)
    assert 0 < int(n_surv) < B  # the point needs both populations

    # comparator: decode everyone at t1 AND at T, select by the t1 syndrome
    opts = dict(dec.qc_options)
    short = dataclasses.replace(dec, qc_options=None).truncated(t1)
    short = dataclasses.replace(short, qc_options=opts)
    o1 = short(llr)
    o2 = dec(llr)
    conv = np.asarray(o1.success)
    exp_post = np.where(conv[:, None], np.asarray(o1.posterior),
                        np.asarray(o2.posterior))
    exp_succ = np.where(conv, True, np.asarray(o2.success))
    exp_iter = np.where(conv, t1, T)

    np.testing.assert_allclose(np.asarray(out.posterior), exp_post,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.success), exp_succ)
    np.testing.assert_array_equal(np.asarray(out.iterations), exp_iter)
    np.testing.assert_array_equal(np.asarray(out.bits),
                                  (exp_post < 0).astype(np.int32))


def test_two_checkpoint_budget_overflow():
    T, t1 = 5, 2
    dec = _fused_decoder(T=T)
    B = 64
    # low SNR: most frames survive stage 1, budget of 4 must overflow
    llr = awgn_llr(jax.random.PRNGKey(1), jnp.zeros((B, dec.code.n)), -2.0)
    fn = make_two_checkpoint_decoder(dec, t1=t1, survivor_budget=4)
    out, n_surv = fn(llr)
    assert int(n_surv) > 4  # overflow detectable by the caller

    # out-of-budget frames keep their stage-1 output with success=False
    opts = dict(dec.qc_options)
    short = dataclasses.replace(dec, qc_options=None).truncated(t1)
    short = dataclasses.replace(short, qc_options=opts)
    o1 = short(llr)
    unconv = ~np.asarray(o1.success)
    rank = np.cumsum(unconv) - 1
    overflow = unconv & (rank >= 4)
    assert overflow.any()
    np.testing.assert_allclose(np.asarray(out.posterior)[overflow],
                               np.asarray(o1.posterior)[overflow],
                               rtol=1e-6)
    assert not np.asarray(out.success)[overflow].any()


def test_two_checkpoint_validation():
    dec = _fused_decoder(T=5)
    import pytest
    with pytest.raises(ValueError):
        make_two_checkpoint_decoder(dec, t1=5, survivor_budget=8)
    with pytest.raises(ValueError):
        make_two_checkpoint_decoder(dec, t1=2, survivor_budget=0)


def test_two_checkpoint_layered_fused_bench_path():
    """The bench configuration's exact shape: layered fused kernel under
    the {t1, T} wrapper (interpret mode), vs the explicit comparator."""
    T, t1 = 6, 3
    rng = np.random.default_rng(4)
    lift = 16
    base = rng.integers(0, lift, size=(2, 6))
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    qc = build_qc_graph(base, lift)
    dec = ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, bv=8, max_iterations=T, qc=qc,
        layered=True,
        quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
        v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
        qc_options={"fused": True, "batch_tile": 16, "interpret": True,
                    "dtype": jnp.float32})
    B = 48
    llr = awgn_llr(jax.random.PRNGKey(2), jnp.zeros((B, code.n)), 5.0)
    fn = make_two_checkpoint_decoder(dec, t1=t1, survivor_budget=24)
    out, n_surv = fn(llr)
    assert 0 < int(n_surv) <= 24  # mixed population, within budget

    opts = dict(dec.qc_options)
    short = dataclasses.replace(dec, qc_options=None).truncated(t1)
    short = dataclasses.replace(short, qc_options=opts)
    o1, o2 = short(llr), dec(llr)
    conv = np.asarray(o1.success)
    exp_post = np.where(conv[:, None], np.asarray(o1.posterior),
                        np.asarray(o2.posterior))
    np.testing.assert_allclose(np.asarray(out.posterior), exp_post,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.success),
                                  np.where(conv, True,
                                           np.asarray(o2.success)))


def test_two_checkpoint_lean():
    """The lean bench path: both stages run the lean fused epilogue; the
    merged bits/success/iterations match the full-output wrapper."""
    T, t1 = 6, 3
    rng = np.random.default_rng(4)
    lift = 16
    base = rng.integers(0, lift, size=(2, 6))
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    qc = build_qc_graph(base, lift)

    def build(lean):
        return ldpc_tpu.make_decoder(
            code, kind="rcq", bc=3, bv=8, max_iterations=T, qc=qc,
            layered=True,
            quantizer_params=((2.0, 1.3), (4.0, 1.3), (6.0, 1.3)),
            v2c_quantizer_params=((4.0, 1.0), (8.0, 1.0), (12.0, 1.0)),
            qc_options={"fused": True, "batch_tile": 16, "interpret": True,
                        "dtype": jnp.float32, "lean": lean})

    B = 48
    llr = awgn_llr(jax.random.PRNGKey(2), jnp.zeros((B, code.n)), 5.0)
    out_f, ns_f = make_two_checkpoint_decoder(build(False), t1=t1,
                                              survivor_budget=24)(llr)
    out_l, ns_l = make_two_checkpoint_decoder(build(True), t1=t1,
                                              survivor_budget=24)(llr)
    assert int(ns_f) == int(ns_l) and 0 < int(ns_l) <= 24
    assert out_l.posterior is None and out_l.bits.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(out_l.bits),
                                  np.asarray(out_f.bits))
    np.testing.assert_array_equal(np.asarray(out_l.success),
                                  np.asarray(out_f.success))
    np.testing.assert_array_equal(np.asarray(out_l.iterations),
                                  np.asarray(out_f.iterations))


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, nested ones included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    out += _dot_precisions(sub.jaxpr)
    return out


@pytest.mark.parametrize("path", ["early_exit", "sim", "parallel"])
def test_compaction_matmuls_are_full_precision(path):
    """The one-hot survivor matmuls on float32 LLRs carry
    ``Precision.HIGHEST``: on a GPU a default-precision f32 matmul may run
    in TF32, which would re-decode survivors on rounded LLRs."""
    from jax.sharding import Mesh

    from ldpc_tpu.parallel.montecarlo import make_spmd_compacting_wave_fn
    from ldpc_tpu.sim.montecarlo import _make_compacting_wave_fn

    rng = np.random.default_rng(0)
    base = rng.integers(0, 16, size=(2, 5))
    code = ldpc_tpu.create_qc_code(base, lift=16, max_iterations=4)
    dec = ldpc_tpu.make_decoder(code, kind="rcq", bc=3, max_iterations=4,
                                qc=build_qc_graph(base, 16))
    key, snr = jax.random.PRNGKey(0), jnp.float32(3.0)
    if path == "early_exit":
        fn = make_two_checkpoint_decoder(dec, t1=2, survivor_budget=8)
        jaxpr = jax.make_jaxpr(fn)(jnp.zeros((32, code.n), jnp.float32))
    elif path == "sim":
        wave = _make_compacting_wave_fn(dec, 32, early_iters=2,
                                        survivor_budget=8)
        jaxpr = jax.make_jaxpr(wave.compacted)(key, snr, dec.weights)
    else:
        mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))
        fn = make_spmd_compacting_wave_fn(dec, 32, 2, 8, mesh)
        jaxpr = jax.make_jaxpr(fn)(key, snr, dec.weights)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs, "no compaction matmul found"
    for p in precs:
        p = p if isinstance(p, tuple) else (p, p)
        assert all(x == jax.lax.Precision.HIGHEST for x in p), precs
