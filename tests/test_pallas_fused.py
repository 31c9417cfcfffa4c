"""Whole-decode fused Pallas kernels vs the XLA QC engines (interpret mode;
the compiled kernels are checked on the GPU by ``chip_smoke.py`` and by the
``gpu``-marked test at the end of this file).

The fused kernel's contract is qc_decode_batch(check_every=T): final-
iteration posterior, syndrome evaluated once at the end. Hard outputs
(bits / success / iterations) must agree exactly; posteriors are compared
to ~1 ulp because XLA contracts mul+add chains into FMAs when compiling
the engine's scan (verified: the fused kernel matches a strict
float32-rounded numpy recomputation to the bit; the XLA engine is the one
that deviates by 1 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ldpc_tpu
from ldpc_tpu.channel import awgn_llr
from ldpc_tpu.decode.pallas_fused import (auto_batch_tile,
                                          qc_fused_decode_batch)
from ldpc_tpu.decode.qc_engine import build_qc_graph, qc_decode_batch


def _setup(mb, nb, lift, T, base_seed=0, density=1.0, **kw):
    rng = np.random.default_rng(base_seed)
    base = rng.integers(0, lift, size=(mb, nb))
    if density < 1.0:
        mask = rng.random((mb, nb)) < (1.0 - density)
        base = np.where(mask, -1, base)
        for i in range(mb):
            if (base[i] >= 0).sum() == 0:
                base[i, rng.integers(nb)] = rng.integers(lift)
        for j in range(nb):
            if (base[:, j] >= 0).sum() == 0:
                base[rng.integers(mb), j] = rng.integers(lift)
    code = ldpc_tpu.create_qc_code(base, lift=lift, max_iterations=T)
    qc = build_qc_graph(base, lift)
    dec = ldpc_tpu.make_decoder(code, max_iterations=T, qc=qc, **kw)
    return code, qc, dec


@pytest.mark.parametrize("kw", [
    dict(kind="ms", factor=0.7),
    dict(kind="nms", sharing_type=2, seed=1, init="nms"),
    dict(kind="oms", sharing_type=2, seed=5),
    dict(kind="rcq", bc=3,
         quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))),
    dict(kind="rcq", bc=3, bv=8,
         quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))),
    dict(kind="wrcq", bc=4, sharing_type=2, seed=6, init="nms"),
    dict(kind="orcq", bc=3, sharing_type=2, seed=7),
])
def test_fused_matches_qc_engine_f32(kw):
    T = 6
    code, qc, dec = _setup(3, 8, 16, T, base_seed=0, density=0.8, **kw)
    llr = awgn_llr(jax.random.PRNGKey(7), jnp.zeros((64, code.n)), 2.5)
    ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T,
                          dtype=jnp.float32)
    out = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, dtype=jnp.float32,
                                batch_tile=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(np.asarray(out.success),
                                  np.asarray(ref.success))
    np.testing.assert_array_equal(np.asarray(out.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(np.asarray(out.posterior),
                               np.asarray(ref.posterior),
                               rtol=1e-6, atol=1e-5)


def test_fused_row_regular_full_base():
    """Full base matrix (the bench code's shape class) + uneven grid tiles."""
    T = 5
    code, qc, dec = _setup(2, 6, 32, T, base_seed=1, density=1.0, kind="rcq",
                           bc=3, bv=8)
    llr = awgn_llr(jax.random.PRNGKey(3), jnp.zeros((96, code.n)), 3.0)
    ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T,
                          dtype=jnp.float32)
    out = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, dtype=jnp.float32,
                                batch_tile=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_allclose(np.asarray(out.posterior),
                               np.asarray(ref.posterior),
                               rtol=1e-6, atol=1e-5)


def test_fused_pads_bad_tile_and_rejects_vmem():
    """Any tile works: a tile that does not divide the batch leaves the
    last program part-full (its spare frames are skipped, not decoded);
    a tile below one frame is refused; the auto tile gives a small batch
    one frame per program."""
    T = 4
    code, qc, dec = _setup(2, 4, 16, T, base_seed=2, kind="ms")
    llr = awgn_llr(jax.random.PRNGKey(1), jnp.zeros((64, code.n)), 2.0)
    out = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, batch_tile=48,
                                dtype=jnp.float32, interpret=True)
    assert out.bits.shape == (64, code.n)
    ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    with pytest.raises(ValueError, match="batch_tile"):
        qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                              max_iterations=T, batch_tile=0,
                              interpret=True)
    assert auto_batch_tile(8) == 1
    small = qc_fused_decode_batch(llr[:8], dec.weights, qc=qc,
                                  spec=dec.spec, max_iterations=T,
                                  batch_tile=None, interpret=True)
    assert small.bits.shape == (8, code.n)


def test_decoder_fused_option_interpret():
    """qc_options={'fused': True} routes through the whole-decode kernel
    (interpret mode on CPU) and matches the XLA engine's check-at-T
    contract; training calls fall back to the differentiable engine."""
    T = 5
    code, qc, dec = _setup(2, 5, 16, T, base_seed=3, kind="rcq", bc=3, bv=8)
    fusedec = ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, bv=8, max_iterations=T, qc=qc,
        qc_options={"fused": True, "batch_tile": 16, "interpret": True,
                    "dtype": jnp.float32})
    llr = awgn_llr(jax.random.PRNGKey(5), jnp.zeros((32, code.n)), 2.5)
    ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T)
    out = fusedec(llr)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(np.asarray(out.success),
                                  np.asarray(ref.success))
    # training path silently uses the XLA engine (trajectory works)
    wdec = ldpc_tpu.make_decoder(
        code, kind="wrcq", bc=3, sharing_type=2, max_iterations=T, qc=qc,
        qc_options={"fused": True, "batch_tile": 16, "interpret": True})
    tr = wdec(llr, ste=True, return_trajectory=True)
    assert tr.posteriors_all is not None
    # truncating a fused decoder breaks its check schedule -> refuse
    with pytest.raises(ValueError):
        fusedec.truncated(2)
    # incompatible explicit check_every -> refuse
    bad = ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, max_iterations=T, qc=qc,
        qc_options={"fused": True, "check_every": 1, "interpret": True,
                    "batch_tile": 16})
    with pytest.raises(ValueError):
        bad(llr)


def test_fused_layered_matches_engine_trajectory():
    """The layered fused kernel's posterior equals the XLA layered
    engine's iteration-T (unfrozen) posterior — the check-at-the-end
    contract — across variant kinds."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered
    from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered

    T = 5
    # wrcq/nms cover the VN-side alpha scaling (alpha_in_cn=False) the
    # round-4 wrcq-dud investigation found untested in the LAYERED
    # fused kernel (orcq covers the CN-side alpha). NOTE the parity
    # contract is per-iteration to float tolerance: the two paths
    # accumulate colsum in different op orders, so chaotically fragile
    # weight configs can diverge macroscopically over many iterations
    # (RESULTS §33b item 4) — that is a property of the weights, not
    # an engine bug.
    for kw in (dict(kind="ms", factor=0.7),
               dict(kind="rcq", bc=3, bv=8,
                    quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))),
               dict(kind="orcq", bc=3, sharing_type=2, seed=3),
               dict(kind="wrcq", bc=3, sharing_type=2, seed=6,
                    quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))),
               dict(kind="nms", sharing_type=2, seed=1, init="nms")):
        code, qc, dec = _setup(3, 7, 16, T, base_seed=4, density=0.85, **kw)
        llr = awgn_llr(jax.random.PRNGKey(6), jnp.zeros((32, code.n)), 2.5)
        ref = qc_decode_batch_layered(llr, dec.weights, qc=qc, spec=dec.spec,
                                      max_iterations=T,
                                      return_trajectory=True)
        out = qc_fused_decode_batch_layered(
            llr, dec.weights, qc=qc, spec=dec.spec, max_iterations=T,
            dtype=jnp.float32, batch_tile=16, interpret=True)
        last = np.asarray(ref.posteriors_all[-1])
        np.testing.assert_allclose(np.asarray(out.posterior), last,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(out.bits),
                                      (last < 0).astype(np.int32))


def test_decoder_layered_fused_option():
    """layered + qc_options fused routes to the layered whole-decode
    kernel (check-at-the-end contract: bits == XLA layered trajectory's
    last iteration)."""
    from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered

    T = 4
    code, qc, dec = _setup(2, 5, 16, T, base_seed=6, kind="rcq", bc=3,
                           layered=True)
    fdec = ldpc_tpu.make_decoder(
        code, kind="rcq", bc=3, max_iterations=T, qc=qc, layered=True,
        qc_options={"fused": True, "batch_tile": 16, "interpret": True,
                    "dtype": jnp.float32})
    llr = awgn_llr(jax.random.PRNGKey(8), jnp.zeros((32, code.n)), 2.5)
    ref = qc_decode_batch_layered(llr, dec.weights, qc=qc, spec=dec.spec,
                                  max_iterations=T, return_trajectory=True)
    out = fdec(llr)
    last_bits = (np.asarray(ref.posteriors_all[-1]) < 0).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(out.bits), last_bits)


def test_max_batch_tile_accounting():
    """The auto tile gives a large batch 8 frames per program (the bench's
    32768 frames run on 4096 programs), keeps at least 4096 programs where
    the batch allows, and gives a small batch (a 128-frame survivor
    stage) one frame per program; every frame lands in one program."""
    from ldpc_tpu.decode.pallas_fused import (_FRAMES_PER_PROGRAM,
                                              _MIN_PROGRAMS)

    assert auto_batch_tile(32768) == 8
    assert auto_batch_tile(65536) == 8
    assert auto_batch_tile(16384) == 4
    assert auto_batch_tile(4095) == 1
    assert auto_batch_tile(128) == 1
    for B in (1, 37, 4096, 20000, 32768, 100000):
        bt = auto_batch_tile(B)
        programs = -(-B // bt)
        assert 1 <= bt <= _FRAMES_PER_PROGRAM
        assert programs * bt >= B > (programs - 1) * bt
        assert programs >= min(B, _MIN_PROGRAMS)


@pytest.mark.parametrize("frames,tile,fits", [
    (45_343, 1, True),     # 45,343 programs x 47,360 state words < 2**31
    (45_344, 1, False),    # one program more wraps the scratch offsets
    (226_719, 8, True),    # 226,719 frames x 9,472 bits < 2**31
    (226_720, 8, False),   # one frame more wraps the LLR offsets
])
def test_size_check_refuses_int32_overflow(frames, tile, fits):
    """The kernels index flat buffers with int32: on the bench code
    (5x37 base, lift 256) a shape whose LLR or scratch offsets would wrap
    is refused while tracing, before anything is allocated."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, size=(5, 37))
    code = ldpc_tpu.create_qc_code(base, lift=256, max_iterations=2)
    qc = build_qc_graph(base, 256)
    dec = ldpc_tpu.make_decoder(code, kind="ms", max_iterations=2, qc=qc)

    def run(llr):
        return qc_fused_decode_batch_layered(
            llr, dec.weights, qc=qc, spec=dec.spec, max_iterations=2,
            batch_tile=tile, interpret=True, lean=True).success

    shape = jax.ShapeDtypeStruct((frames, code.n), jnp.float32)
    if fits:
        assert jax.eval_shape(run, shape).shape == (frames,)
    else:
        with pytest.raises(ValueError, match="int32"):
            jax.eval_shape(run, shape)


def test_fused_auto_batch_tile_interpret():
    """batch_tile=None auto-picks a valid tile and decodes correctly."""
    T = 3
    code, qc, dec = _setup(2, 4, 16, T, base_seed=5, kind="ms")
    llr = awgn_llr(jax.random.PRNGKey(1), jnp.zeros((32, code.n)), 2.0)
    out = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, batch_tile=None,
                                dtype=jnp.float32, interpret=True)
    ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T)
    np.testing.assert_array_equal(np.asarray(out.bits),
                                  np.asarray(ref.bits))


def test_lean_epilogue_matches_full():
    """lean=True returns the same hard outputs as the full epilogue —
    bits as int8, posterior skipped — on both fused kernels."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered

    T = 4
    code, qc, dec = _setup(3, 8, 16, T, base_seed=2, density=0.8,
                           kind="rcq", bc=3, bv=8)
    llr = awgn_llr(jax.random.PRNGKey(9), jnp.zeros((32, code.n)), 2.0)
    for fn in (qc_fused_decode_batch, qc_fused_decode_batch_layered):
        full = fn(llr, dec.weights, qc=qc, spec=dec.spec, max_iterations=T,
                  dtype=jnp.float32, batch_tile=16, interpret=True)
        lean = fn(llr, dec.weights, qc=qc, spec=dec.spec, max_iterations=T,
                  dtype=jnp.float32, batch_tile=16, interpret=True,
                  lean=True)
        assert lean.posterior is None
        assert lean.bits.dtype == jnp.int8
        np.testing.assert_array_equal(np.asarray(lean.bits),
                                      np.asarray(full.bits))
        np.testing.assert_array_equal(np.asarray(lean.success),
                                      np.asarray(full.success))
        np.testing.assert_array_equal(np.asarray(lean.iterations),
                                      np.asarray(full.iterations))


def test_lean_via_decoder_options():
    """qc_options={'fused': True, 'lean': True} flows through Decoder and
    is dropped on the training fallback (which keeps the full contract)."""
    T = 3
    code, qc, dec = _setup(2, 5, 16, T, base_seed=3, kind="rcq", bc=3,
                           qc_options={"fused": True, "batch_tile": 16,
                                       "interpret": True,
                                       "dtype": jnp.float32, "lean": True})
    llr = awgn_llr(jax.random.PRNGKey(4), jnp.zeros((16, code.n)), 2.0)
    out = dec(llr)
    assert out.posterior is None and out.bits.dtype == jnp.int8
    ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    # trajectory request falls back to the XLA engine with full outputs
    traj = dec(llr, return_trajectory=True)
    assert traj.posteriors_all is not None and traj.posterior is not None


def test_natural_layout_matches_block_layout():
    """The kernels read the LLRs and write the posterior (or lean int8
    bits) in their natural [B, n] layout at any lift — a column is a plain
    offset — and agree with the XLA engine at a lift-128 and at a lift
    that is not a power of two, lean and full."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered
    from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered

    T = 4
    for lift in (128, 24):
        code, qc, dec = _setup(2, 5, lift, T, base_seed=6, density=0.9,
                               kind="rcq", bc=3, bv=8)
        llr = awgn_llr(jax.random.PRNGKey(11), jnp.zeros((6, code.n)), 2.0)
        flood = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, check_every=T)
        lay = qc_decode_batch_layered(llr, dec.weights, qc=qc,
                                      spec=dec.spec, max_iterations=T,
                                      return_trajectory=True)
        lay_last = np.asarray(lay.posteriors_all[-1])
        for fn, ref_post in ((qc_fused_decode_batch,
                              np.asarray(flood.posterior)),
                             (qc_fused_decode_batch_layered, lay_last)):
            full = fn(llr, dec.weights, qc=qc, spec=dec.spec,
                      max_iterations=T, dtype=jnp.float32, batch_tile=4,
                      interpret=True)
            assert full.posterior.shape == (6, code.n)
            np.testing.assert_allclose(np.asarray(full.posterior), ref_post,
                                       rtol=1e-6, atol=1e-5)
            lean = fn(llr, dec.weights, qc=qc, spec=dec.spec,
                      max_iterations=T, dtype=jnp.float32, batch_tile=4,
                      interpret=True, lean=True)
            assert lean.posterior is None
            np.testing.assert_array_equal(np.asarray(lean.bits),
                                          (ref_post < 0).astype(np.int8))


def test_arbitrary_batch_sizes_are_padded():
    """Any batch size works: non-multiples of the tile are zero-padded
    internally and sliced back out."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered

    T = 3
    code, qc, dec = _setup(2, 5, 16, T, base_seed=8, kind="rcq", bc=3)
    llr = awgn_llr(jax.random.PRNGKey(2), jnp.zeros((37, code.n)), 2.0)
    for fn in (qc_fused_decode_batch, qc_fused_decode_batch_layered):
        out = fn(llr, dec.weights, qc=qc, spec=dec.spec, max_iterations=T,
                 dtype=jnp.float32, batch_tile=16, interpret=True)
        assert out.bits.shape == (37, code.n)
        assert out.success.shape == (37,) and out.iterations.shape == (37,)
        # the padded run must agree with a tile-aligned run on the same
        # frames
        llr48 = jnp.concatenate([llr, llr[:11]], axis=0)
        ref = fn(llr48, dec.weights, qc=qc, spec=dec.spec,
                 max_iterations=T, dtype=jnp.float32, batch_tile=16,
                 interpret=True)
        np.testing.assert_array_equal(np.asarray(out.bits),
                                      np.asarray(ref.bits)[:37])
        np.testing.assert_array_equal(np.asarray(out.success),
                                      np.asarray(ref.success)[:37])


@pytest.mark.parametrize("kw", [
    # bc=5 (16 levels): the case closed_qdq exists for — the unrolled
    # staircase is 15 compare+add pairs per qdq call, the closed form
    # O(1) ops.
    dict(kind="rcq", bc=5,
         quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))),
    dict(kind="rcq", bc=5, bv=8,
         quantizer_params=((3.0, 1.3), (5.0, 1.3), (7.0, 1.3))),
    dict(kind="orcq", bc=4, sharing_type=2, seed=11,
         quantizer_params=((2.0, 1.0), (4.0, 1.0), (6.0, 1.0))),  # uniform
])
def test_fused_closed_qdq_matches_staircase(kw):
    """closed_qdq=True must pick the same quantizer index as the exact
    LUT staircase for every message (power_qdq's boundary-correction
    selects), so hard outputs agree exactly; reconstructed values may
    round <=1 ulp differently (f32 pow vs float64-derived LUT entry)."""
    T = 5
    code, qc, dec = _setup(3, 8, 16, T, base_seed=2, density=0.8, **kw)
    llr = awgn_llr(jax.random.PRNGKey(9), jnp.zeros((64, code.n)), 2.0)
    ref = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, dtype=jnp.float32,
                                batch_tile=32, interpret=True)
    out = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, dtype=jnp.float32,
                                batch_tile=32, interpret=True,
                                closed_qdq=True)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(np.asarray(out.success),
                                  np.asarray(ref.success))
    np.testing.assert_allclose(np.asarray(out.posterior),
                               np.asarray(ref.posterior),
                               rtol=1e-5, atol=1e-4)


def test_closed_qdq_via_decoder_options_layered():
    """qc_options plumbing: closed_qdq reaches the layered fused kernel
    and the training fallback silently drops it."""
    T = 4
    code, qc, dec = _setup(3, 8, 16, T, base_seed=3, density=0.8,
                           kind="rcq", bc=5, bv=8)
    import dataclasses as _dc
    base = dec
    dec_ref = _dc.replace(base, layered=True, qc_options=dict(
        fused=True, interpret=True, batch_tile=32, dtype=jnp.float32))
    dec_closed = _dc.replace(base, layered=True, qc_options=dict(
        fused=True, interpret=True, batch_tile=32, dtype=jnp.float32,
        closed_qdq=True))
    llr = awgn_llr(jax.random.PRNGKey(4), jnp.zeros((32, code.n)), 2.5)
    a = dec_ref(llr)
    b = dec_closed(llr)
    np.testing.assert_array_equal(np.asarray(a.bits), np.asarray(b.bits))
    np.testing.assert_array_equal(np.asarray(a.success),
                                  np.asarray(b.success))
    # training path: must not crash on the fused-only option
    out = dec_closed(llr[:4], ste=True)
    assert out.posterior is not None


def test_closed_qdq_spec_three_way_parity():
    """make_decoder(closed_qdq=True) sets the flag on the SPEC, so the
    XLA engine and the fused kernel run the SAME closed-form quantizer —
    the three-implementation bit-exactness invariant holds for bc=5."""
    T = 5
    code, qc, dec = _setup(3, 8, 16, T, base_seed=4, density=0.8,
                           kind="rcq", bc=5, bv=8, closed_qdq=True)
    assert dec.spec.closed_qdq
    llr = awgn_llr(jax.random.PRNGKey(12), jnp.zeros((48, code.n)), 2.2)
    eng = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T,
                          dtype=jnp.float32)
    fus = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, dtype=jnp.float32,
                                batch_tile=16, interpret=True)
    np.testing.assert_array_equal(np.asarray(fus.bits), np.asarray(eng.bits))
    np.testing.assert_array_equal(np.asarray(fus.success),
                                  np.asarray(eng.success))
    np.testing.assert_allclose(np.asarray(fus.posterior),
                               np.asarray(eng.posterior),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("lift", [31, 43, 360])
def test_unpadded_lifts_match_engine(lift):
    """Lifts that are not powers of two are padded to the next one with
    masked lanes: both kernels still equal the XLA engines exactly."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered
    from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered

    T = 4
    code, qc, dec = _setup(2, 4, lift, T, base_seed=lift, density=0.9,
                           kind="orcq", bc=3, sharing_type=2, seed=2)
    llr = awgn_llr(jax.random.PRNGKey(lift), jnp.zeros((4, code.n)), 2.5)
    ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                          max_iterations=T, check_every=T)
    out = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, dtype=jnp.float32,
                                batch_tile=2, interpret=True)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(np.asarray(out.success),
                                  np.asarray(ref.success))
    np.testing.assert_allclose(np.asarray(out.posterior),
                               np.asarray(ref.posterior), rtol=1e-6,
                               atol=1e-5)
    lay = qc_decode_batch_layered(llr, dec.weights, qc=qc, spec=dec.spec,
                                  max_iterations=T, return_trajectory=True)
    outl = qc_fused_decode_batch_layered(
        llr, dec.weights, qc=qc, spec=dec.spec, max_iterations=T,
        dtype=jnp.float32, batch_tile=2, interpret=True)
    np.testing.assert_allclose(np.asarray(outl.posterior),
                               np.asarray(lay.posteriors_all[-1]),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("layered", [False, True])
def test_kernel_refuses_cpu_without_interpret(layered):
    """Without ``interpret=True`` the kernels compile for a GPU only; on a
    CPU backend they raise instead of running anything quietly."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered

    T = 2
    code, qc, dec = _setup(2, 4, 16, T, base_seed=1, kind="ms")
    fn = qc_fused_decode_batch_layered if layered else qc_fused_decode_batch
    with pytest.raises(RuntimeError, match="interpret=True"):
        fn(jnp.zeros((4, code.n)), dec.weights, qc=qc, spec=dec.spec,
           max_iterations=T)


@pytest.mark.gpu
@pytest.mark.parametrize("batch_tile", [None, 8, 24])
def test_compiled_kernels_match_engine_on_gpu(gpu_device, batch_tile):
    """The kernels as compiled for the card (no interpret mode) against
    the XLA engines: f32 hard outputs equal, posteriors to float
    tolerance (the two compilers contract mul+add differently). Tiles of
    one frame (auto, at 64 frames), of 8 frames and a tile that does not
    divide the batch: programs that decode several frames reuse their
    scratch, behind barriers that only compiled code has."""
    from ldpc_tpu.decode.pallas_fused import qc_fused_decode_batch_layered
    from ldpc_tpu.decode.qc_engine import qc_decode_batch_layered

    T = 5
    code, qc, dec = _setup(3, 8, 48, T, base_seed=3, density=0.85,
                           kind="rcq", bc=3, bv=8)
    llr = awgn_llr(jax.random.PRNGKey(5), jnp.zeros((64, code.n)), 2.5)
    with jax.default_matmul_precision("highest"):
        ref = qc_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                              max_iterations=T, check_every=T)
        lay = qc_decode_batch_layered(llr, dec.weights, qc=qc,
                                      spec=dec.spec, max_iterations=T,
                                      return_trajectory=True)
    out = qc_fused_decode_batch(llr, dec.weights, qc=qc, spec=dec.spec,
                                max_iterations=T, dtype=jnp.float32,
                                batch_tile=batch_tile)
    np.testing.assert_array_equal(np.asarray(out.bits), np.asarray(ref.bits))
    np.testing.assert_array_equal(np.asarray(out.success),
                                  np.asarray(ref.success))
    outl = qc_fused_decode_batch_layered(llr, dec.weights, qc=qc,
                                         spec=dec.spec, max_iterations=T,
                                         dtype=jnp.float32,
                                         batch_tile=batch_tile)
    last = np.asarray(lay.posteriors_all[-1])
    np.testing.assert_array_equal(np.asarray(outl.bits),
                                  (last < 0).astype(np.int32))
    ok = ~((code.H.astype(np.int64) @ (last < 0).T) % 2).any(axis=0)
    np.testing.assert_array_equal(np.asarray(outl.success), ok)
    np.testing.assert_allclose(np.asarray(outl.posterior), last,
                               rtol=1e-5, atol=1e-4)
