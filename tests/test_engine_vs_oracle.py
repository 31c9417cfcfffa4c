"""Engine correctness: the batched engine must agree with an
independently-written dense-matrix numpy oracle on every variant."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ldpc_tpu
from ldpc_tpu.decode.oracle import oracle_decode
from ldpc_tpu.quantizer import phase_schedule, power_thresholds


def _random_llrs(code, batch, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, scale, size=(batch, code.n)).astype(np.float32)


def _check_against_oracle(decoder, code, llrs, *, beta_fn=None, alpha_fn=None,
                          transform="nms", alpha_in_cn=False, qdq=None,
                          quantize_v2c=None, atol=1e-4):
    out = decoder(jnp.asarray(llrs))
    for b in range(llrs.shape[0]):
        bits, post, iters, ok = oracle_decode(
            code.H, llrs[b], decoder.max_iterations,
            beta_fn=beta_fn, alpha_fn=alpha_fn, transform=transform,
            alpha_in_cn=alpha_in_cn, qdq=qdq, quantize_v2c=quantize_v2c)
        np.testing.assert_array_equal(
            np.asarray(out.bits[b]), bits,
            err_msg=f"bits mismatch frame {b}")
        np.testing.assert_allclose(
            np.asarray(out.posterior[b]), post, atol=atol,
            err_msg=f"posterior mismatch frame {b}")
        assert int(out.iterations[b]) == iters, f"iters mismatch frame {b}"
        assert bool(out.success[b]) == ok, f"success mismatch frame {b}"


def test_basic_min_sum_vs_oracle(test_code):
    dec = ldpc_tpu.basic_min_sum(test_code, factor=0.7)
    llrs = _random_llrs(test_code, 32, seed=1)
    _check_against_oracle(dec, test_code, llrs,
                          beta_fn=lambda t, i, j: 0.7)


def test_basic_min_sum_vs_oracle_midsize(mid_code):
    dec = ldpc_tpu.basic_min_sum(mid_code, factor=0.7)
    llrs = _random_llrs(mid_code, 4, seed=2)
    _check_against_oracle(dec, mid_code, llrs,
                          beta_fn=lambda t, i, j: 0.7)


def test_nms_per_edge_weights_vs_oracle(test_code, test_graph):
    dec = ldpc_tpu.neural_min_sum(test_code, seed=3)
    llrs = _random_llrs(test_code, 16, seed=3)
    beta = np.asarray(dec.weights["beta"])  # [T, E]
    g = test_graph
    edge_of = {(int(g.edge_check[e]), int(g.edge_var[e])): e
               for e in range(g.num_edges)}
    _check_against_oracle(
        dec, test_code, llrs,
        beta_fn=lambda t, i, j: float(beta[t, edge_of[(i, j)]]))


def test_oms_per_edge_vs_oracle(test_code, test_graph):
    dec = ldpc_tpu.neural_offset_min_sum(test_code, seed=4)
    llrs = _random_llrs(test_code, 16, seed=4)
    beta = np.asarray(dec.weights["beta"])
    g = test_graph
    edge_of = {(int(g.edge_check[e]), int(g.edge_var[e])): e
               for e in range(g.num_edges)}
    # N-OMS: unweighted VN, no alpha anywhere -> oracle in alpha_in_cn mode
    # with alpha == 0 (CN subtracts 0, VN is a plain sum)
    _check_against_oracle(
        dec, test_code, llrs, transform="oms", alpha_in_cn=True,
        beta_fn=lambda t, i, j: float(beta[t, edge_of[(i, j)]]),
        alpha_fn=lambda t, i, j: 0.0)


@pytest.mark.parametrize("sharing_type", [1, 2, 3, 4])
def test_2d_nms_vs_oracle(test_code, test_graph, sharing_type):
    dec = ldpc_tpu.neural_2d_min_sum(test_code, sharing_type, seed=5,
                                     init="nms")
    llrs = _random_llrs(test_code, 8, seed=5 + sharing_type)
    g = test_graph
    dcs, dvs = g.unique_dc, g.unique_dv
    beta = (np.asarray(dec.weights["beta"])
            if dec.weights["beta"] is not None else None)
    alpha = (np.asarray(dec.weights["alpha"])
             if dec.weights["alpha"] is not None else None)
    cdeg = g.check_degree
    vdeg = g.var_degree

    def beta_fn(t, i, j):
        if sharing_type == 4 or beta is None:
            return 0.7
        bi = dcs.index(int(cdeg[i]))
        if sharing_type == 1:
            bi = bi * len(dvs) + dvs.index(int(vdeg[j]))
        return float(beta[t, bi])

    def alpha_fn(t, i, j):
        if sharing_type in (1, 3) or alpha is None:
            return 1.0
        return float(alpha[t, dvs.index(int(vdeg[j]))])

    _check_against_oracle(dec, test_code, llrs,
                          beta_fn=beta_fn, alpha_fn=alpha_fn)


@pytest.mark.parametrize("sharing_type", [1, 2, 3, 4])
def test_2d_oms_vs_oracle(test_code, test_graph, sharing_type):
    dec = ldpc_tpu.neural_2d_offset_min_sum(test_code, sharing_type, seed=6)
    llrs = _random_llrs(test_code, 8, seed=6 + sharing_type)
    g = test_graph
    dcs, dvs = g.unique_dc, g.unique_dv
    beta = (np.asarray(dec.weights["beta"])
            if dec.weights["beta"] is not None else None)
    alpha = (np.asarray(dec.weights["alpha"])
             if dec.weights["alpha"] is not None else None)
    cdeg, vdeg = g.check_degree, g.var_degree

    def beta_fn(t, i, j):
        if sharing_type == 4 or beta is None:
            return 0.0
        bi = dcs.index(int(cdeg[i]))
        if sharing_type == 1:
            bi = bi * len(dvs) + dvs.index(int(vdeg[j]))
        return float(beta[t, bi])

    def alpha_fn(t, i, j):
        if sharing_type in (1, 3) or alpha is None:
            return 0.0
        return float(alpha[t, dvs.index(int(vdeg[j]))])

    _check_against_oracle(dec, test_code, llrs, transform="oms",
                          alpha_in_cn=True, beta_fn=beta_fn, alpha_fn=alpha_fn)


def _np_qdq(bc, quantizer_params, T):
    sched = phase_schedule(T, len(quantizer_params))
    luts = [power_thresholds(bc, C, g) for C, g in quantizer_params]

    def qdq(x, t):
        thr = luts[sched[t]]
        mag = np.abs(x)
        idx = np.maximum((mag[..., None] >= thr).sum(-1) - 1, 0)
        # sign-preserving dead-zone floor (quantizer.QDQ_SIGN_TINY):
        # the sign bit survives magnitude-0 quantization, as in
        # sign-magnitude hardware
        from ldpc_tpu.quantizer import QDQ_SIGN_TINY
        return (np.where(x < 0, -1.0, 1.0)
                * np.maximum(thr[idx], QDQ_SIGN_TINY))

    return qdq


def test_rcq_vs_oracle(test_code):
    qp = [(3.0, 1.3), (5.0, 1.3), (7.0, 1.3)]
    dec = ldpc_tpu.rcq_min_sum(test_code, bc=3, quantizer_params=qp)
    llrs = _random_llrs(test_code, 16, seed=7)
    _check_against_oracle(dec, test_code, llrs, transform="rcq",
                          qdq=_np_qdq(3, qp, dec.max_iterations))


def test_wrcq_vs_oracle(test_code, test_graph):
    qp = [(3.0, 1.3), (5.0, 1.3), (7.0, 1.3)]
    dec = ldpc_tpu.weighted_rcq(test_code, bc=3, quantizer_params=qp,
                                weight_sharing_type=2, seed=8, init="nms")
    llrs = _random_llrs(test_code, 8, seed=8)
    g = test_graph
    dcs, dvs = g.unique_dc, g.unique_dv
    beta = np.asarray(dec.weights["beta"])
    alpha = np.asarray(dec.weights["alpha"])
    cdeg, vdeg = g.check_degree, g.var_degree
    _check_against_oracle(
        dec, test_code, llrs, transform="wrcq",
        beta_fn=lambda t, i, j: float(beta[t, dcs.index(int(cdeg[i]))]),
        alpha_fn=lambda t, i, j: float(alpha[t, dvs.index(int(vdeg[j]))]),
        qdq=_np_qdq(3, qp, dec.max_iterations))


def test_noiseless_decode_identity(test_code, mid_code):
    """With clean channel LLRs (high magnitude, correct signs), decoding is
    the identity and converges in one iteration."""
    for code in (test_code, mid_code):
        dec = ldpc_tpu.basic_min_sum(code)
        llr = jnp.full((3, code.n), 10.0)  # all-zero codeword, no noise
        out = dec(llr)
        assert bool(out.success.all())
        np.testing.assert_array_equal(np.asarray(out.bits), 0)
        np.testing.assert_array_equal(np.asarray(out.iterations), 1)


def test_single_vector_call(test_code):
    dec = ldpc_tpu.basic_min_sum(test_code)
    out = dec(jnp.full((7,), 5.0))
    assert out.bits.shape == (7,)
    assert bool(out.success)
    bits, success, iters = dec.decode(jnp.full((7,), 5.0))
    assert bits.shape == (7,) and bool(success) and int(iters) == 1


def test_oms_rcq_vs_oracle(test_code, test_graph):
    """W-OMS-RCQ: qdq(sign * (relu(mag - beta) - alpha)) — the paper's
    FPGA headline decoder (§VII-B), absent from the reference."""
    qp = [(3.0, 1.3), (5.0, 1.3), (7.0, 1.3)]
    dec = ldpc_tpu.weighted_oms_rcq(test_code, bc=3, quantizer_params=qp,
                                    weight_sharing_type=2, seed=9)
    llrs = _random_llrs(test_code, 8, seed=9)
    g = test_graph
    dcs, dvs = g.unique_dc, g.unique_dv
    beta = np.asarray(dec.weights["beta"])
    alpha = np.asarray(dec.weights["alpha"])
    cdeg, vdeg = g.check_degree, g.var_degree
    _check_against_oracle(
        dec, test_code, llrs, transform="orcq", alpha_in_cn=True,
        beta_fn=lambda t, i, j: float(beta[t, dcs.index(int(cdeg[i]))]),
        alpha_fn=lambda t, i, j: float(alpha[t, dvs.index(int(vdeg[j]))]),
        qdq=_np_qdq(3, qp, dec.max_iterations))


def test_oms_rcq_bv_vs_oracle(test_code, test_graph):
    """W-OMS-RCQ with bv-bit V2C/posterior quantization active."""
    qp = [(5.0, 1.3)]
    dec = ldpc_tpu.weighted_oms_rcq(test_code, bc=4, bv=6,
                                    quantizer_params=qp,
                                    weight_sharing_type=3, seed=10)
    llrs = _random_llrs(test_code, 8, seed=10)
    g = test_graph
    dcs = g.unique_dc
    beta = np.asarray(dec.weights["beta"])
    cdeg = g.check_degree
    vq = _np_qdq(6, [(C * 2.0, gm) for C, gm in qp], dec.max_iterations)
    _check_against_oracle(
        dec, test_code, llrs, transform="orcq", alpha_in_cn=True,
        beta_fn=lambda t, i, j: float(beta[t, dcs.index(int(cdeg[i]))]),
        alpha_fn=lambda t, i, j: 0.0,
        qdq=_np_qdq(4, qp, dec.max_iterations), quantize_v2c=vq)
