"""The device Schur path (schur.py) against the host float64 block-sparse
reference (schur_reference.py), and that reference against the dense
oracle (tests/schur_cpu_ref.cpp:8-51).

Float32 cases are held to a cancellation-aware bound: the error over the
size of the terms the stage sums (|Hpp| + |Hpl||Hll^-1||Hpl|^T and its
analogs), since S = Hpp - Hpl Hll^-1 Hpl^T cancels and float32 rounding
scales with the terms, not with the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import graphite_tpu as gt
import graphite_tpu.schur as schur_mod
from graphite_tpu.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
    hessian_to_dense,
)
from graphite_tpu.io import synthetic
from graphite_tpu.io.bal import build_graph
from graphite_tpu.linearize import linearize
from graphite_tpu.schur import SchurOps, build_schur_structure, schur_values
from graphite_tpu.schur_reference import hessian_csr, s_bsr, schur_reference
from graphite_tpu.solvers.dense_cholesky_schur import schur_to_dense


def _bal(name, precision):
    ds = synthetic.make_bal(name, seed=0, noise=0.5)
    g, *_ = build_graph(ds, precision=precision)
    return g.freeze()


def _multitype(precision):
    from test_schur_multitype import _problem

    return _problem(seed=1, precision=precision)


def _setup(problem):
    lin = linearize(problem, problem.params0)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv = apply_damping(problem, hs, compute_hessian_values(problem, hs, lin),
                       lin.diag, 1e-2, False)
    sv = schur_values(problem, ss, hv)
    return lin, hs, ss, hv, sv


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_dense_oracle(seed):
    ds = synthetic.make_bal("toy", seed=seed, noise=0.5)
    g, *_ = build_graph(ds, precision=gt.FP64_FP64)
    problem = g.freeze()
    lin, hs, ss, hv, sv = _setup(problem)
    H = hessian_to_dense(problem, hs, hv)
    n = ss.dim_p
    Hpp, Hpl, Hll = H[:n, :n], H[:n, n:], H[n:, n:]
    b = np.asarray(lin.b)[:problem.dim_h]
    Hll_inv = np.linalg.inv(Hll)
    S = Hpp - Hpl @ Hll_inv @ Hpl.T
    b_s = b[:n] - Hpl @ Hll_inv @ b[n:]
    dx_p = np.linalg.solve(S, b_s)

    ref = schur_reference(problem, hs, hv, lin.b)
    np.testing.assert_allclose(hessian_csr(problem, hs, hv).toarray(), H,
                               rtol=0, atol=0)
    np.testing.assert_allclose(ref.s_matrix().toarray(), S, rtol=1e-12,
                               atol=1e-12 * np.abs(S).max())
    np.testing.assert_allclose(ref.b_schur(), b_s, rtol=1e-12,
                               atol=1e-12 * np.abs(b_s).max())
    dx_l = Hll_inv @ (b[n:] - Hpl.T @ dx_p)
    np.testing.assert_allclose(ref.landmark_update(dx_p), dx_l, rtol=1e-12,
                               atol=1e-12 * np.abs(dx_l).max())
    off = ss.pose_offsets
    blk = ref.s_block(int(off[1]), 9, int(off[0]), 9)
    np.testing.assert_allclose(blk, S[off[1]:off[1] + 9, off[0]:off[0] + 9],
                               rtol=1e-12, atol=1e-12 * np.abs(S).max())


CASES = {
    "mini_fp32": lambda: _bal("mini", gt.FP32_FP32),
    "mini_fp32_bf16": lambda: _bal("mini", gt.FP32_BF16),
    "ladybug_chunked": lambda: _bal("ladybug", gt.FP32_FP32),
    "multitype_fp32": lambda: _multitype(gt.FP32_FP32),
}


def _terms_error(got, want, terms):
    got = np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / np.asarray(terms).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("stage", ["schur_values", "b_schur", "s_matvec",
                                   "landmark_update"])
def test_schur_ops_match_reference(case, stage, monkeypatch):
    if case == "ladybug_chunked":
        # every chunked path: scan-folded triple products, folded matvec
        monkeypatch.setattr(schur_mod, "CHUNK_THRESHOLD", 4096)
        monkeypatch.setattr(schur_mod, "CHUNK", 4096)
        monkeypatch.setattr(schur_mod, "_smv_chunk_rows", lambda rb: 256)
    problem = CASES[case]()
    lin, hs, ss, hv, sv = _setup(problem)
    ref = schur_reference(problem, hs, hv, lin.b)
    ops = SchurOps(problem, ss, hv, sv)
    rng = np.random.default_rng(2)
    x = rng.normal(size=ss.dim_p)
    xj = jnp.asarray(x, jnp.float32)
    if stage == "schur_values":
        err = _terms_error(schur_to_dense(problem, ss, sv),
                           ref.s_matrix().toarray(), ref.s_terms().toarray())
    elif stage == "b_schur":
        err = _terms_error(ops.b_schur(lin.b), ref.b_schur(),
                           ref.b_schur_terms())
    elif stage == "s_matvec":
        # against the product with the stored S itself (the stage under
        # test reads S; its accuracy is the schur_values case)
        S = schur_to_dense(problem, ss, sv)
        S = np.asarray(S, np.float64)
        err = _terms_error(ops.s_matvec(xj), S @ x, np.abs(S) @ np.abs(x))
    else:
        dx = ops.compose_delta(xj, ops.landmark_update(lin.b, xj))
        err = _terms_error(np.asarray(dx)[ss.dim_p:problem.dim_h],
                           ref.landmark_update(x),
                           ref.landmark_update_terms(x))
    assert err <= 1e-6, err


def test_s_bsr_matches_reference():
    """The BSR view of the stored upper S blocks is the full symmetric S."""
    problem = _bal("mini", gt.FP64_FP64)
    lin, hs, ss, hv, sv = _setup(problem)
    ref_S = schur_reference(problem, hs, hv, lin.b).s_matrix().toarray()
    S = s_bsr(ss, sv.s_vals).toarray()
    np.testing.assert_allclose(S, ref_S, rtol=1e-10,
                               atol=1e-12 * np.abs(ref_S).max())


@pytest.mark.parametrize("dims,k,ns", [
    ((9, 3, 9), 5_000, 500),   # BAL camera-landmark Schur products
    ((3, 3, 3), 1_200, 80),    # small blocks
    ((6, 3, 2), 900, 64),      # rectangular
])
@pytest.mark.parametrize("chunked", [False, True])
def test_product_sum_matches_numpy(dims, k, ns, chunked, monkeypatch):
    """sum_pairs W[left] R[right]^T into sorted destinations, one-shot and
    scan-chunked (padding rows land in the trash row)."""
    if chunked:
        monkeypatch.setattr(schur_mod, "CHUNK_THRESHOLD", 16)
        monkeypatch.setattr(schur_mod, "CHUNK", 256)
    dpa, dl, dpb = dims
    rng = np.random.default_rng(k)
    W = rng.normal(size=(300, dpa * dl)).astype(np.float32)
    R = rng.normal(size=(200, dpb * dl)).astype(np.float32)
    left = rng.integers(0, 300, size=k).astype(np.int32)
    right = rng.integers(0, 200, size=k).astype(np.int32)
    dst = np.sort(rng.integers(0, ns, size=k)).astype(np.int32)
    out = np.asarray(schur_mod._product_sum(
        jnp.asarray(W), jnp.asarray(R), jnp.asarray(left),
        jnp.asarray(right), jnp.asarray(dst), dims, k, ns, jnp.float32))
    Wb = W.astype(np.float64).reshape(-1, dpa, dl)[left]
    Rb = R.astype(np.float64).reshape(-1, dpb, dl)[right]
    ref = np.zeros((ns, dpa * dpb))
    np.add.at(ref, dst, np.einsum("kad,kbd->kab", Wb, Rb).reshape(k, -1))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
