"""Chunked (scan) execution paths must match the fused paths exactly.

The chunked paths normally trigger only at multi-million-row scale; here
the thresholds are monkeypatched down so CI exercises them on tiny
problems.
"""

import importlib

import numpy as np
import pytest

import graphite_tpu as gt
from graphite_tpu.io import bal as bal_io
from graphite_tpu.io import synthetic

L = importlib.import_module("graphite_tpu.linearize")
S = importlib.import_module("graphite_tpu.schur")
H = importlib.import_module("graphite_tpu.hessian")


def _problem():
    ds = synthetic.make_bal("mini", seed=0, noise=0.5)
    g, *_ = bal_io.build_graph(ds, precision=gt.FP64_FP64)
    return g.freeze()


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(L, "LINEARIZE_CHUNK_LIMIT", 64)
    monkeypatch.setattr(S, "CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(S, "CHUNK", 16)
    yield


def _reference_outputs():
    problem = _problem()
    lin = L.linearize(problem, problem.params0)
    hs = H.build_hessian_structure(problem)
    ss = S.build_schur_structure(problem)
    hv = H.compute_hessian_values(problem, hs, lin)
    sv = S.schur_values(problem, ss, hv)
    ops = S.SchurOps(problem, ss, hv, sv)
    b_s = ops.b_schur(lin.b)
    import jax.numpy as jnp

    x = jnp.asarray(np.random.default_rng(0).normal(size=ss.dim_p))
    y = ops.s_matvec(x)
    dx_l = ops.compose_delta(x, ops.landmark_update(lin.b, x))
    return lin, hv, sv, b_s, y, dx_l


REF = None


def _get_ref():
    global REF
    if REF is None:
        REF = _reference_outputs()
    return REF


def test_chunked_matches_fused(small_chunks):
    lin_r, hv_r, sv_r, b_s_r, y_r, dx_r = _get_ref()
    problem = _problem()
    lin = L.linearize(problem, problem.params0)
    np.testing.assert_allclose(np.asarray(lin.b), np.asarray(lin_r.b),
                               rtol=1e-12, atol=1e-14)
    hs = H.build_hessian_structure(problem)
    ss = S.build_schur_structure(problem)
    hv = H.compute_hessian_values(problem, hs, lin)
    for k in hv_r:
        np.testing.assert_allclose(np.asarray(hv[k]), np.asarray(hv_r[k]),
                                   rtol=1e-11, atol=1e-13)
    sv = S.schur_values(problem, ss, hv)
    for k in sv_r.s_vals:
        np.testing.assert_allclose(
            np.asarray(sv.s_vals[k]), np.asarray(sv_r.s_vals[k]),
            rtol=1e-10, atol=1e-12,
        )
    ops = S.SchurOps(problem, ss, hv, sv)
    np.testing.assert_allclose(np.asarray(ops.b_schur(lin.b)),
                               np.asarray(b_s_r), rtol=1e-10, atol=1e-12)
    import jax.numpy as jnp

    x = jnp.asarray(np.random.default_rng(0).normal(size=ss.dim_p))
    np.testing.assert_allclose(np.asarray(ops.s_matvec(x)), np.asarray(y_r),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(ops.compose_delta(x, ops.landmark_update(lin.b, x))),
        np.asarray(dx_r), rtol=1e-10, atol=1e-12,
    )


def test_chunk_threshold_scales_with_problem_size(monkeypatch):
    """The one-shot product batch is bounded by device memory: rows x row
    bytes may take a quarter of the allocator's limit, so wider products
    and smaller devices chunk sooner. A backend that reports no limit
    (the CPU) keeps the fixed CHUNK_THRESHOLD row bound."""
    import graphite_tpu.schur as S

    monkeypatch.setattr(S, "device_bytes_limit", lambda: None)
    assert S._chunk_threshold(468) == S.CHUNK_THRESHOLD

    gb60 = 60 << 30
    monkeypatch.setattr(S, "device_bytes_limit", lambda: gb60)
    assert S._chunk_threshold(468) == gb60 // 4 // 468
    # Venice-1778's 17.1M 9x3x9 pair products run one-shot in 60 GB ...
    assert S._chunk_threshold((81 + 18 * 3) * 4) > 17_100_000
    # ... and twice-as-wide rows halve the bound
    assert S._chunk_threshold(2 * 468) == gb60 // 4 // (2 * 468)
    monkeypatch.setattr(S, "device_bytes_limit", lambda: 4 << 30)
    assert S._chunk_threshold(468) < 17_100_000
