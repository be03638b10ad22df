"""The folded single-pass S matvec of ``SchurOps.s_matvec`` (one scan reads
each S block once and folds the forward and transposed segment sums into
its carry) against the stepwise two-stream path it replaces above the
scan-chunk budget (reference ops/schur.hpp:190-263, schur.hpp:307-393).

The fold engages when the S block count exceeds ``_smv_chunk_rows``;
monkeypatching that bound selects either path at toy scale.
"""

import jax.numpy as jnp
import numpy as np

import graphite_tpu as gt
import graphite_tpu.schur as schur_mod
from graphite_tpu.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from graphite_tpu.io import synthetic
from graphite_tpu.io.bal import build_graph
from graphite_tpu.linearize import linearize
from graphite_tpu.schur import SchurOps, build_schur_structure, schur_values

STEPWISE = 1 << 30  # no S group exceeds this: the stepwise path runs


def _setup(name="mini", precision=gt.FP32_FP32):
    ds = synthetic.make_bal(name, seed=0, noise=0.5)
    g, *_ = build_graph(ds, precision=precision)
    problem = g.freeze()
    lin = linearize(problem, problem.params0)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv0 = compute_hessian_values(problem, hs, lin)
    hv = apply_damping(problem, hs, hv0, lin.diag, 1e-2, False)
    sv = schur_values(problem, ss, hv)
    return problem, lin, hs, ss, hv, sv


def test_s_matvec_folded_matches_stepwise(monkeypatch):
    """The folded single-pass S matvec (one S read, fwd+transpose segment
    sums in the scan carry) ≡ the stepwise two-stream path."""
    problem, lin, hs, ss, hv, sv = _setup("ladybug")
    ops = SchurOps(problem, ss, hv, sv)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=ss.dim_p).astype(np.float32))

    monkeypatch.setattr(schur_mod, "_smv_chunk_rows", lambda rb: STEPWISE)
    y_step = np.asarray(ops.s_matvec(x))

    monkeypatch.setattr(schur_mod, "_smv_chunk_rows", lambda rb: 128)
    y_fold = np.asarray(ops.s_matvec(x))
    np.testing.assert_allclose(y_fold, y_step, rtol=2e-6, atol=1e-4)


def test_s_matvec_folded_bf16_storage(monkeypatch):
    """Fold path with bf16 block storage (FP32_BF16) ≡ stepwise path."""
    problem, lin, hs, ss, hv, sv = _setup("mini", precision=gt.FP32_BF16)
    ops = SchurOps(problem, ss, hv, sv)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=ss.dim_p).astype(np.float32))

    monkeypatch.setattr(schur_mod, "_smv_chunk_rows", lambda rb: STEPWISE)
    y_step = np.asarray(ops.s_matvec(x))
    monkeypatch.setattr(schur_mod, "_smv_chunk_rows", lambda rb: 16)
    y_fold = np.asarray(ops.s_matvec(x))
    np.testing.assert_allclose(y_fold, y_step, rtol=2e-2, atol=1e-2)
