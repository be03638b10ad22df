"""Nested-dissection multifrontal Cholesky vs scipy and dense oracles.

The level-batched ND factorization (ops/nd_multifrontal.py) is the
on-device sparse-direct path past the dense densify ceiling — the
analog of the reference's cuDSS sparse factorization at any size
(cudss.hpp:53-269). Oracles: scipy splu on the exported scalar CSC
(1e-10), and the full LM trajectory against the host-callback sparse
solver on a pose graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import graphite_tpu as gt
from graphite_tpu.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
    csc_values,
    ensure_csc_structure,
)
from graphite_tpu.io import bal as bal_io
from graphite_tpu.io import g2o, synthetic
from graphite_tpu.linearize import linearize
from graphite_tpu.ops.nd_multifrontal import (
    build_nd_plan,
    nd_factor,
    nd_solve,
)


def _solve_both(problem, damping=1e-3):
    hs = build_hessian_structure(problem)
    lin = linearize(problem, problem.params0)
    hv = apply_damping(
        problem, hs, compute_hessian_values(problem, hs, lin), lin.diag,
        damping, False)
    plan = build_nd_plan(problem, hs)
    factors = nd_factor(problem, plan, hv, dtype=jnp.float64)
    x = nd_solve(problem, plan, factors, lin.b[: problem.dim_h])
    ensure_csc_structure(problem, hs)
    vals = np.asarray(csc_values(problem, hs, hv), dtype=np.float64)
    A = sp.csc_matrix((vals, hs.csc_indices, hs.csc_indptr),
                      shape=(problem.dim_h, problem.dim_h))
    xr = spla.splu(A).solve(np.asarray(lin.b[: problem.dim_h],
                                       np.float64))
    return np.asarray(x), xr, plan


def test_nd_pose_graph_2d_matches_splu():
    ds = synthetic.make_pose_graph_2d(n_poses=300, seed=1)
    g, *_ = g2o.build_graph(ds, precision=gt.FP64_FP64)
    problem = g.freeze()
    x, xr, plan = _solve_both(problem)
    assert len(plan.levels) >= 3  # actually recursed
    np.testing.assert_allclose(x, xr, rtol=1e-10, atol=1e-12)


def test_nd_bal_mixed_dims_matches_splu():
    """Mixed 9/3 block dims (BAL, no elimination) through the same path."""
    ds = synthetic.make_bal("mini", seed=2)
    g, *_ = bal_io.build_graph(ds, precision=gt.FP64_FP64,
                               eliminate_points=False)
    problem = g.freeze()
    x, xr, _ = _solve_both(problem)
    np.testing.assert_allclose(x, xr, rtol=1e-10, atol=1e-12)


def test_nd_sphere_se3_matches_splu():
    """SE3 sphere (dim-6 blocks, loop closures) at a size with ~8 tree
    levels."""
    ds = synthetic.make_sphere_se3(n_poses=800, seed=0)
    g, *_ = g2o.build_graph(ds, precision=gt.FP64_FP64)
    problem = g.freeze()
    x, xr, plan = _solve_both(problem)
    assert len(plan.levels) >= 5
    np.testing.assert_allclose(x, xr, rtol=1e-9, atol=1e-11)


def test_nd_lm_trajectory_matches_host_sparse():
    """Full LM with the multifrontal path forced == host-callback sparse
    LU trajectory (levenberg_marquardt.hpp:166-238 semantics)."""
    from graphite_tpu.optimizers.lm import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )
    from graphite_tpu.solvers import SparseDirectSolver

    ds = synthetic.make_pose_graph_2d(n_poses=80, seed=3)

    def run(solver):
        g, *_ = g2o.build_graph(ds, precision=gt.FP64_FP64)
        problem = g.freeze()
        return levenberg_marquardt(
            problem, solver,
            options=LevenbergMarquardtOptions(iterations=8,
                                              initial_damping=1e-4))

    res_nd = run(SparseDirectSolver(multifrontal=True))
    res_host = run(SparseDirectSolver(on_device=False))
    np.testing.assert_allclose(
        float(res_nd.chi2), float(res_host.chi2), rtol=1e-8)
    np.testing.assert_allclose(
        [h["chi2"] for h in res_nd.history],
        [h["chi2"] for h in res_host.history], rtol=1e-7)
