"""``run_pcg`` (ops/pcg_loop.py) against a plain NumPy PCG with the
reference's semantics (solver/pcg.hpp:61-232): the residual is normalized
before each preconditioner application, a step whose |rz| grows past
rejection_ratio times the running minimum (or is NaN) is rejected and
restores the previous x, and the loop stops at rz == 0, |rz| < tol or
max_iter. Sizes are the dense-Schur and pose-graph systems the solvers
hand it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import graphite_tpu as gt
from graphite_tpu.ops.pcg_loop import run_pcg


def numpy_pcg(A, b, M, max_iter, tol, rejection_ratio):
    def precond(r):
        n = np.linalg.norm(r)
        return M @ (r / (n if n != 0 else 1.0))

    x = np.zeros_like(b)
    r = b.copy()
    z = precond(r)
    p = z.copy()
    rz = r @ z
    rz_min = np.inf
    for _ in range(max_iter):
        if rz == 0:
            break
        v = A @ p
        alpha = rz / (p @ v)
        x_new, r_new = x + alpha * p, r - alpha * v
        z_new = precond(r_new)
        rz_new = r_new @ z_new
        if abs(rz_new) > rejection_ratio * rz_min or np.isnan(rz_new):
            break  # rejected: keep the previous x
        rz_min = min(rz_min, abs(rz_new))
        p = z_new + (rz_new / rz) * p
        x, r, z, rz = x_new, r_new, z_new, rz_new
        if abs(rz) < tol:
            break
    return x


def _random_spd(rng, n, d):
    """SPD S and its exact block-Jacobi inverse M (block size d)."""
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    M = np.zeros_like(S)
    for i in range(0, n, d):
        M[i:i + d, i:i + d] = np.linalg.inv(S[i:i + d, i:i + d])
    return S, M


@pytest.mark.parametrize("n,d,max_iter,tol", [
    (90, 9, 10, 1.0),     # BAL-like: converges in a few iterations
    (126, 9, 50, 1e-12),  # runs to max_iter / tiny tol
    (64, 4, 10, 1e30),    # converges on the first check
])
def test_run_pcg_matches_numpy(n, d, max_iter, tol):
    rng = np.random.default_rng(n)
    S, M = _random_spd(rng, n, d)
    b = rng.standard_normal(n)
    out = run_pcg(jnp.asarray(b), lambda p: jnp.asarray(S) @ p,
                  lambda y: jnp.asarray(M) @ y, max_iter, tol, 5.0)
    ref = numpy_pcg(S, b, M, max_iter, tol, 5.0)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-10,
                               atol=1e-12)


def test_run_pcg_rejection_path():
    """An indefinite system triggers the divergence rejection; both loops
    must restore the same x."""
    rng = np.random.default_rng(7)
    n = 64
    A = rng.standard_normal((n, n))
    S = (A + A.T) / 2 - 1.5 * np.eye(n)  # indefinite
    M = np.eye(n)
    b = rng.standard_normal(n)
    out = run_pcg(jnp.asarray(b), lambda p: jnp.asarray(S) @ p,
                  lambda y: y, 25, 1e-12, 5.0)
    ref = numpy_pcg(S, b, M, 25, 1e-12, 5.0)
    assert np.any(ref != 0)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("precond", ["block_jacobi", "identity"])
def test_pcg_solver_pose_graph_matches_numpy(precond):
    """PCGSolver on a small SE3 pose graph: the matrix-free H x and the
    block-Jacobi preconditioner against the dense damped system."""
    from graphite_tpu.hessian import (
        build_hessian_structure,
        compute_hessian_values,
        hessian_to_dense,
    )
    from graphite_tpu.io import g2o, synthetic
    from graphite_tpu.linearize import DIAG_MAX, DIAG_MIN, linearize
    from graphite_tpu.preconditioners import BlockJacobiPreconditioner
    from graphite_tpu.solvers import PCGSolver

    ds = synthetic.make_sphere_se3(60, seed=3)
    g, *_ = g2o.build_graph(ds, precision=gt.FP64_FP64)
    problem = g.freeze()
    lin = linearize(problem, problem.params0)
    kw = ({"preconditioner": BlockJacobiPreconditioner()}
          if precond == "block_jacobi" else {})
    solver = PCGSolver(max_iter=8, tol=1e-12, rejection_ratio=1e8, **kw)
    mu = 1e-3
    dx, ok = solver.solve(problem, lin, solver.prepare(problem, lin), mu,
                          False)
    assert bool(ok)

    n = problem.dim_h
    hs = build_hessian_structure(problem)
    H = hessian_to_dense(problem, hs, compute_hessian_values(problem, hs,
                                                               lin))
    diag = np.clip(np.asarray(lin.diag)[:n], DIAG_MIN, DIAG_MAX)
    A = H + np.diag(mu * diag)
    if precond == "block_jacobi":
        d = 6
        M = np.zeros_like(A)
        for i in range(0, n, d):
            M[i:i + d, i:i + d] = np.linalg.inv(A[i:i + d, i:i + d])
    else:
        M = np.eye(n)
    ref = numpy_pcg(A, np.asarray(lin.b)[:n], M, 8, 1e-12, 1e8)
    np.testing.assert_allclose(np.asarray(dx)[:n], ref, rtol=1e-8,
                               atol=1e-10 * np.abs(ref).max())
