"""Schur complement oracle ladder (reference tests/schur.cu):

- Schur matrix / b_Schur / landmark update vs a dense NumPy
  reference to 1e-12 on a 2-camera/3-point BAL problem (schur.cu:113-240);
- full vs Schur direct solvers agree to 1e-8 (schur.cu:242-338);
- PCG-Schur (512 iters, tol 1e-14, rejection 1e6) vs direct to 5e-4
  (schur.cu:340-389).
"""

import jax.numpy as jnp
import numpy as np

import graphite_tpu as gt
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
from graphite_tpu.solvers import (
    DenseCholeskySolver,
    PCGSchurSolver,
    SparseDirectSolver,
)
from graphite_tpu.solvers.dense_cholesky_schur import (
    DenseCholeskySchurSolver,
    schur_to_dense,
)
from graphite_tpu.solvers.sparse_direct_schur import SparseDirectSchurSolver

MU = 1e-2


def _bal_problem(name="toy", seed=0):
    ds = synthetic.make_bal(name, seed=seed, noise=0.5)
    g, *_ = build_graph(ds, precision=gt.FP64_FP64)
    return g.freeze()


def _damped_setup(problem):
    lin = linearize(problem, problem.params0)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv0 = compute_hessian_values(problem, hs, lin)
    hv = apply_damping(problem, hs, hv0, lin.diag, MU, False)
    sv = schur_values(problem, ss, hv)
    return lin, hs, ss, hv, sv


def _dense_reference(problem, lin, hs, hv, ss):
    """Dense NumPy Schur reference (tests/schur_cpu_ref.cpp:8-51)."""
    H = hessian_to_dense(problem, hs, hv)
    np_ = ss.dim_p
    Hpp = H[:np_, :np_]
    Hpl = H[:np_, np_:]
    Hll = H[np_:, np_:]
    b = np.asarray(lin.b)[: problem.dim_h]
    b_p, b_l = b[:np_], b[np_:]
    Hll_inv = np.linalg.inv(Hll)
    S = Hpp - Hpl @ Hll_inv @ Hpl.T
    b_s = b_p - Hpl @ Hll_inv @ b_l
    return H, S, b_s, Hpl, Hll_inv, b_p, b_l


def test_schur_matrix_matches_dense_reference():
    problem = _bal_problem("toy")
    lin, hs, ss, hv, sv = _damped_setup(problem)
    _, S_ref, b_s_ref, Hpl, Hll_inv, _, b_l = _dense_reference(
        problem, lin, hs, hv, ss
    )
    S = np.asarray(schur_to_dense(problem, ss, sv))
    scale = max(1.0, np.abs(S_ref).max())
    np.testing.assert_allclose(S, S_ref, rtol=1e-12, atol=1e-12 * scale)

    ops = SchurOps(problem, ss, hv, sv)
    b_s = np.asarray(ops.b_schur(lin.b))
    np.testing.assert_allclose(b_s, b_s_ref, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(b_s_ref).max()))


def test_landmark_update_matches_dense_reference():
    problem = _bal_problem("toy")
    lin, hs, ss, hv, sv = _damped_setup(problem)
    _, S_ref, b_s_ref, Hpl, Hll_inv, _, b_l = _dense_reference(
        problem, lin, hs, hv, ss
    )
    dx_p = np.linalg.solve(S_ref, b_s_ref)
    dx_l_ref = Hll_inv @ (b_l - Hpl.T @ dx_p)
    ops = SchurOps(problem, ss, hv, sv)
    rows = ops.landmark_update(lin.b, jnp.asarray(dx_p))
    dx_l = np.asarray(
        ops.compose_delta(jnp.asarray(dx_p), rows)
    )[ss.dim_p: problem.dim_h]
    np.testing.assert_allclose(
        dx_l, dx_l_ref, rtol=1e-12,
        atol=1e-12 * max(1.0, np.abs(dx_l_ref).max()),
    )


def test_s_matvec_matches_dense():
    problem = _bal_problem("mini")
    lin, hs, ss, hv, sv = _damped_setup(problem)
    _, S_ref, *_ = _dense_reference(problem, lin, hs, hv, ss)
    ops = SchurOps(problem, ss, hv, sv)
    rng = np.random.default_rng(1)
    x = rng.normal(size=ss.dim_p)
    y = np.asarray(ops.s_matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, S_ref @ x, rtol=1e-10,
                               atol=1e-12 * max(1.0, np.abs(S_ref).max()))


def _solve_with(problem, lin, solver, mu=MU):
    state = solver.prepare(problem, lin)
    x, ok = solver.solve(problem, lin, state, mu, False)
    assert bool(ok)
    return np.asarray(x)[: problem.dim_h]


def test_full_vs_schur_direct_agreement():
    """Full direct vs Schur direct to 1e-8 (schur.cu:242-338)."""
    problem = _bal_problem("toy")
    lin = linearize(problem, problem.params0)
    x_full = _solve_with(problem, lin, DenseCholeskySolver())
    x_schur = _solve_with(problem, lin, DenseCholeskySchurSolver())
    x_sp = _solve_with(problem, lin, SparseDirectSolver())
    x_sps = _solve_with(problem, lin, SparseDirectSchurSolver())
    # on-device full-H dense path, forced (cudss.hpp:53-269 analog)
    x_dev = _solve_with(problem, lin, SparseDirectSolver(on_device=True))
    atol = 1e-8 * max(1.0, np.abs(x_full).max())
    np.testing.assert_allclose(x_schur, x_full, rtol=1e-8, atol=atol)
    np.testing.assert_allclose(x_sp, x_full, rtol=1e-8, atol=atol)
    np.testing.assert_allclose(x_sps, x_full, rtol=1e-8, atol=atol)
    np.testing.assert_allclose(x_dev, x_full, rtol=1e-8, atol=atol)


def test_pcg_schur_vs_direct():
    """PCG-Schur vs direct to 5e-4 (schur.cu:340-389)."""
    problem = _bal_problem("mini")
    lin = linearize(problem, problem.params0)
    x_direct = _solve_with(problem, lin, DenseCholeskySchurSolver())
    pcg = PCGSchurSolver(max_iter=512, tol=1e-14, rejection_ratio=1e6)
    x_pcg = _solve_with(problem, lin, pcg)
    np.testing.assert_allclose(
        x_pcg, x_direct, rtol=5e-4,
        atol=5e-4 * max(1.0, np.abs(x_direct).max()),
    )


def test_jacfwd_vs_finite_difference_bal():
    """BAL reprojection jacfwd vs central finite differences."""
    from graphite_tpu.models.bal import reprojection_residual
    import jax

    rng = np.random.default_rng(3)
    cam = np.concatenate(
        [rng.normal(0, 0.3, 3), [0.1, -0.2, -3.0], [500.0, 1e-3, -1e-4]]
    )
    pt = rng.normal(0, 0.5, 3)
    obs = np.array([1.0, -2.0])
    J = jax.jacfwd(reprojection_residual, argnums=(0, 1))(
        jnp.asarray(cam), jnp.asarray(pt), jnp.asarray(obs)
    )
    eps = 1e-6

    def fd(fun, x):
        cols = []
        for i in range(x.size):
            dx = np.zeros_like(x)
            dx[i] = eps
            cols.append(
                (np.asarray(fun(x + dx)) - np.asarray(fun(x - dx))) / (2 * eps)
            )
        return np.stack(cols, axis=1)

    J_cam = fd(lambda c: reprojection_residual(jnp.asarray(c), jnp.asarray(pt),
                                               jnp.asarray(obs)), cam)
    J_pt = fd(lambda p: reprojection_residual(jnp.asarray(cam), jnp.asarray(p),
                                              jnp.asarray(obs)), pt)
    np.testing.assert_allclose(np.asarray(J[0]), J_cam, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(J[1]), J_pt, rtol=1e-5, atol=1e-4)


def test_rodrigues_at_zero():
    """theta -> 0 branch must be differentiable (Taylor branch parity)."""
    import jax
    from graphite_tpu.models.bal import rodrigues_rotate

    X = jnp.asarray([1.0, 2.0, 3.0])
    J = jax.jacfwd(lambda r: rodrigues_rotate(r, X))(jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(J)))
    # d(R(r)X)/dr at r=0 is -[X]_x
    skew = np.array([[0, 3, -2], [-3, 0, 1], [2, -1, 0]], dtype=float)
    np.testing.assert_allclose(np.asarray(J), skew, atol=1e-12)
