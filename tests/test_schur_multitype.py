"""Schur elimination with TWO eliminated vertex types of different dims and
two pose types — exercises the dim-grouped and type-partitioned general
paths (the reference caps block dims at 32 and assumes one ProductDim set;
here dims mix freely)."""

import jax.numpy as jnp
import numpy as np

import graphite_tpu as gt
from graphite_tpu.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
    hessian_to_dense,
)
from graphite_tpu.linearize import linearize
from graphite_tpu.schur import SchurOps, build_schur_structure, schur_values
from graphite_tpu.solvers import DenseCholeskySolver
from graphite_tpu.solvers.dense_cholesky_schur import (
    DenseCholeskySchurSolver,
    schur_to_dense,
)
from graphite_tpu.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)

POSE4 = gt.vertex_type("mt_pose4", 4)
POSE2 = gt.vertex_type("mt_pose2", 2)
LM3 = gt.vertex_type("mt_lm3", 3)
LM1 = gt.vertex_type("mt_lm1", 1)


def f43(p, l, obs):
    return jnp.array([p[0] * l[0] + p[1] - obs[0],
                      p[2] * l[1] + p[3] * l[2] - obs[1]])


def f41(p, l, obs):
    return jnp.array([p[0] + p[3] * l[0] - obs[0]])


def f23(p, l, obs):
    return jnp.array([p[0] * l[2] - obs[0], p[1] + l[0] - obs[1]])


F43 = gt.factor_type("mt_f43", 2, [POSE4, LM3], f43, obs_shape=(2,))
F41 = gt.factor_type("mt_f41", 1, [POSE4, LM1], f41, obs_shape=(1,))
F23 = gt.factor_type("mt_f23", 2, [POSE2, LM3], f23, obs_shape=(2,))


def _problem(seed=0, precision=gt.FP64_FP64):
    rng = np.random.default_rng(seed)
    g = gt.Graph(precision=precision)
    p4 = g.add_vertex_set(POSE4)
    p2 = g.add_vertex_set(POSE2)
    l3 = g.add_vertex_set(LM3)
    l1 = g.add_vertex_set(LM1)
    n4, n2, nl3, nl1 = 3, 2, 6, 4
    for i in range(n4):
        p4.add(i, rng.normal(1, 0.3, 4))
    for i in range(n2):
        p2.add(100 + i, rng.normal(1, 0.3, 2))
    for i in range(nl3):
        l3.add(200 + i, rng.normal(0.5, 0.3, 3))
    for i in range(nl1):
        l1.add(300 + i, rng.normal(0.5, 0.3, 1))
    l3.set_eliminate(True)
    l1.set_eliminate(True)

    fs43 = g.add_factor_set(F43)
    fs41 = g.add_factor_set(F41)
    fs23 = g.add_factor_set(F23)
    for _ in range(30):
        fs43.add([int(rng.integers(n4)), 200 + int(rng.integers(nl3))],
                 obs=rng.normal(0, 1, 2))
    for _ in range(15):
        fs41.add([int(rng.integers(n4)), 300 + int(rng.integers(nl1))],
                 obs=rng.normal(0, 1, 1))
    for _ in range(20):
        fs23.add([100 + int(rng.integers(n2)), 200 + int(rng.integers(nl3))],
                 obs=rng.normal(0, 1, 2))
    return g.freeze()


def test_multitype_schur_matches_dense():
    problem = _problem()
    assert problem.elimination_block > 0
    lin = linearize(problem, problem.params0)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    assert len(ss.lm_dims) == 2  # two eliminated dims (1 and 3)
    assert len(set(int(d) for d in ss.pose_dims)) == 2  # pose dims 2 and 4
    hv = apply_damping(problem, hs,
                       compute_hessian_values(problem, hs, lin),
                       lin.diag, 1e-2, False)
    sv = schur_values(problem, ss, hv)

    H = hessian_to_dense(problem, hs, hv)
    npp = ss.dim_p
    Hpp, Hpl, Hll = H[:npp, :npp], H[:npp, npp:], H[npp:, npp:]
    Hll_inv = np.linalg.inv(Hll)
    S_ref = Hpp - Hpl @ Hll_inv @ Hpl.T
    S = np.asarray(schur_to_dense(problem, ss, sv))
    np.testing.assert_allclose(S, S_ref, rtol=1e-10,
                               atol=1e-10 * max(1.0, np.abs(S_ref).max()))

    ops = SchurOps(problem, ss, hv, sv)
    b = np.asarray(lin.b)[: problem.dim_h]
    b_s = np.asarray(ops.b_schur(jnp.asarray(lin.b)))
    b_s_ref = b[:npp] - Hpl @ Hll_inv @ b[npp:]
    np.testing.assert_allclose(b_s, b_s_ref, rtol=1e-10,
                               atol=1e-10 * max(1.0, np.abs(b_s_ref).max()))

    rng = np.random.default_rng(1)
    x = rng.normal(size=npp)
    y = np.asarray(ops.s_matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, S_ref @ x, rtol=1e-9,
                               atol=1e-10 * max(1.0, np.abs(S_ref).max()))

    dx_p = np.linalg.solve(S_ref, b_s_ref)
    dx_l_ref = Hll_inv @ (b[npp:] - Hpl.T @ dx_p)
    delta = np.asarray(ops.compose_delta(
        jnp.asarray(dx_p), ops.landmark_update(jnp.asarray(lin.b),
                                               jnp.asarray(dx_p))))
    np.testing.assert_allclose(delta[npp: problem.dim_h], dx_l_ref,
                               rtol=1e-9, atol=1e-10)


POSE3 = gt.vertex_type("mt_pose3", 3)
LM3B = gt.vertex_type("mt_lm3b", 3)


def f33(p, l, obs):
    return jnp.array([p[0] * l[0] + p[1] - obs[0],
                      p[2] * l[1] + l[2] - obs[1]])


def f33pp(p, q, obs):
    return jnp.array([p[0] - q[1] - obs[0], p[2] * q[0] - obs[1]])


F33 = gt.factor_type("mt_f33", 2, [POSE3, LM3B], f33, obs_shape=(2,))
F33PP = gt.factor_type("mt_f33pp", 2, [POSE3, POSE3], f33pp,
                       obs_shape=(2,))


def test_equal_dims_mixed_group_schur_matches_dense():
    """dp == dl (3-dim poses, 3-dim landmarks): the single (3,3) Hessian
    value group holds pose-diagonal, landmark-diagonal, pose-pose
    off-diagonal AND pose-landmark blocks, so ``hpl_h_idx`` is NOT the
    identity — the triple-product right-operand indices must be composed
    through it (a silent wrong-rows read before round 5)."""
    rng = np.random.default_rng(4)
    g = gt.Graph(precision=gt.FP64_FP64)
    p3 = g.add_vertex_set(POSE3)
    l3 = g.add_vertex_set(LM3B)
    n_p, n_l = 4, 7
    for i in range(n_p):
        p3.add(i, rng.normal(1, 0.3, 3))
    for i in range(n_l):
        l3.add(100 + i, rng.normal(0.5, 0.3, 3))
    l3.set_eliminate(True)
    fs = g.add_factor_set(F33)
    for _ in range(40):
        fs.add([int(rng.integers(n_p)), 100 + int(rng.integers(n_l))],
               obs=rng.normal(0, 1, 2))
    fpp = g.add_factor_set(F33PP)
    for i in range(n_p - 1):
        fpp.add([i, i + 1], obs=rng.normal(0, 1, 2))
    problem = g.freeze()

    ss = build_schur_structure(problem)
    (key,) = ss.hpl_keys
    assert key == (3, 3)
    hidx = ss.hpl_h_idx[key]
    assert not np.array_equal(hidx, np.arange(hidx.shape[0])), (
        "fixture failed to produce a mixed (3,3) group")

    lin = linearize(problem, problem.params0)
    hs = build_hessian_structure(problem)
    hv = apply_damping(problem, hs,
                       compute_hessian_values(problem, hs, lin),
                       lin.diag, 1e-2, False)
    sv = schur_values(problem, ss, hv)

    H = hessian_to_dense(problem, hs, hv)
    npp = ss.dim_p
    Hpp, Hpl, Hll = H[:npp, :npp], H[:npp, npp:], H[npp:, npp:]
    S_ref = Hpp - Hpl @ np.linalg.inv(Hll) @ Hpl.T
    S = np.asarray(schur_to_dense(problem, ss, sv))
    np.testing.assert_allclose(S, S_ref, rtol=1e-10,
                               atol=1e-10 * max(1.0, np.abs(S_ref).max()))


def test_multitype_full_vs_schur_lm():
    problem = _problem(seed=2)
    opts = LevenbergMarquardtOptions(iterations=15, initial_damping=1e-3)
    res_full = levenberg_marquardt(problem, DenseCholeskySolver(),
                                   options=opts)
    problem2 = _problem(seed=2)
    res_schur = levenberg_marquardt(problem2, DenseCholeskySchurSolver(),
                                    options=opts)
    np.testing.assert_allclose(res_schur.chi2, res_full.chi2, rtol=1e-8)
