"""Factor-parallel sharding over a virtual 8-device CPU mesh.

Oracle: sharded results equal single-device results (the reductions are
segment_sums + psums — deterministic both ways)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import graphite_tpu as gt
from graphite_tpu.io import bal as bal_io
from graphite_tpu.io import synthetic
from graphite_tpu.linearize import linearize
from graphite_tpu.optimizers import LevenbergMarquardtOptions, levenberg_marquardt
from graphite_tpu.parallel import (
    make_mesh,
    shard_data,
    sharded_linearize_fn,
    sharded_lm,
)
from graphite_tpu.parallel.sharding import sharded_lm_step_fn
from graphite_tpu.solvers import PCGSchurSolver, PCGSolver
from graphite_tpu.preconditioners import BlockJacobiPreconditioner

N_DEV = 8


def _problem(pad):
    ds = synthetic.make_bal("mini", seed=0, noise=0.5)
    g, *_ = bal_io.build_graph(ds, precision=gt.FP64_FP64)
    return g.freeze(pad_factors_to=pad)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= N_DEV
    return make_mesh(N_DEV)


def test_padding_is_neutral():
    p1 = _problem(pad=1)
    p8 = _problem(pad=N_DEV)
    assert p8.factor_meta["bal_reprojection"].count % N_DEV == 0
    l1 = linearize(p1, p1.params0)
    l8 = linearize(p8, p8.params0)
    np.testing.assert_allclose(float(l8.chi2), float(l1.chi2), rtol=1e-14)
    np.testing.assert_allclose(np.asarray(l8.b), np.asarray(l1.b), rtol=1e-13,
                               atol=1e-14)


def test_sharded_linearize_matches(mesh):
    problem = _problem(pad=N_DEV)
    lin_ref = linearize(problem, problem.params0)
    f = sharded_linearize_fn(problem, mesh)
    data = shard_data(problem, mesh)
    chi2, b, scales, diag = f(data, problem.params0)
    np.testing.assert_allclose(float(chi2), float(lin_ref.chi2), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(b), np.asarray(lin_ref.b),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(diag), np.asarray(lin_ref.diag),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("solver_kind", ["pcg", "pcg-schur"])
def test_sharded_step_matches_single_device(mesh, solver_kind):
    problem = _problem(pad=N_DEV)
    if solver_kind == "pcg":
        solver = PCGSolver(max_iter=30, tol=1e-12, rejection_ratio=1e6,
                           preconditioner=BlockJacobiPreconditioner())
    else:
        solver = PCGSchurSolver(max_iter=30, tol=1e-12, rejection_ratio=1e6)
    mu = 1e-3

    # single-device reference
    lin = linearize(problem, problem.params0)
    sstate = solver.prepare(problem, lin, problem.params0)
    delta_ref, _ = solver.solve(problem, lin, sstate, mu, False,
                                problem.params0)

    f = sharded_lm_step_fn(problem, mesh, solver, mu)
    data = shard_data(problem, mesh)
    new_params, chi2_before, chi2_after = f(data, problem.params0)
    np.testing.assert_allclose(float(chi2_before), float(lin.chi2), rtol=1e-13)

    from graphite_tpu.linearize import apply_update, compute_chi2

    ref_params = apply_update(problem, problem.params0, lin, delta_ref)
    ref_chi2 = compute_chi2(problem, ref_params)
    # psum reduction order differs from the single-device segment_sum order,
    # so agreement is to roundoff accumulation, not bitwise.
    np.testing.assert_allclose(float(chi2_after), float(ref_chi2), rtol=1e-6)
    for k in ref_params:
        np.testing.assert_allclose(
            np.asarray(new_params[k]), np.asarray(ref_params[k]),
            rtol=1e-6, atol=1e-7,
        )


def test_sharded_full_lm_matches(mesh):
    problem = _problem(pad=N_DEV)
    solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    options = LevenbergMarquardtOptions(iterations=10, initial_damping=1e-4)

    res_ref = levenberg_marquardt(
        problem, solver, options=LevenbergMarquardtOptions(
            iterations=10, initial_damping=1e-4, jit_loop=True)
    )
    params, chi2, iters, accepted = sharded_lm(problem, make_mesh(N_DEV),
                                               solver, options)
    np.testing.assert_allclose(float(chi2), res_ref.chi2, rtol=1e-9)
    assert int(iters) == res_ref.iterations
    assert int(accepted) == res_ref.accepted_steps


def test_sharded_schur_values_match_single_device(mesh):
    """The sharded triple-product stage (1/n of every product group per
    device + one psum per destination group) reproduces single-device S
    block values."""
    from jax.sharding import PartitionSpec as P

    from graphite_tpu.hessian import (
        apply_damping,
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu.parallel.sharding import data_specs, shard_map
    from graphite_tpu.schur import build_schur_structure, schur_values

    problem = _problem(pad=N_DEV)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    lin = linearize(problem, problem.params0)
    hv = apply_damping(problem, hs, compute_hessian_values(problem, hs, lin),
                       lin.diag, 1e-3, False)
    sv_ref = schur_values(problem, ss, hv)

    pspec = jax.tree.map(lambda _: P(), problem.params0)

    def local(data, params):
        p = problem.shard_replica(data, "factors", n_devices=N_DEV)
        lin_l = linearize(p, params)
        hv_l = apply_damping(
            p, hs, compute_hessian_values(p, hs, lin_l), lin_l.diag,
            1e-3, False)
        sv_l = schur_values(p, ss, hv_l)
        return sv_l.s_vals

    f = jax.jit(shard_map(
        local, mesh,
        in_specs=(data_specs(problem), pspec),
        out_specs=jax.tree.map(lambda _: P(), sv_ref.s_vals),
    ))
    s_vals = f(shard_data(problem, mesh), problem.params0)
    for k in sv_ref.s_vals:
        np.testing.assert_allclose(
            np.asarray(s_vals[k]), np.asarray(sv_ref.s_vals[k]),
            rtol=1e-12, atol=1e-13,
        )


@pytest.mark.parametrize("chunked", [False, True])
def test_sharded_schur_dst_partition(mesh, monkeypatch, chunked):
    """The dst-partitioned sharded product stage: each device owns a
    contiguous, segment-aligned ~K/8 slice of the pair list, reduces it
    with one sorted segment_sum (or, above the transient budget, a scan
    fold whose padding rows hit the trash segment), and the disjoint-slice
    all-gather reassembly matches the single-device S."""
    import graphite_tpu.schur as schur_mod
    from jax.sharding import PartitionSpec as P

    from graphite_tpu.hessian import (
        apply_damping,
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu.parallel.sharding import data_specs, shard_map
    from graphite_tpu.schur import build_schur_structure, schur_values

    ds = synthetic.make_bal((10, 400, 3000), seed=5, noise=0.5)
    g, *_ = bal_io.build_graph(ds, precision=gt.FP32_FP32)
    problem = g.freeze(pad_factors_to=N_DEV)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    lin = linearize(problem, problem.params0)
    hv = apply_damping(problem, hs, compute_hessian_values(problem, hs, lin),
                       lin.diag, 1e-3, False)
    sv_ref = schur_values(problem, ss, hv)
    if chunked:
        monkeypatch.setattr(schur_mod, "CHUNK_THRESHOLD", 64)
        monkeypatch.setattr(schur_mod, "CHUNK", 64)

    pspec = jax.tree.map(lambda _: P(), problem.params0)

    def local(data, params):
        p = problem.shard_replica(data, "factors", n_devices=N_DEV)
        lin_l = linearize(p, params)
        hv_l = apply_damping(
            p, hs, compute_hessian_values(p, hs, lin_l), lin_l.diag,
            1e-3, False)
        return schur_values(p, ss, hv_l).s_vals

    f = jax.jit(shard_map(
        local, mesh,
        in_specs=(data_specs(problem), pspec),
        out_specs=jax.tree.map(lambda _: P(), sv_ref.s_vals),
    ))
    s_vals = f(shard_data(problem, mesh), problem.params0)
    for k in sv_ref.s_vals:
        np.testing.assert_allclose(
            np.asarray(s_vals[k]), np.asarray(sv_ref.s_vals[k]),
            rtol=2e-4, atol=1e-3,
        )

    # the partition plan balances rows across devices (segment-aligned:
    # bounded skew) over disjoint, ordered destination ranges
    plans = problem._cache["sharded_product_plans"]
    assert plans, "dst-partitioned plan not built"
    for sp in plans.values():
        rows = np.asarray(sp["rows"])
        K = rows.sum()
        assert rows.max() <= 2 * K / N_DEV
        assert (rows > 0).sum() >= N_DEV - 1
        seg0 = np.asarray(sp["seg0"])
        ends = seg0 + np.asarray(sp["ns_list"])
        live = np.asarray(sp["ns_list"]) > 0
        assert np.all(np.diff(seg0[live]) > 0)
        assert np.all(seg0[live][1:] >= ends[live][:-1])
        # every device's segment ids are sorted (pads -> trash ns_max)
        assert np.all(np.diff(sp["seg"], axis=1) >= 0)


def test_sharded_lm_multi_iteration_nonmini(mesh):
    """Sharded LM on a non-mini problem for >= 3 iterations (PCG-Schur),
    agreeing with the single-device trajectory."""
    ds = synthetic.make_bal((8, 60, 300), seed=3, noise=0.5)
    g, *_ = bal_io.build_graph(ds, precision=gt.FP64_FP64)
    problem = g.freeze(pad_factors_to=N_DEV)
    solver = PCGSchurSolver(max_iter=20, tol=1e-10, rejection_ratio=1e6)
    options = LevenbergMarquardtOptions(iterations=5, initial_damping=1e-4)

    res_ref = levenberg_marquardt(
        problem, solver, options=LevenbergMarquardtOptions(
            iterations=5, initial_damping=1e-4, jit_loop=True))
    params, chi2, iters, accepted = sharded_lm(problem, mesh, solver, options)
    assert int(iters) >= 3
    assert int(iters) == res_ref.iterations
    np.testing.assert_allclose(float(chi2), res_ref.chi2, rtol=1e-8)
