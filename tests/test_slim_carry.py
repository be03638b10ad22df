"""Slim LM carry (linearize.slim_linearization): solvers whose ``solve``
reads only b/diag declare ``slim_carry = True`` and the jitted LM
while_loop carries a Linearization without the per-factor arrays — the
trajectory must be identical to the full-carry run
(``GRAPHITE_TPU_FULL_CARRY=1``).

Reference: the trust-region loop of
optimizer/levenberg_marquardt.hpp:166-238 mutates state in place; the
functional carry is the JAX analog and the slimming removes the
accept/reject cond-select pass over Jacobian storage.
"""

import os

import pytest

import graphite_tpu as gt
from graphite_tpu.io import bal as bal_io
from graphite_tpu.io import synthetic
from graphite_tpu.linearize import linearize, slim_linearization
from graphite_tpu.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu.solvers import (
    DenseCholeskySchurSolver,
    PCGSchurSolver,
    PCGSolver,
)


def _run(solver, env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ds = synthetic.make_bal("mini", seed=0)
        g, *_ = bal_io.build_graph(ds, precision=gt.FP32_FP32)
        problem = g.freeze()
        opts = LevenbergMarquardtOptions(iterations=6, initial_damping=1e-4,
                                         jit_loop=True)
        return levenberg_marquardt(problem, solver, options=opts)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.mark.parametrize("solver_cls", [PCGSchurSolver,
                                        DenseCholeskySchurSolver])
def test_slim_matches_full_carry(solver_cls):
    solver = solver_cls()
    assert getattr(solver, "slim_carry", False)
    slim = _run(solver, {})
    full = _run(solver, {"GRAPHITE_TPU_FULL_CARRY": "1"})
    assert slim.iterations == full.iterations
    assert slim.accepted_steps == full.accepted_steps
    # identical math, but two structurally different XLA programs:
    # fusion/scheduling differences may legitimately change rounding on
    # some backends, so assert a tight tolerance (accept pattern and
    # iteration counts above stay exact)
    assert slim.chi2 == pytest.approx(full.chi2, rel=1e-6)
    for hs, hf in zip(slim.history, full.history):
        assert hs["chi2"] == pytest.approx(hf["chi2"], rel=1e-6)
        assert hs["accepted"] == hf["accepted"]


def test_matrix_free_pcg_keeps_full_lin():
    # PCGSolver's solve() consumes lin.jacobians (matrix-free J products):
    # it must NOT opt into the slim carry.
    assert not getattr(PCGSolver(), "slim_carry", False)


def test_slim_linearization_drops_factor_arrays():
    ds = synthetic.make_bal("mini", seed=0)
    g, *_ = bal_io.build_graph(ds, precision=gt.FP32_FP32)
    problem = g.freeze()
    lin = problem.jit_with_consts(
        lambda p: linearize(problem, p))(problem.params0)
    slim = slim_linearization(lin)
    assert slim.jacobians == {} and slim.residuals == {}
    assert slim.chi2_vec == {} and slim.chi2_deriv == {}
    # solve-facing vectors survive untouched
    assert slim.b is lin.b and slim.diag is lin.diag
    assert slim.scales is lin.scales and slim.chi2 is lin.chi2
