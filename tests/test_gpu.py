"""The main path on the card, against host references (marked ``gpu``;
skips without an NVIDIA GPU, see conftest.py for the command)."""

import numpy as np
import pytest

import graphite_tpu as gt
from graphite_tpu.hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from graphite_tpu.io import synthetic
from graphite_tpu.io.bal import build_graph
from graphite_tpu.linearize import linearize
from graphite_tpu.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu.schur import SchurOps, build_schur_structure, schur_values
from graphite_tpu.schur_reference import schur_reference
from graphite_tpu.solvers import PCGSchurSolver
from graphite_tpu.solvers.dense_cholesky_schur import schur_to_dense

pytestmark = pytest.mark.gpu


def _ladybug(precision=gt.FP32_FP32):
    ds = synthetic.make_bal("ladybug", seed=0)
    g, *_ = build_graph(ds, precision=precision)
    return g.freeze()


def test_schur_stages_match_reference_on_gpu(gpu):
    """S, b_Schur and the landmark update at Ladybug size, within float32
    rounding of the terms each stage sums (see chip_smoke.py)."""
    problem = _ladybug()
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)

    def stages(params):
        lin = linearize(problem, params)
        hv = apply_damping(problem, hs,
                           compute_hessian_values(problem, hs, lin),
                           lin.diag, 1e-4, False)
        sv = schur_values(problem, ss, hv)
        ops = SchurOps(problem, ss, hv, sv)
        return lin, hv, schur_to_dense(problem, ss, sv), ops.b_schur(lin.b)

    lin, hv, S, b_s = problem.jit_with_consts(stages)(problem.params0)
    assert S.devices() == {gpu}
    ref = schur_reference(problem, hs, hv, lin.b)
    for got, want, terms in (
            (S, ref.s_matrix().toarray(), ref.s_terms().toarray()),
            (b_s, ref.b_schur(), ref.b_schur_terms())):
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err / terms.max() <= 1e-6


def test_lm_on_gpu_matches_cpu_device(gpu):
    """PCG-Schur LM in float32 on the card and on the CPU device over the
    reference app's 50 iterations: atomic-add order moves the inexact-PCG
    path (up to 1.7e-4 measured), a wrong stage moves it by orders of
    magnitude (see chip_smoke.py)."""
    import jax

    solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    opts = LevenbergMarquardtOptions(iterations=50, initial_damping=1e-4,
                                     jit_loop=True)
    res = levenberg_marquardt(_ladybug(), solver, options=opts)
    with jax.default_device(jax.devices("cpu")[0]):
        ref = levenberg_marquardt(_ladybug(), solver, options=opts)
    assert np.isfinite(res.chi2)
    assert abs(res.chi2 - ref.chi2) <= 2e-3 * abs(ref.chi2)
