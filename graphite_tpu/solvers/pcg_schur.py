"""PCG on the explicit Schur system — the flagship bundle-adjustment path.

JAX analog of ``PCGSchurSolver`` (reference: solver/pcg_schur.hpp:24-169):

- per solve: damp H, rebuild Schur values + preconditioner (:81-84);
- PCG loop on ``S dx_p = b_S`` with the same normalization / rejection
  semantics as the matrix-free PCG (:108-163);
- landmark back-substitution after convergence (:166).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..hessian import (
    HessianValues,
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from ..linearize import Linearization
from ..ops.pcg_loop import run_pcg
from ..preconditioners.block_jacobi_schur import (
    BlockJacobiSchurPreconditioner,
)
from ..schur import SchurOps, build_schur_structure, schur_values


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SchurSolverState:
    hvals: HessianValues  # undamped Hessian block values


@dataclasses.dataclass(frozen=True)
class PCGSchurSolver:
    """PCG on the explicit Schur system.

    ``dense_matvec_limit``: when the pose system is small enough
    (dim_p <= limit), the S block values are scattered into a dense
    (dim_p, dim_p) matrix once per solve and the PCG matvec becomes one
    matrix-vector product — identical math (dim_p is only 9*n_cameras for
    BAL). Set to 0 to force the block-sparse matvec.
    """

    max_iter: int = 10
    tol: float = 1.0
    rejection_ratio: float = 5.0
    # solve() reads only lin.b / lin.diag (Hessian values live in the
    # prepared state) -> the LM loop may carry a slimmed Linearization
    # (linearize.slim_linearization)
    slim_carry = True
    preconditioner: object = dataclasses.field(
        default_factory=BlockJacobiSchurPreconditioner
    )
    # Venice-1778 (dim_p = 16,002) stays block-sparse: a dense S there
    # holds 1.02 GB and is rebuilt every solve.
    dense_matvec_limit: int = 8192

    def prepare(self, problem, lin: Linearization, params=None):
        hs = build_hessian_structure(problem)
        build_schur_structure(problem)  # cache structure on first use
        return SchurSolverState(
            hvals=compute_hessian_values(problem, hs, lin))

    def solve(self, problem, lin: Linearization, state: SchurSolverState,
              damping, use_identity: bool, params=None):
        gdt = problem.precision.graph_dtype
        hs = build_hessian_structure(problem)
        ss = build_schur_structure(problem)

        hv = apply_damping(problem, hs, state.hvals, lin.diag, damping,
                           use_identity)
        sv = schur_values(problem, ss, hv)
        ops = SchurOps(problem, ss, hv, sv)
        b_s = ops.b_schur(lin.b)

        pstate = self.preconditioner.prepare(problem, ss, sv)

        def precond(y):
            return self.preconditioner.apply(problem, ss, pstate, y)

        if ss.dim_p <= self.dense_matvec_limit:
            from .dense_cholesky_schur import schur_to_dense

            S = schur_to_dense(problem, ss, sv)

            def matvec(p):
                return (S @ p.astype(S.dtype)).astype(gdt)
        else:
            matvec = ops.s_matvec

        dx_p = run_pcg(b_s, matvec, precond, self.max_iter, self.tol,
                       self.rejection_ratio)
        dx_l_rows = ops.landmark_update(lin.b, dx_p)
        return ops.compose_delta(dx_p, dx_l_rows), jnp.asarray(True)
