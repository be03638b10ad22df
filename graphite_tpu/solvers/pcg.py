"""Matrix-free preconditioned conjugate gradients.

JAX analog of ``PCGSolver`` (reference: solver/pcg.hpp:12-233), with
the host PCG loop replaced by a ``lax.while_loop`` over a functional state.
Semantics preserved exactly:

- implicit Hessian product ``H p = J^T dL P (J p) + damping``
  (pcg.hpp:141-168), with damping ``mu * clamp(diag,1e-6,1e32) * p`` or
  ``mu * p`` for identity damping (pcg.hpp:102-104, ops/vector.hpp:26-39);
- the residual is **normalized** before every preconditioner application
  (pcg.hpp:109-121, 184-193);
- divergence guard: if ``|rz_new| > rejection_ratio * rz_0`` or NaN, restore
  the previous x and stop (pcg.hpp:198-206); ``rz_0`` tracks the running
  minimum of ``|rz|`` (pcg.hpp:206);
- termination on ``rz == 0``, ``|rz_new| < tol``, or max_iter; always
  returns ok=True (pcg.hpp:230-231).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..linearize import DIAG_MIN, DIAG_MAX, Linearization, hessian_matvec
from ..ops.pcg_loop import run_pcg
from ..preconditioners.identity import IdentityPreconditioner


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PCGState:
    precond_state: object


@dataclasses.dataclass(frozen=True)
class PCGSolver:
    """max_iter/tol/rejection_ratio as in the reference ctor (pcg.hpp:35-39)."""

    max_iter: int = 10
    tol: float = 1.0
    rejection_ratio: float = 5.0
    preconditioner: object = dataclasses.field(
        default_factory=IdentityPreconditioner
    )

    def prepare(self, problem, lin: Linearization, params=None) -> PCGState:
        return PCGState(
            precond_state=self.preconditioner.prepare(problem, lin, params)
        )

    def solve(self, problem, lin: Linearization, state: PCGState,
              damping, use_identity: bool, params=None):
        gdt = problem.precision.graph_dtype
        dim_x = problem.dim_x
        damping = jnp.asarray(damping, dtype=gdt)

        pstate = self.preconditioner.set_damping(
            problem, lin, state.precond_state, damping, use_identity
        )

        diag = jnp.clip(lin.diag, DIAG_MIN, DIAG_MAX)
        if use_identity:
            damp_vec = jnp.ones_like(diag) * damping
        else:
            damp_vec = diag * damping

        def matvec(p):
            return hessian_matvec(problem, lin, p, params) + damp_vec * p

        def precond(y):
            return self.preconditioner.apply(problem, lin, pstate, y)

        x = run_pcg(lin.b, matvec, precond, self.max_iter, self.tol,
                    self.rejection_ratio)
        x = x.at[problem.dim_h:].set(0.0)
        return x, jnp.asarray(True)
