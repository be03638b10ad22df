"""Dense Cholesky direct solver.

Stand-in for the reference's direct solvers on *small* problems: this
densifies ``H = J^T dL P J`` (the scaled system) and solves with ``jax.scipy.linalg.cho_solve``. It fills the
role of ``EigenLDLTSolver``/``cudssSolver`` (reference: solver/eigen.hpp:12-99,
solver/cudss.hpp:53-269) for the oracle ladder and small graphs; large sparse
problems should use PCG / PCG-Schur (the reference's flagship path too).

Failure semantics: a non-finite Cholesky result reports ok=False so LM treats
the step as rejected (levenberg_marquardt.hpp:181-183), mirroring the
factorization-failure contract.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..linearize import DIAG_MIN, DIAG_MAX, Linearization, _apply_precision
from ..ops.blockfmt import unflatten_blocks
from ..ops.segment import col_indices, scatter_add_flat


def assemble_dense_hessian(problem, lin: Linearization) -> jax.Array:
    """Dense ``H = sum_f J^T dL P J`` over the (dim_h, dim_h) active columns.

    Block-pair contributions mirror ``compute_hessian_block_kernel``
    (ops/hessian.hpp:9-78) but as batched einsums + one flat segment_sum.
    """
    acc = problem.precision.acc_dtype
    n = problem.dim_x
    h_flat = jnp.zeros(n * n, dtype=acc)
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        J = lin.jacobians[name]
        if J is None:
            raise ValueError(
                f"dense assembly requires stored Jacobians ('{name}' is dynamic)"
            )
        dL = lin.chi2_deriv[name].astype(acc)
        E = fm.ftype.residual_dim
        for s, vs in enumerate(fm.ftype.vertex_types):
            Js = unflatten_blocks(J[s], E, vs.dim).astype(acc)
            PJs = _apply_precision(fa, Js, acc)
            rows = col_indices(fa.cols_base[:, s], vs.dim)  # (F, ds)
            for t, vt in enumerate(fm.ftype.vertex_types):
                Jt = unflatten_blocks(J[t], E, vt.dim).astype(acc)
                blk = jnp.einsum(
                    "fer,fec->frc", PJs, Jt, preferred_element_type=acc
                ) * dL[:, None, None]
                cols = col_indices(fa.cols_base[:, t], vt.dim)  # (F, dt)
                flat_idx = rows[:, :, None] * n + cols[:, None, :]
                h_flat = h_flat + scatter_add_flat(blk, flat_idx, n * n)
    H = h_flat.reshape(n, n)[: problem.dim_h, : problem.dim_h]
    return H


def damp_hessian(H: jax.Array, damping, use_identity: bool) -> jax.Array:
    """LM diagonal augmentation (hessian.hpp:136-176)."""
    d = jnp.diagonal(H)
    if use_identity:
        new_d = d + damping
    else:
        new_d = d + damping * jnp.clip(d, DIAG_MIN, DIAG_MAX)
    return H + jnp.diag(new_d - d)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DenseCholeskyState:
    H: jax.Array  # (dim_h, dim_h) undamped dense Hessian


@dataclasses.dataclass(frozen=True)
class DenseCholeskySolver:
    # solve() reads only lin.b (H assembled in prepare) -> slim LM carry
    slim_carry = True

    def prepare(self, problem, lin: Linearization, params=None):
        return DenseCholeskyState(H=assemble_dense_hessian(problem, lin))

    def solve(self, problem, lin: Linearization, state: DenseCholeskyState,
              damping, use_identity: bool, params=None):
        gdt = problem.precision.graph_dtype
        H = damp_hessian(state.H, damping, use_identity)
        b = lin.b[: problem.dim_h].astype(H.dtype)
        L, low = jax.scipy.linalg.cho_factor(H, lower=True)
        x = jax.scipy.linalg.cho_solve((L, low), b)
        ok = jnp.all(jnp.isfinite(x))
        x = jnp.where(ok, x, 0.0).astype(gdt)
        out = jnp.zeros(problem.dim_x, dtype=gdt).at[: problem.dim_h].set(x)
        return out, ok
