"""Block-Jacobi preconditioner.

JAX analog of ``BlockJacobiPreconditioner``
(reference: preconditioner/block_jacobi.hpp:10-187):

- per-vertex diagonal blocks ``B_v = sum_f dL_f J_{f,v}^T P_f J_{f,v}``
  assembled from the (already scaled) Jacobians via batched einsum +
  segment_sum instead of atomicAdd kernels
  (ops/hessian.hpp:169-268);
- LM damping augments the diagonal entries from a pre-damping backup:
  ``d += mu`` (identity) or ``d += mu * clamp(d, 1e-6, 1e32)``
  (ops/hessian.hpp:80-110);
- batched inversion by ``vmap(jnp.linalg.inv)`` per vertex type (replacing
  cuBLAS ``matinvBatched``, block_jacobi.hpp:152-167) in ``InvP`` precision
  — never bf16/fp16 (types.hpp:18-19);
- apply: ``z[cols_v] = B_v^{-1} r[cols_v]`` for active vertices only
  (ops/hessian.hpp:127-152).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp

from ..linearize import DIAG_MIN, DIAG_MAX, Linearization, _apply_precision
from ..ops.batched_linalg import spd_inverse
from ..ops.blockfmt import flatten_blocks, unflatten_blocks


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockJacobiState:
    blocks: Dict[str, jax.Array]  # (V, d*d) flat pre-damping diagonal blocks
    diag_backup: Dict[str, jax.Array]  # (V, d) pre-damping diagonals
    inv_blocks: Dict[str, jax.Array]  # (V, d*d) flat inverted damped blocks


def compute_block_diagonal(problem, lin: Linearization) -> Dict[str, jax.Array]:
    """Per-vertex diagonal Hessian blocks from scaled Jacobians
    (ops/hessian.hpp:169-268; dL weighting at :258)."""
    inv_dt = problem.precision.inv_dtype
    acc = problem.precision.acc_dtype
    blocks = {
        name: jnp.zeros((vm.count, vm.vtype.dim * vm.vtype.dim),
                        dtype=inv_dt)
        for name, vm in problem.vertex_meta.items()
    }
    for fname, fm in problem.factor_meta.items():
        fa = problem.data.factors[fname]
        J = lin.jacobians[fname]
        if J is None:
            raise ValueError(
                f"block-Jacobi preconditioner requires stored Jacobians; "
                f"factor block '{fname}' is in dynamic mode"
            )
        dL = lin.chi2_deriv[fname].astype(acc)
        E = fm.ftype.residual_dim
        for s, vt in enumerate(fm.ftype.vertex_types):
            Ji = unflatten_blocks(J[s], E, vt.dim).astype(acc)
            PJ = _apply_precision(fa, Ji, acc)
            blk = jnp.einsum(
                "fer,fec->frc", Ji, PJ, preferred_element_type=acc
            ) * dL[:, None, None]
            contrib = jax.ops.segment_sum(
                flatten_blocks(blk), fa.ids[s],
                num_segments=problem.vertex_meta[vt.name].count,
            )
            blocks[vt.name] = blocks[vt.name] + contrib.astype(inv_dt)
    return {name: problem.allreduce(b) for name, b in blocks.items()}


@dataclasses.dataclass(frozen=True)
class BlockJacobiPreconditioner:
    def prepare(self, problem, lin: Linearization, params=None) -> BlockJacobiState:
        blocks = compute_block_diagonal(problem, lin)
        diag_backup = {}
        for name, b in blocks.items():
            d = problem.vertex_meta[name].vtype.dim
            diag_backup[name] = b[:, ::d + 1] if d > 0 else b
        return BlockJacobiState(
            blocks=blocks, diag_backup=diag_backup,
            inv_blocks={n: jnp.zeros_like(b) for n, b in blocks.items()},
        )

    def set_damping(self, problem, lin, state: BlockJacobiState,
                    damping, use_identity) -> BlockJacobiState:
        inv_blocks = {}
        for name, vm in problem.vertex_meta.items():
            dim = vm.vtype.dim
            b = state.blocks[name]
            d0 = state.diag_backup[name]
            if use_identity:
                dd = d0 + damping
            else:
                dd = d0 + damping * jnp.clip(d0, DIAG_MIN, DIAG_MAX)
            damped = b.at[:, ::dim + 1].set(dd)
            damped = unflatten_blocks(damped, dim, dim)
            # Inactive vertices may have all-zero blocks; substitute identity
            # so the batched inverse stays finite (their z entries are never
            # read — apply masks them out).
            active = problem.data.vertices[name].active
            eye = jnp.eye(dim, dtype=b.dtype)
            damped = jnp.where(active[:, None, None], damped, eye)
            inv_blocks[name] = flatten_blocks(spd_inverse(damped))
        return BlockJacobiState(
            blocks=state.blocks, diag_backup=state.diag_backup,
            inv_blocks=inv_blocks,
        )

    def apply(self, problem, lin, state: BlockJacobiState,
              r: jax.Array) -> jax.Array:
        gdt = problem.precision.graph_dtype
        z_rows = {}
        for name, vm in problem.vertex_meta.items():
            if problem.seg_rows[name] == 0:
                continue
            rg = problem.rows_view(r, name)  # (n_rows, d)
            # per-row inverse blocks: gather by the row -> vertex map
            dim = vm.vtype.dim
            inv = unflatten_blocks(
                state.inv_blocks[name][
                    problem.const(("row_vertex", name),
                                  problem.row_vertex[name].astype("int32"))
                ], dim, dim,
            )
            z_rows[name] = jnp.einsum(
                "vrc,vc->vr", inv, rg.astype(inv.dtype),
                preferred_element_type=problem.precision.acc_dtype,
            )
        return problem.flat_from_rows(z_rows, dtype=gdt)
