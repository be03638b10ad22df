"""Block-Jacobi preconditioner on the Schur system.

JAX analog of ``BlockJacobiSchurPreconditioner``
(reference: preconditioner/block_jacobi_schur.hpp:16-179): gathers the
diagonal blocks of S (grouped per pose vertex type), inverts them batched,
applies a batched block matvec in row form. Damping is a no-op because the
Schur values are built from the already-damped Hessian (:153-155).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.batched_linalg import spd_inverse
from ..ops.blockfmt import flatten_blocks, unflatten_blocks


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockJacobiSchurState:
    inv_blocks: Dict[str, jax.Array]  # pose type -> (n_rows, d*d) flat


def _pose_type_rows(problem, ss):
    """Per pose type: S-diagonal block index per row (cached)."""
    cache = problem._cache
    if "bjs_rows" not in cache:
        out = {}
        pose_ids = np.arange(ss.n_pose_blocks)
        types = np.asarray(ss.block_type)[pose_ids]
        for t in np.unique(types):
            sel = pose_ids[types == t]
            rows = ss.block_row[sel]
            order = np.argsort(rows, kind="stable")
            sel = sel[order]
            keys = ss.s_diag_key[sel]
            assert np.all(keys >= 0), "pose block without an S diagonal block"
            assert np.all(keys == keys[0])
            key = ss.s_keys[int(keys[0])]
            out[str(t)] = (key, ss.s_diag_idx[sel].astype(np.int32))
        cache["bjs_rows"] = out
    return cache["bjs_rows"]


@dataclasses.dataclass(frozen=True)
class BlockJacobiSchurPreconditioner:
    def prepare(self, problem, ss, sv) -> BlockJacobiSchurState:
        inv_blocks = {}
        for t, (key, idxs) in _pose_type_rows(problem, ss).items():
            gathered = unflatten_blocks(
                sv.s_vals[key][problem.const(("bjs_idx", t), idxs)],
                key[0], key[1],
            )
            inv_blocks[t] = flatten_blocks(spd_inverse(gathered))
        return BlockJacobiSchurState(inv_blocks=inv_blocks)

    def apply(self, problem, ss, state: BlockJacobiSchurState,
              y: jax.Array) -> jax.Array:
        gdt = problem.precision.graph_dtype
        z_rows = {}
        for t in state.inv_blocks:
            d = problem.vertex_meta[t].vtype.dim
            inv = unflatten_blocks(state.inv_blocks[t], d, d)
            yg = problem.rows_view(y, t).astype(inv.dtype)
            z_rows[t] = jnp.einsum(
                "krc,kc->kr", inv, yg,
                preferred_element_type=problem.precision.acc_dtype,
            )
        return problem.flat_from_rows(z_rows, dtype=gdt)[: ss.dim_p]


@dataclasses.dataclass(frozen=True)
class IdentitySchurPreconditioner:
    def prepare(self, problem, ss, sv):
        return ()

    def apply(self, problem, ss, state, y):
        return y
