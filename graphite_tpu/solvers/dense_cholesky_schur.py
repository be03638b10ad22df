"""Dense Cholesky on the Schur (pose) system + landmark back-substitution.

Small-problem analog of the reference's Schur direct solvers
(``cudssSchurSolver``/``EigenSchurLDLTSolver``, cudss_schur.hpp:13-235,
eigen_schur.hpp:14-109): factorize only the pose system, then
back-substitute landmarks.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
)
from ..linearize import Linearization
from ..schur import SchurOps, build_schur_structure, schur_values
from .pcg_schur import SchurSolverState


# above this pose-block count the dense interleave runs in slabs, which
# bounds the transient of the one-shot 4-D transpose
_DENSE_INTERLEAVE_NPB = 512


def schur_to_dense(problem, ss, sv) -> jax.Array:
    """Dense S (dim_p x dim_p) from grouped block values.

    Fast path (single pose block dim): blocks land on a dense
    (n_pose^2, d*d) pair grid via one inverse-permutation GATHER (each pair
    has at most one block), then a reshape/transpose lays out the matrix —
    no scalar scatters. Symmetrized as S = T + (T - T_bdiag)^T since block
    storage is upper-triangular.
    """
    n = ss.dim_p
    inv_dt = problem.precision.inv_dtype
    dims = set(int(d) for d in ss.pose_dims)
    if len(dims) == 1 and len(ss.s_keys) == 1:
        d = dims.pop()
        key = ss.s_keys[0]
        npb = ss.n_pose_blocks
        cache_key = "schur_dense_map"
        if cache_key not in problem._cache:
            ns_g = ss.s_sizes[key]
            pair = ss.s_rows[key] * npb + ss.s_cols[key]
            inv = np.full(npb * npb, ns_g, dtype=np.int32)
            inv[pair] = np.arange(ns_g, dtype=np.int32)
            # transposed-copy gather: block (i,j) also receives block
            # (j,i)^T; diagonal pairs point at the zero row so no mask is
            # needed at apply time
            inv_t = inv.reshape(npb, npb).T.reshape(-1).copy()
            inv_t[np.arange(npb) * npb + np.arange(npb)] = ns_g
            problem._cache[cache_key] = (inv, inv_t)
        inv, inv_t = problem._cache[cache_key]
        s_pad = jnp.concatenate(
            [sv.s_vals[key].astype(inv_dt),
             jnp.zeros((1, d * d), dtype=inv_dt)], axis=0
        )
        perm = np.arange(d * d).reshape(d, d).T.reshape(-1)
        if npb <= _DENSE_INTERLEAVE_NPB:
            full = (s_pad[jnp.asarray(inv)]
                    + s_pad[jnp.asarray(inv_t)][:, jnp.asarray(perm)])
            return (full.reshape(npb, npb, d, d)
                    .transpose(0, 2, 1, 3).reshape(n, n))

        # Large pose counts: build slab-by-slab. Gathering the full
        # (npb^2, d*d) pair grid plus its transposed copy materializes
        # ~3 GB of transients at Venice-1778 scale; per-slab gathers keep
        # the peak at the (n, n) output + one ~(c*npb, d*d) slab.
        c = max(1, 512 // d)  # block-rows per slab
        npb_pad = -(-npb // c) * c
        inv_p = problem.const(
            ("schur_dense_inv",),
            np.concatenate([inv, np.full((npb_pad - npb) * npb,
                                         ss.s_sizes[key], np.int32)]))
        inv_tp = problem.const(
            ("schur_dense_inv_t",),
            np.concatenate([inv_t, np.full((npb_pad - npb) * npb,
                                           ss.s_sizes[key], np.int32)]))
        perm_c = jnp.asarray(perm)

        def interleave(i0):
            sel = i0 * npb + jnp.arange(c * npb)
            slab = (s_pad[inv_p[sel]]
                    + s_pad[inv_tp[sel]][:, perm_c])
            return (slab.reshape(c, npb, d, d).transpose(0, 2, 1, 3)
                    .reshape(c * d, n))

        out = jax.lax.map(
            interleave,
            jnp.asarray(np.arange(0, npb_pad, c, dtype=np.int64)))
        return out.reshape(npb_pad * d, n)[:n]

    # General fallback: scalar scatter (small problems / mixed pose dims).
    offsets = problem.block_offsets
    S = jnp.zeros((n, n), dtype=inv_dt)
    for key in ss.s_keys:
        dr, dc = key
        rows, cols = ss.s_rows[key], ss.s_cols[key]
        rr = offsets[rows][:, None, None] + np.arange(dr)[None, :, None]
        cc = offsets[cols][:, None, None] + np.arange(dc)[None, None, :]
        flat = rr * n + cc  # (K, dr, dc)
        from ..ops.blockfmt import unflatten_blocks

        v = unflatten_blocks(sv.s_vals[key], dr, dc).astype(S.dtype)
        S = S.reshape(-1).at[jnp.asarray(flat).reshape(-1)].add(
            v.reshape(-1)).reshape(n, n)
        off = rows != cols
        if np.any(off):
            o = np.nonzero(off)[0]
            flat_t = (cc[o].swapaxes(-1, -2) * n
                      + rr[o].swapaxes(-1, -2))
            S = S.reshape(-1).at[jnp.asarray(flat_t).reshape(-1)].add(
                jnp.swapaxes(v[jnp.asarray(o)], -1, -2).reshape(-1)
            ).reshape(n, n)
    return S


@dataclasses.dataclass(frozen=True)
class DenseCholeskySchurSolver:
    # solve() reads only lin.b / lin.diag -> slim LM carry
    slim_carry = True

    def prepare(self, problem, lin: Linearization, params=None):
        hs = build_hessian_structure(problem)
        build_schur_structure(problem)
        return SchurSolverState(hvals=compute_hessian_values(problem, hs, lin))

    def solve(self, problem, lin: Linearization, state, damping,
              use_identity: bool, params=None):
        gdt = problem.precision.graph_dtype
        hs = build_hessian_structure(problem)
        ss = build_schur_structure(problem)
        hv = apply_damping(problem, hs, state.hvals, lin.diag, damping,
                           use_identity)
        sv = schur_values(problem, ss, hv)
        ops = SchurOps(problem, ss, hv, sv)
        b_s = ops.b_schur(lin.b)

        S = schur_to_dense(problem, ss, sv)
        if ss.dim_p >= 1024:
            # recursive blocked factorization: keeps all panel work as
            # large matmuls (see ops/blocked_cholesky.py)
            from ..ops.blocked_cholesky import (
                blocked_cho_solve, blocked_cholesky)

            L = blocked_cholesky(S)
            dx_p = blocked_cho_solve(L, b_s.astype(S.dtype))
        else:
            L, low = jax.scipy.linalg.cho_factor(S, lower=True)
            dx_p = jax.scipy.linalg.cho_solve((L, low), b_s.astype(S.dtype))
        ok = jnp.all(jnp.isfinite(dx_p))
        dx_p = jnp.where(ok, dx_p, 0.0).astype(gdt)
        dx_l_rows = ops.landmark_update(lin.b, dx_p)
        return ops.compose_delta(dx_p, dx_l_rows), ok
