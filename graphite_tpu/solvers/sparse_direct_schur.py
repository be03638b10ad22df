"""Direct solve of the Schur (pose) system + landmark backsub.

JAX analog of ``cudssSchurSolver``/``EigenSchurLDLTSolver``
(reference: cudss_schur.hpp:13-235, eigen_schur.hpp:14-109). Two paths:

- ``dim_p <= on_device_dim_p`` (default 20k, i.e. every published BAL
  problem): the reduced pose system is factorized **on device** with the
  recursive blocked Cholesky (ops/blocked_cholesky.py) — the analog of
  cuDSS factorizing on-GPU (cudss_schur.hpp:190-233), with zero host
  round-trips per LM iteration.
- larger systems: host SciPy sparse factorization via ``pure_callback``
  (the Eigen-solver CPU-copy-per-iteration pattern, eigen.hpp:41-44).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

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
from .sparse_direct import _host_sparse_solve


def _schur_csc(problem, ss):
    """Scalar full-symmetric CSC structure for S + per-group scatter maps."""
    if "schur_csc" in problem._cache:
        return problem._cache["schur_csc"]
    offsets = problem.block_offsets
    dim_p = ss.dim_p
    rows_all, cols_all = [], []
    spans = []  # (key, k, transposed)
    for key in ss.s_keys:
        dr, dc = key
        for k in range(ss.s_sizes[key]):
            r, c = int(ss.s_rows[key][k]), int(ss.s_cols[key][k])
            rr = np.repeat(np.arange(dr), dc) + offsets[r]
            cc = np.tile(np.arange(dc), dr) + offsets[c]
            rows_all.append(rr)
            cols_all.append(cc)
            spans.append((key, k, False))
            if r != c:
                rows_all.append(cc)
                cols_all.append(rr)
                spans.append((key, k, True))
    rows_cat = np.concatenate(rows_all)
    cols_cat = np.concatenate(cols_all)
    order = np.lexsort((rows_cat, cols_cat))
    nnz = rows_cat.shape[0]
    indices = rows_cat[order]
    counts = np.bincount(cols_cat, minlength=dim_p)
    indptr = np.zeros(dim_p + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    pos_of = np.empty(nnz, dtype=np.int64)
    pos_of[order] = np.arange(nnz)

    dst: Dict[Tuple[int, int], np.ndarray] = {
        key: np.zeros((ss.s_sizes[key], key[0], key[1]), dtype=np.int64)
        for key in ss.s_keys
    }
    dst_t: Dict[Tuple[int, int], np.ndarray] = {
        key: np.full((ss.s_sizes[key], key[0], key[1]), nnz, dtype=np.int64)
        for key in ss.s_keys
    }
    cursor = 0
    for key, k, transposed in spans:
        dr, dc = key
        n = dr * dc
        target = dst_t if transposed else dst
        target[key][k] = pos_of[cursor:cursor + n].reshape(dr, dc)
        cursor += n
    out = dict(indptr=indptr, indices=indices, nnz=nnz, dst=dst, dst_t=dst_t)
    problem._cache["schur_csc"] = out
    return out


@dataclasses.dataclass(frozen=True)
class SparseDirectSchurSolver:
    # solve() reads only lin.b / lin.diag -> slim LM carry
    slim_carry = True
    # Pose systems at or below this size are factorized on device as a
    # dense blocked Cholesky (no host callback); 0 forces the host path.
    on_device_dim_p: int = 20_000

    def prepare(self, problem, lin: Linearization, params=None):
        hs = build_hessian_structure(problem)
        build_schur_structure(problem)
        return SchurSolverState(
            hvals=compute_hessian_values(problem, hs, lin))

    def solve(self, problem, lin: Linearization, state, damping,
              use_identity: bool, params=None):
        gdt = problem.precision.graph_dtype
        hs = build_hessian_structure(problem)
        ss = build_schur_structure(problem)

        hv = apply_damping(problem, hs, state.hvals, lin.diag, damping,
                           use_identity)
        sv = schur_values(problem, ss, hv)
        ops = SchurOps(problem, ss, hv, sv)
        b_s = ops.b_schur(lin.b).astype(gdt)

        if ss.dim_p <= self.on_device_dim_p:
            from ..ops.blocked_cholesky import cholesky_solve
            from .dense_cholesky_schur import schur_to_dense

            S = schur_to_dense(problem, ss, sv)
            dx_p = cholesky_solve(S, b_s.astype(S.dtype))
            ok = jnp.all(jnp.isfinite(dx_p))
            dx_p = jnp.where(ok, dx_p, 0.0).astype(gdt)
            dx_l_rows = ops.landmark_update(lin.b, dx_p)
            return ops.compose_delta(dx_p, dx_l_rows), ok

        csc = _schur_csc(problem, ss)
        vals = jnp.zeros(csc["nnz"] + 1, dtype=gdt)
        for key in ss.s_keys:
            v = sv.s_vals[key].astype(gdt)  # already flat (n, dr*dc)
            vals = vals.at[jnp.asarray(csc["dst"][key]).reshape(-1)].add(
                v.reshape(-1)
            )
            vals = vals.at[jnp.asarray(csc["dst_t"][key]).reshape(-1)].add(
                v.reshape(-1)
            )
        solve = _host_sparse_solve(csc["indptr"], csc["indices"], ss.dim_p)
        dx_p = jax.pure_callback(
            solve,
            jax.ShapeDtypeStruct((ss.dim_p,), gdt),
            vals[: csc["nnz"]], b_s,
        )
        ok = jnp.all(jnp.isfinite(dx_p))
        dx_p = jnp.where(ok, dx_p, 0.0).astype(gdt)
        dx_l_rows = ops.landmark_update(lin.b, dx_p)
        return ops.compose_delta(dx_p, dx_l_rows), ok
