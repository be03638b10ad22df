"""Direct solver on the FULL system H dx = b.

Two paths, mirroring the reference's two full-matrix direct solvers:

- **On-device** (``cudssSolver`` analog, cudss.hpp:53-269): block values
  are densified into (dim_h, dim_h) and factorized by the recursive
  blocked Cholesky (ops/blocked_cholesky.py), the matrix resident in
  device memory, while the dense storage fits (``on_device_limit``); the
  nested-dissection multifrontal factorization (ops/nd_multifrontal.py)
  factorizes on the device at any size.
- **Host callback** (the default; ``EigenLDLTSolver`` analog,
  eigen.hpp:12-99, src/eigen_solver.cpp:8-103): scalar CSC values are
  assembled on device (one scatter) and factorized host-side with
  scipy's sparse LU per solve — exactly the reference's
  CPU-copy-per-iteration design (eigen.hpp:41-44).

Failure semantics: non-finite solve => ok=False => LM rejects the step
(levenberg_marquardt.hpp:181-183).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..hessian import (
    apply_damping,
    build_hessian_structure,
    compute_hessian_values,
    csc_values,
)
from ..linearize import Linearization
from ..ops.chunked import device_bytes_limit


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SparseDirectState:
    hvals: dict


def _host_sparse_solve(indptr, indices, dim):
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    def solve(values, b):
        out_dtype = np.asarray(b).dtype  # match the callback signature
        values = np.asarray(values, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        A = sp.csc_matrix((values, indices, indptr), shape=(dim, dim))
        try:
            lu = spla.splu(A.tocsc())
            x = lu.solve(b)
        except Exception:
            x = np.full(dim, np.nan)
        return x.astype(out_dtype)

    return solve


# Dense flat offsets r*n+c are int32: dim_h**2 < 2**31.
_INDEX_CEILING = 46_340


@dataclasses.dataclass(frozen=True)
class SparseDirectSolver:
    # solve() reads only lin.b / lin.diag -> slim LM carry
    slim_carry = True
    # Host callback by default. Measured at Ladybug size (dim_h 23,769)
    # on an H100 80GB HBM3 (two runs, power limits 400 W and 700 W): the
    # on-device dense Cholesky solves in 192-226 ms against 305-348 ms for
    # the host splu, but compiles for 69 s cold (7 s from a warm compile
    # cache) against 1.3-1.6 s, so a 50-iteration run is no faster on the
    # device even with a warm cache and much slower without one. True
    # factorizes on the device.
    on_device: bool = False
    # Above this dim_h the dense on-device factorization is skipped.
    # None: the largest dim_h whose dense matrix and factor take at most a
    # quarter of the device's memory (capped by the int32 index ceiling).
    on_device_limit: Optional[int] = None
    # True: nested-dissection multifrontal factorization on the device
    # (ops/nd_multifrontal.py; the analog of cuDSS's sparse factorization
    # at any size, cudss.hpp:53-269).
    multifrontal: bool = False

    def _dense_limit(self, problem) -> int:
        if self.on_device_limit is not None:
            return self.on_device_limit
        limit = device_bytes_limit()
        if limit is None:
            return _INDEX_CEILING
        itemsize = jnp.dtype(problem.precision.inv_dtype).itemsize
        return min(_INDEX_CEILING, math.isqrt(limit // (8 * itemsize)))

    def prepare(self, problem, lin: Linearization, params=None):
        hs = build_hessian_structure(problem)
        return SparseDirectState(
            hvals=compute_hessian_values(problem, hs, lin)
        )

    def solve(self, problem, lin: Linearization, state, damping,
              use_identity: bool, params=None):
        gdt = problem.precision.graph_dtype
        hs = build_hessian_structure(problem)
        hv = apply_damping(problem, hs, state.hvals, lin.diag, damping,
                           use_identity)

        if self.multifrontal:
            from ..ops.nd_multifrontal import (
                build_nd_plan,
                nd_factor,
                nd_solve,
            )

            if "nd_plan" not in problem._cache:
                problem._cache["nd_plan"] = build_nd_plan(problem, hs)
            plan = problem._cache["nd_plan"]
            inv_dt = problem.precision.inv_dtype
            factors = nd_factor(problem, plan, hv, dtype=inv_dt)
            x = nd_solve(problem, plan, factors,
                         lin.b[: problem.dim_h])
            ok = jnp.all(jnp.isfinite(x))
            x = jnp.where(ok, x, 0.0).astype(gdt)
            out = jnp.zeros(problem.dim_x, dtype=gdt)
            out = out.at[: problem.dim_h].set(x)
            return out, ok

        if self.on_device and problem.dim_h <= self._dense_limit(problem):
            from ..hessian import dense_hessian_matrix

            H = dense_hessian_matrix(problem, hs, hv)
            b = lin.b[: problem.dim_h].astype(H.dtype)
            if problem.dim_h >= 1024:
                from ..ops.blocked_cholesky import (
                    blocked_cho_solve,
                    blocked_cholesky,
                )

                L = blocked_cholesky(H)
                x = blocked_cho_solve(L, b)
            else:
                L, low = jax.scipy.linalg.cho_factor(H, lower=True)
                x = jax.scipy.linalg.cho_solve((L, low), b)
            ok = jnp.all(jnp.isfinite(x))
            x = jnp.where(ok, x, 0.0).astype(gdt)
            out = jnp.zeros(problem.dim_x, dtype=gdt)
            out = out.at[: problem.dim_h].set(x)
            return out, ok

        vals = csc_values(problem, hs, hv).astype(gdt)
        b = lin.b[: problem.dim_h].astype(gdt)
        solve = _host_sparse_solve(hs.csc_indptr, hs.csc_indices,
                                   problem.dim_h)
        x = jax.pure_callback(
            solve,
            jax.ShapeDtypeStruct((problem.dim_h,), gdt),
            vals, b,
        )
        ok = jnp.all(jnp.isfinite(x))
        x = jnp.where(ok, x, 0.0).astype(gdt)
        out = jnp.zeros(problem.dim_x, dtype=gdt).at[: problem.dim_h].set(x)
        return out, ok
