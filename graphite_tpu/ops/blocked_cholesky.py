"""On-device blocked Cholesky factorization + triangular solves.

JAX replacement for the reference's on-GPU sparse direct
factorization of the *reduced pose system* (cudss_schur.hpp:190-233):
after Schur elimination the pose system is small (dim_p = 9·#cameras in
BAL) and effectively dense, so a dense blocked Cholesky on the device
replaces a host-callback sparse factorization per LM iteration (the
Eigen-solver pattern, eigen.hpp:41-44). Whether XLA's own
`jnp.linalg.cholesky` (cuSOLVER on the GPU) is as fast is an open
measurement (ROADMAP §3 item 5).

Design: statically-shaped divide-and-conquer ("recursive blocked",
right-looking at every level):

    [A11 A12]      L11 = chol(A11)
    [A21 A22]  ->  L21 = A21 · L11^-T          (triangular solve, matmuls)
                   L22 = chol(A22 - L21·L21^T) (SYRK)

The recursion unrolls at trace time (shapes static, depth log2(n/base)),
so everything between base-case factorizations is a large matmul, at
exactly n^3/3 FLOPs. The triangular solves use the same
divide-and-conquer so no large `solve_triangular` ever reaches XLA's
serial path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

# Base-case size: small enough that XLA's native cholesky/trsm panels are
# cheap, large enough that recursion depth and op count stay small.
_BASE = 256


def _split(n: int) -> int:
    """Static split point: half, rounded up to a 128-lane multiple."""
    half = (n + 1) // 2
    return min(n - 1, ((half + 127) // 128) * 128) if n > 128 else n // 2


def _trsm_rlt(B, L, base: int):
    """Solve X · L^T = B for X, with L lower-triangular (k, k), B (m, k).

    Divide-and-conquer on the columns of B / blocks of L; base case hits
    XLA's solve_triangular on a (base, base) triangle only.
    """
    k = L.shape[-1]
    if k <= base:
        return solve_triangular(L, B.T, lower=True).T.astype(B.dtype)
    s = _split(k)
    L1 = L[:s, :s]
    L2 = L[s:, :s]
    L3 = L[s:, s:]
    X1 = _trsm_rlt(B[:, :s], L1, base)
    rhs = B[:, s:] - jnp.matmul(X1, L2.T,
                                preferred_element_type=jnp.float32
                                if B.dtype == jnp.float32 else None)
    X2 = _trsm_rlt(rhs.astype(B.dtype), L3, base)
    return jnp.concatenate([X1, X2], axis=1)


def blocked_cholesky(A, base: int = _BASE):
    """Lower-triangular L with L·L^T = A (A symmetric positive definite).

    Returns NaNs where `jnp.linalg.cholesky` would (non-SPD input) so the
    solver's ok=False → rejected-step contract is preserved
    (levenberg_marquardt.hpp:181-183).
    """
    n = A.shape[-1]
    if n <= base:
        return jnp.linalg.cholesky(A)
    s = _split(n)
    L11 = blocked_cholesky(A[:s, :s], base)
    L21 = _trsm_rlt(A[s:, :s], L11, base)
    pet = jnp.float32 if A.dtype == jnp.float32 else None
    A22 = A[s:, s:] - jnp.matmul(L21, L21.T, preferred_element_type=pet)
    L22 = blocked_cholesky(A22.astype(A.dtype), base)
    top = jnp.concatenate(
        [L11, jnp.zeros((s, n - s), dtype=A.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _trsv_lower(L, b, base: int):
    """Solve L · x = b (L lower-triangular)."""
    n = L.shape[-1]
    if n <= base:
        return solve_triangular(L, b, lower=True)
    s = _split(n)
    x1 = _trsv_lower(L[:s, :s], b[:s], base)
    x2 = _trsv_lower(L[s:, s:], b[s:] - L[s:, :s] @ x1, base)
    return jnp.concatenate([x1, x2])


def _trsv_lower_t(L, b, base: int):
    """Solve L^T · x = b (L lower-triangular)."""
    n = L.shape[-1]
    if n <= base:
        return solve_triangular(L, b, lower=True, trans=1)
    s = _split(n)
    x2 = _trsv_lower_t(L[s:, s:], b[s:], base)
    x1 = _trsv_lower_t(L[:s, :s], b[:s] - L[s:, :s].T @ x2, base)
    return jnp.concatenate([x1, x2])


def blocked_cho_solve(L, b, base: int = _BASE):
    """Solve (L·L^T) x = b given the blocked_cholesky factor."""
    return _trsv_lower_t(L, _trsv_lower(L, b, base), base)


def cholesky_solve(A, b, base: int = _BASE):
    """Factor + solve in one call: x with A x = b (A SPD)."""
    L = blocked_cholesky(A, base)
    return blocked_cho_solve(L, b, base)
