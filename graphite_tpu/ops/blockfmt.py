"""Flat 2-D storage convention for batches of small matrices.

Convention: every batch of small blocks kept in device memory (Jacobians,
Hessian block groups, Schur blocks, inverted diagonal blocks, precision
matrices) is stored flat 2-D, (N, r*c); compute reshapes transiently
around einsums, which XLA fuses, so a 3-D (N, r, c) form exists only
inside a fusion. Whether the flat layout still pays on the GPU is an open
measurement (ROADMAP §3 item 6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def flatten_blocks(a: jax.Array) -> jax.Array:
    """(N, r, c) -> (N, r*c)."""
    n, r, c = a.shape
    return a.reshape(n, r * c)


def unflatten_blocks(a: jax.Array, r: int, c: int) -> jax.Array:
    """(N, r*c) -> (N, r, c)."""
    return a.reshape(a.shape[0], r, c)


# --------------------------------------------------------------------------
# Fused flat block products
#
# These helpers compute small-block matmuls directly in flat (N, r*c)
# layout as a k-length loop of column repeat/tile multiplies — elementwise
# work that XLA fuses end-to-end (into the gathers that feed it and the
# segment_sum that consumes it), with exact fp32 multiplies (no reduced-
# precision matmul passes), so results match a HIGHEST-precision einsum.
#
# Use for k (the contraction dim) small (<= ~16).
# --------------------------------------------------------------------------


def flat_block_mm_nn(a_flat: jax.Array, b_flat: jax.Array,
                     m: int, k: int, n: int, acc_dtype=None) -> jax.Array:
    """Per-row block product A @ B in flat layout.

    a_flat: (N, m*k) row-major blocks; b_flat: (N, k*n) row-major blocks.
    Returns (N, m*n): out[i, a*n+c] = sum_b A[i, a, b] * B[i, b, c].
    """
    acc_dtype = acc_dtype or jnp.result_type(a_flat.dtype, b_flat.dtype)
    out = None
    for b in range(k):
        a_col = a_flat[:, b::k].astype(acc_dtype)  # (N, m): A[:, :, b]
        b_row = b_flat[:, b * n:(b + 1) * n].astype(acc_dtype)  # (N, n)
        term = (jnp.repeat(a_col, n, axis=1)
                * jnp.tile(b_row, (1, m)))
        out = term if out is None else out + term
    return out


def flat_block_mm_nt(a_flat: jax.Array, b_flat: jax.Array,
                     m: int, k: int, n: int, acc_dtype=None) -> jax.Array:
    """Per-row block product A @ B^T in flat layout.

    a_flat: (N, m*k); b_flat: (N, n*k). Returns (N, m*n):
    out[i, a*n+d] = sum_b A[i, a, b] * B[i, d, b].
    """
    acc_dtype = acc_dtype or jnp.result_type(a_flat.dtype, b_flat.dtype)
    out = None
    for b in range(k):
        a_col = a_flat[:, b::k].astype(acc_dtype)  # (N, m): A[:, :, b]
        b_col = b_flat[:, b::k].astype(acc_dtype)  # (N, n): B[:, :, b]
        term = (jnp.repeat(a_col, n, axis=1)
                * jnp.tile(b_col, (1, m)))
        out = term if out is None else out + term
    return out


def flat_block_mm_tn(a_flat: jax.Array, b_flat: jax.Array,
                     m: int, k: int, n: int, acc_dtype=None) -> jax.Array:
    """Per-row block product A^T @ B in flat layout.

    a_flat: (N, k*m) row-major blocks (k rows, m cols); b_flat: (N, k*n).
    Returns (N, m*n): out[i, a*n+c] = sum_e A[i, e, a] * B[i, e, c].
    The J^T P J shape: contraction over the residual dim (k = E, small).
    """
    acc_dtype = acc_dtype or jnp.result_type(a_flat.dtype, b_flat.dtype)
    out = None
    for e in range(k):
        a_row = a_flat[:, e * m:(e + 1) * m].astype(acc_dtype)  # A[:, e, :]
        b_row = b_flat[:, e * n:(e + 1) * n].astype(acc_dtype)  # B[:, e, :]
        term = (jnp.repeat(a_row, n, axis=1)
                * jnp.tile(b_row, (1, m)))
        out = term if out is None else out + term
    return out


def flat_block_mv(a_flat: jax.Array, x: jax.Array, m: int, k: int,
                  acc_dtype=None) -> jax.Array:
    """Per-row block matvec A @ x in flat layout.

    a_flat: (N, m*k) row-major blocks; x: (N, k). Returns (N, m):
    out[n, r] = sum_c A[n, r, c] * x[n, c].

    Small-k blocks stay pure 2-D elementwise work (k strided column
    slices of the flat storage, each a (N, m) FMA) with no relayout of
    the operand.
    """
    acc_dtype = acc_dtype or jnp.result_type(a_flat.dtype, x.dtype)
    if k > 16:
        a3 = a_flat.reshape(a_flat.shape[0], m, k).astype(acc_dtype)
        return jnp.einsum("nmk,nk->nm", a3, x.astype(acc_dtype))
    x = x.astype(acc_dtype)
    out = None
    for c in range(k):
        term = a_flat[:, c::k].astype(acc_dtype) * x[:, c:c + 1]
        out = term if out is None else out + term
    return out


def flat_block_mv_t(a_flat: jax.Array, x: jax.Array, m: int, k: int,
                    acc_dtype=None) -> jax.Array:
    """Per-row transposed block matvec A^T @ x in flat layout.

    a_flat: (N, m*k) row-major blocks (m rows, k cols); x: (N, m).
    Returns (N, k): out[n, c] = sum_r A[n, r, c] * x[n, r].
    Pure 2-D elementwise work for small m (contiguous column slices); see
    flat_block_mv.
    """
    acc_dtype = acc_dtype or jnp.result_type(a_flat.dtype, x.dtype)
    if m > 16:
        a3 = a_flat.reshape(a_flat.shape[0], m, k).astype(acc_dtype)
        return jnp.einsum("nmk,nm->nk", a3, x.astype(acc_dtype))
    x = x.astype(acc_dtype)
    out = None
    for r in range(m):
        term = (a_flat[:, r * k:(r + 1) * k].astype(acc_dtype)
                * x[:, r:r + 1])
        out = term if out is None else out + term
    return out
