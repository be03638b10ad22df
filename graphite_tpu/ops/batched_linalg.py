"""Batched small-block dense linear algebra.

JAX replacement for cuBLAS ``matinvBatched`` on <=32x32 diagonal
blocks (reference: preconditioner/block_jacobi.hpp:152-167,
schur.hpp:1067-1114). Blocks here are SPD (they are J^T P J + LM damping), so
closed forms (d<=3) / batched Cholesky are used instead of LU (Cholesky
is cheaper for SPD blocks). Inversions always run in ``InvP`` precision (never bf16/fp16,
types.hpp:18-19).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def spd_inverse(blocks: jax.Array) -> jax.Array:
    """Invert a batch of small SPD matrices, shape (..., d, d)."""
    d = blocks.shape[-1]
    if d == 1:
        return 1.0 / blocks
    if d == 2:
        a = blocks[..., 0, 0]
        b = blocks[..., 0, 1]
        c = blocks[..., 1, 0]
        e = blocks[..., 1, 1]
        det = a * e - b * c
        inv_det = 1.0 / det
        row0 = jnp.stack([e, -b], axis=-1)
        row1 = jnp.stack([-c, a], axis=-1)
        return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]
    if d == 3:
        m = blocks
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = (m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02)
        inv_det = 1.0 / det
        adj = jnp.stack(
            [
                jnp.stack([c00, c10, c20], axis=-1),
                jnp.stack([c01, c11, c21], axis=-1),
                jnp.stack([c02, c12, c22], axis=-1),
            ],
            axis=-2,
        )
        return adj * inv_det[..., None, None]
    # General path: batched Cholesky solve against identity.
    chol = jnp.linalg.cholesky(blocks)
    eye = jnp.broadcast_to(
        jnp.eye(d, dtype=blocks.dtype), blocks.shape
    )
    y = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), y, lower=False
    )


def spd_inverse_flat(flat: jax.Array, d: int) -> jax.Array:
    """`spd_inverse` on FLAT 2-D block storage: (N, d*d) -> (N, d*d).

    For d <= 3 the closed form runs entirely on column slices of the flat
    array — no (N, d, d) view ever exists, so it reads and writes
    2 x d*d values per block (ops/blockfmt.py invariant). Reference:
    schur.hpp:1067-1114.
    """
    if d == 1:
        return 1.0 / flat
    if d == 2:
        a, b = flat[:, 0], flat[:, 1]
        c, e = flat[:, 2], flat[:, 3]
        inv_det = 1.0 / (a * e - b * c)
        return jnp.stack(
            [e * inv_det, -b * inv_det, -c * inv_det, a * inv_det], axis=1)
    if d == 3:
        m = [flat[:, i] for i in range(9)]
        c00 = m[4] * m[8] - m[5] * m[7]
        c01 = m[5] * m[6] - m[3] * m[8]
        c02 = m[3] * m[7] - m[4] * m[6]
        c10 = m[2] * m[7] - m[1] * m[8]
        c11 = m[0] * m[8] - m[2] * m[6]
        c12 = m[1] * m[6] - m[0] * m[7]
        c20 = m[1] * m[5] - m[2] * m[4]
        c21 = m[2] * m[3] - m[0] * m[5]
        c22 = m[0] * m[4] - m[1] * m[3]
        inv_det = 1.0 / (m[0] * c00 + m[1] * c01 + m[2] * c02)
        # adjugate rows in row-major flat order (note the transpose)
        cols = [c00, c10, c20, c01, c11, c21, c02, c12, c22]
        return jnp.stack([c * inv_det for c in cols], axis=1)
    n = flat.shape[0]
    return spd_inverse(flat.reshape(n, d, d)).reshape(n, d * d)


def spd_solve(blocks: jax.Array, rhs: jax.Array) -> jax.Array:
    """Solve a batch of small SPD systems; rhs shape (..., d)."""
    return jnp.einsum(
        "...rc,...c->...r", spd_inverse(blocks), rhs,
    )
