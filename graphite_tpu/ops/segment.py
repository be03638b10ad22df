"""Deterministic scatter-reduction helpers.

JAX replacement for the reference's ``atomicAdd`` scatters into ``b``,
Hessian blocks and J^T v outputs (ops/linearize.hpp:302, ops/hessian.hpp:76,
ops/product.hpp:287). On the GPU XLA lowers ``segment_sum`` to atomic adds,
so, as in the reference (whose chi2/atomics are explicitly
non-deterministic, levenberg_marquardt.hpp:372), float sums can differ in
the last bits from run to run; on the CPU the order is fixed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def scatter_add_flat(values: jax.Array, cols: jax.Array, size: int) -> jax.Array:
    """Sum ``values`` into a flat vector at ``cols`` (both any shape)."""
    return jax.ops.segment_sum(
        values.reshape(-1), cols.reshape(-1).astype(jnp.int32), num_segments=size
    )


def scatter_add_into(out: jax.Array, values: jax.Array, cols: jax.Array) -> jax.Array:
    """``out`` += scatter of ``values`` at ``cols``."""
    return out.at[cols.reshape(-1)].add(
        values.reshape(-1), mode="drop", unique_indices=False
    )


def col_indices(cols_base: jax.Array, dim: int) -> jax.Array:
    """Expand per-row first-column offsets (F,) to (F, dim) column indices."""
    return cols_base[:, None] + jnp.arange(dim, dtype=cols_base.dtype)[None, :]
