"""Generic chunked execution over a leading axis via lax.scan.

At multi-million-row scale a single fused batch of block products can
exceed device memory by itself, and a Python loop of chunk ops lets XLA
keep every chunk's temp alive simultaneously. The scan helpers serialize
the chunks with one shared temp buffer:

- ``accumulate``: body folds each chunk into a carry (segmented reductions);
- ``map``: bodies produce per-chunk outputs, restacked to (K, ...).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp


def device_bytes_limit(device=None) -> Optional[int]:
    """Bytes the allocator of ``device`` (default: the first device) may
    hand out, or None where the backend reports no limit (the CPU)."""
    stats = (device or jax.devices()[0]).memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def _pad_reshape(a: jax.Array, chunk: int, n: int, fill=0):
    n_pad = (-n) % chunk
    if n_pad:
        a = jnp.concatenate(
            [a, jnp.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)]
        )
    return a.reshape((n + n_pad) // chunk, chunk, *a.shape[1:])


def scan_accumulate(body: Callable, arrays: Sequence[jax.Array], n: int,
                    chunk: int, carry_init, fills=None):
    """carry = fold(body, chunks). ``body(carry, chunk_arrays) -> carry``.

    ``arrays`` share leading dim ``n``; padding rows are filled with
    ``fills[i]`` (default 0 — point masked work at a trash segment).
    """
    fills = fills or [0] * len(arrays)
    xs = tuple(
        _pad_reshape(a, chunk, n, fill) for a, fill in zip(arrays, fills)
    )

    def step(carry, chunk_arrays):
        return body(carry, chunk_arrays), None

    carry, _ = jax.lax.scan(step, carry_init, xs)
    return carry


def scan_map(body: Callable, arrays: Sequence[jax.Array], n: int,
             chunk: int, fills=None) -> jax.Array:
    """out (n, ...) = concat(body(chunk_arrays) for chunks). Output per
    chunk must be (chunk, ...)."""
    fills = fills or [0] * len(arrays)
    xs = tuple(
        _pad_reshape(a, chunk, n, fill) for a, fill in zip(arrays, fills)
    )

    def step(_, chunk_arrays):
        return None, body(chunk_arrays)

    _, ys = jax.lax.scan(step, None, xs)
    return ys.reshape(ys.shape[0] * ys.shape[1], *ys.shape[2:])[:n]
