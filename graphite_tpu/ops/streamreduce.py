"""Row gathers and segmented reductions shared by the hot stages.

Every reduction site in linearize / hessian / schur turns (K, D) product
rows into (num_segments, D) destination rows with one XLA segment_sum.
Reference parity: these are the reference's atomicAdd scatters
(ops/linearize.hpp:302, ops/hessian.hpp:76, ops/schur.hpp:190-263); on the
GPU XLA lowers segment_sum to the same atomic adds, so the summation order
(and the last bits of a float32 sum) can change from run to run.
"""

from __future__ import annotations

import jax
import numpy as np

from .chunked import scan_map

# Byte budget for scan_map product chunks feeding a reduction (bounds each
# step's gathered-row transient).
MAP_BYTES = 64 << 20


def map_chunk_rows(row_bytes: int, align: int = 2048) -> int:
    rows = max(MAP_BYTES // max(row_bytes, 1), align)
    return (rows // align) * align


def mapped_rows(body, arrays, k: int, row_bytes: int):
    """body(arrays) -> (k, D) rows, scan-chunked above the byte budget so
    gather transients stay bounded."""
    chunk = map_chunk_rows(row_bytes)
    if k <= chunk:
        return body(arrays)
    return scan_map(body, arrays, k, chunk)


def maybe_rows(problem, tag, arr, idx: np.ndarray):
    """arr[idx] with identity gathers eliminated: CSC-ordered structures
    make many hot index arrays exactly iota, and reading the array itself
    costs nothing.

    Prefix-iota counts too: Hessian value groups carry one trailing TRASH
    row (masking-not-compaction, graph.py), so ``arange(n)`` into an
    (n+1)-row array is the common shape — a free ``arr[:n]`` slice, not a
    gather."""
    idx = np.asarray(idx)
    ident = problem._cache.setdefault("identity_idx", {})
    if tag not in ident:
        ident[tag] = bool(
            arr.shape[0] >= idx.shape[0]
            and (idx.size == 0
                 or (idx[0] == 0 and idx[-1] == idx.size - 1
                     and np.array_equal(
                         idx, np.arange(idx.size, dtype=idx.dtype))))
        )
    if ident[tag]:
        return arr if arr.shape[0] == idx.shape[0] else arr[:idx.shape[0]]
    return arr[problem.const(tag, idx.astype(np.int32))]


def reduce_rows(problem, tag, y, seg: np.ndarray, num_segments: int):
    """(K, D) product rows -> (num_segments, D) by one XLA segment_sum.

    ``seg`` is a static host array; when it is non-decreasing the sum is
    told so (``indices_are_sorted``), which the freeze-time CSC order
    makes the common case for landmark destinations."""
    seg = np.asarray(seg)
    srt = problem._cache.setdefault("seg_sorted", {})
    if tag not in srt:
        srt[tag] = bool(seg.size == 0 or np.all(np.diff(seg) >= 0))
    return jax.ops.segment_sum(
        y, problem.const(tag + ("seg",), seg.astype(np.int32)),
        num_segments=num_segments, indices_are_sorted=srt[tag],
    )
