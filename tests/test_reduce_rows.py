"""Row reductions and gathers of ops/streamreduce.py against NumPy.

``reduce_rows`` is every hot reduction site's segment_sum (the reference's
atomicAdd scatters, ops/linearize.hpp:302, ops/hessian.hpp:76,
ops/schur.hpp:190-263): sorted and unsorted destinations, a trailing trash
row that masked rows target, and an empty input.
"""

import numpy as np
import pytest

import graphite_tpu.ops.streamreduce as sr


class _Problem:
    """The two Problem members the helpers use: a host cache and const()."""

    def __init__(self):
        self._cache = {}

    def const(self, tag, arr):
        import jax.numpy as jnp

        return jnp.asarray(arr)


def _reference(y, seg, ns):
    out = np.zeros((ns, y.shape[1]))
    np.add.at(out, seg, y)
    return out


@pytest.mark.parametrize("k,ns,d,sort", [
    (5_000, 500, 81, True),     # Schur product rows into S blocks
    (700, 64, 81, True),        # few rows per segment
    (4_096, 40, 36, True),      # heavy multiplicity, small D
    (3_000, 2_900, 8, True),    # near-unique segments
    (4_096, 100, 81, True),     # the product-scatter shape
    (1_000, 37, 16, True),
    (130, 5, 8, True),
    (5_000, 500, 81, False),    # unsorted destinations (pose rows)
    (3_000, 2_900, 9, False),
])
def test_reduce_rows_matches_add_at(k, ns, d, sort):
    rng = np.random.default_rng(k + ns)
    seg = rng.integers(0, ns, size=k)
    if sort:
        seg = np.sort(seg)
    y = rng.normal(size=(k, d)).astype(np.float32)
    p = _Problem()
    out = np.asarray(sr.reduce_rows(p, ("t",), y, seg, ns))
    np.testing.assert_allclose(out, _reference(y, seg, ns), rtol=1e-5,
                               atol=1e-4)
    assert p._cache["seg_sorted"][("t",)] is sort


def test_reduce_rows_trash_row():
    """Masked rows point at a trailing trash row that callers slice off."""
    rng = np.random.default_rng(0)
    ns, k = 50, 2_000
    seg = np.sort(rng.integers(0, ns + 1, size=k))  # id ns = trash
    y = rng.normal(size=(k, 9)).astype(np.float32)
    out = np.asarray(sr.reduce_rows(_Problem(), ("t",), y, seg, ns + 1))
    ref = _reference(y, seg, ns + 1)
    np.testing.assert_allclose(out[:-1], ref[:-1], rtol=1e-5, atol=1e-4)
    live = seg < ns
    np.testing.assert_allclose(out[:-1].sum(0), y[live].sum(0), rtol=1e-4,
                               atol=1e-3)


def test_reduce_rows_empty_input():
    y = np.zeros((0, 4), np.float32)
    seg = np.zeros(0, np.int64)
    out = np.asarray(sr.reduce_rows(_Problem(), ("t",), y, seg, 7))
    np.testing.assert_array_equal(out, np.zeros((7, 4)))


@pytest.mark.parametrize("idx,n_arr,gathered", [
    (np.arange(10), 10, False),         # identity: the array itself
    (np.arange(10), 11, False),         # prefix-iota: a slice
    (np.array([3, 1, 4, 1, 5]), 10, True),
])
def test_maybe_rows(idx, n_arr, gathered):
    arr = np.arange(n_arr * 3, dtype=np.float32).reshape(n_arr, 3)
    p = _Problem()
    out = np.asarray(sr.maybe_rows(p, ("m",), arr, idx))
    np.testing.assert_array_equal(out, arr[idx])
    assert p._cache["identity_idx"][("m",)] is (not gathered)


def test_mapped_rows_chunks_match_one_shot(monkeypatch):
    """Above the byte budget the row products run in scan chunks."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(5_000, 6)).astype(np.float32)

    def body(arrays):
        (x,) = arrays
        return x * 2.0 + 1.0

    one = np.asarray(sr.mapped_rows(body, (a,), a.shape[0], 24))
    monkeypatch.setattr(sr, "MAP_BYTES", 24 * 2048)  # 2048-row chunks
    chunked = np.asarray(sr.mapped_rows(body, (a,), a.shape[0], 24))
    np.testing.assert_array_equal(chunked, one)
    np.testing.assert_allclose(one, a * 2.0 + 1.0)
