"""Host float64 block-sparse reference for the Schur stages (SciPy).

The plain reference the device Schur path (schur.py) is checked against at
sizes the dense oracle (tests/schur_cpu_ref.cpp:8-51, lifted to
``tests/test_schur.py``) cannot reach. Hpp and Hpl are SciPy sparse
matrices assembled from the Hessian block values, Hll^{-1} is
block-diagonal (each landmark block inverted in float64), and

    S    = Hpp - Hpl Hll^{-1} Hpl^T
    b_S  = b_p - Hpl Hll^{-1} b_l
    dx_l = Hll^{-1} (b_l - Hpl^T dx_p)

are evaluated with sparse products. Nothing here shares code with the
device path beyond the block values it is handed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


def _blocks(problem, hs, hvals, keep):
    """Upper-triangle Hessian blocks with ``keep(rows, cols)`` true, as
    (block rows, block cols, (n, dr, dc) float64 values) per group."""
    for gi, key in enumerate(hs.group_keys):
        sel = np.nonzero(hs.group_of_block == gi)[0]
        sel = sel[keep(hs.block_rows[sel], hs.block_cols[sel])]
        if sel.size == 0:
            continue
        vals = np.asarray(hvals[key], dtype=np.float64)
        yield (hs.block_rows[sel], hs.block_cols[sel],
               vals[hs.index_in_group[sel]].reshape(-1, *key))


def _coo(r0, c0, blk):
    """Scalar (rows, cols, values) of blocks placed at scalar offsets."""
    _, dr, dc = blk.shape
    rr = np.broadcast_to(r0[:, None, None] + np.arange(dr)[None, :, None],
                         blk.shape)
    cc = np.broadcast_to(c0[:, None, None] + np.arange(dc)[None, None, :],
                         blk.shape)
    return rr.reshape(-1), cc.reshape(-1), blk.reshape(-1)


def _csr(parts, shape) -> sp.csr_matrix:
    rows, cols, vals = (np.concatenate(p) for p in zip(*parts))
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def hessian_csr(problem, hs, hvals) -> sp.csr_matrix:
    """Full symmetric float64 H (dim_h, dim_h) from upper block values."""
    off = np.asarray(problem.block_offsets)
    parts = []
    for r, c, blk in _blocks(problem, hs, hvals, lambda r, c: r >= 0):
        parts.append(_coo(off[r], off[c], blk))
        o = r != c
        parts.append(_coo(off[c[o]], off[r[o]], blk[o].transpose(0, 2, 1)))
    return _csr(parts, (problem.dim_h, problem.dim_h))


@dataclasses.dataclass
class SchurReference:
    Hpp: sp.csr_matrix  # (dim_p, dim_p), full symmetric
    Hpl: sp.csr_matrix  # (dim_p, dim_l)
    Hll_inv: sp.csr_matrix  # (dim_l, dim_l), block-diagonal
    b_p: np.ndarray
    b_l: np.ndarray

    def s_matrix(self) -> sp.csr_matrix:
        """S = Hpp - Hpl Hll^{-1} Hpl^T (full symmetric, sparse)."""
        return (self.Hpp - self.Hpl @ self.Hll_inv @ self.Hpl.T).tocsr()

    def s_block(self, r0: int, dr: int, c0: int, dc: int) -> np.ndarray:
        """The (dr, dc) block of S at scalar offsets (r0, c0), from the two
        pose row bands of Hpl alone (no full S)."""
        corr = (self.Hpl[r0:r0 + dr] @ self.Hll_inv
                @ self.Hpl[c0:c0 + dc].T).toarray()
        return self.Hpp[r0:r0 + dr, c0:c0 + dc].toarray() - corr

    def s_block_terms(self, r0: int, dr: int, c0: int,
                      dc: int) -> np.ndarray:
        """|Hpp| + |Hpl| |Hll^{-1}| |Hpl|^T for the same block: the size of
        the terms the cancellation sums, which bounds float32 rounding."""
        a = (abs(self.Hpl[r0:r0 + dr]) @ abs(self.Hll_inv)
             @ abs(self.Hpl[c0:c0 + dc]).T).toarray()
        return abs(self.Hpp[r0:r0 + dr, c0:c0 + dc]).toarray() + a

    def s_terms(self) -> sp.csr_matrix:
        """|Hpp| + |Hpl| |Hll^{-1}| |Hpl|^T (see ``s_block_terms``)."""
        return (abs(self.Hpp) + abs(self.Hpl) @ abs(self.Hll_inv)
                @ abs(self.Hpl).T).tocsr()

    def b_schur(self) -> np.ndarray:
        return self.b_p - self.Hpl @ (self.Hll_inv @ self.b_l)

    def b_schur_terms(self) -> np.ndarray:
        """|b_p| + |Hpl| |Hll^{-1}| |b_l| (see ``s_block_terms``)."""
        return np.abs(self.b_p) + abs(self.Hpl) @ (
            abs(self.Hll_inv) @ np.abs(self.b_l))

    def landmark_update(self, dx_p: np.ndarray) -> np.ndarray:
        return self.Hll_inv @ (self.b_l - self.Hpl.T @ dx_p)

    def landmark_update_terms(self, dx_p: np.ndarray) -> np.ndarray:
        """|Hll^{-1}| (|b_l| + |Hpl|^T |dx_p|) (see ``s_block_terms``)."""
        return abs(self.Hll_inv) @ (
            np.abs(self.b_l) + abs(self.Hpl).T @ np.abs(dx_p))


def schur_reference(problem, hs, hvals, b) -> SchurReference:
    """Block-sparse float64 Schur reference from (damped) H block values
    and the gradient ``b`` (at least dim_h entries). Requires Hll to be
    block-diagonal, as the device path does."""
    eb = problem.elimination_block
    n_p = int(problem.elimination_col)
    n_l = problem.dim_h - n_p
    off = np.asarray(problem.block_offsets)

    pp = []
    for r, c, blk in _blocks(problem, hs, hvals, lambda r, c: c < eb):
        pp.append(_coo(off[r], off[c], blk))
        o = r != c
        pp.append(_coo(off[c[o]], off[r[o]], blk[o].transpose(0, 2, 1)))
    pl = [_coo(off[r], off[c] - n_p, blk) for r, c, blk in _blocks(
        problem, hs, hvals, lambda r, c: (r < eb) & (c >= eb))]
    ll = [_coo(off[r] - n_p, off[c] - n_p, np.linalg.inv(blk))
          for r, c, blk in _blocks(problem, hs, hvals,
                                   lambda r, c: (r >= eb) & (r == c))]
    b = np.asarray(b, dtype=np.float64)
    return SchurReference(
        Hpp=_csr(pp, (n_p, n_p)),
        Hpl=_csr(pl, (n_p, n_l)),
        Hll_inv=_csr(ll, (n_l, n_l)),
        b_p=b[:n_p],
        b_l=b[n_p:problem.dim_h],
    )


def s_bsr(ss, s_vals) -> sp.bsr_matrix:
    """The full symmetric S as a float64 SciPy BSR matrix, from stored
    upper S block values (uniform pose block dims, as in BAL)."""
    (key,) = ss.s_keys
    d, dc = key
    if d != dc or np.any(np.asarray(ss.pose_dims) != d):
        raise ValueError("s_bsr needs uniform square pose blocks")
    blk = np.asarray(s_vals[key], dtype=np.float64).reshape(-1, d, d)
    r = np.asarray(ss.s_rows[key])
    c = np.asarray(ss.s_cols[key])
    o = r != c
    rows = np.concatenate([r, c[o]])
    cols = np.concatenate([c, r[o]])
    data = np.concatenate([blk, blk[o].transpose(0, 2, 1)])
    order = np.lexsort((cols, rows))
    n = ss.n_pose_blocks
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return sp.bsr_matrix((data[order], cols[order], indptr),
                         shape=(n * d, n * d))
