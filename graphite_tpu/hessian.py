"""Block-sparse Hessian container.

JAX analog of ``Hessian<T,S>`` / ``HessianBlocks`` / CSC utilities
(reference: include/graphite/hessian.hpp:15-324, csc_utils.hpp:16-193).

Structure discovery runs **once per topology** on the host in NumPy
(`build_hessian_structure`), mirroring the reference's GPU sort/unique of
block coordinates (hessian.hpp:48-85) and host offset maps (:270-278):

- upper-triangular blocks keyed by (block_row, block_col), stored CSC-sorted
  by (col, row) so the diagonal block is always last in its column — the
  invariant the reference's diagonal backup relies on (hessian.hpp:121-127);
- blocks are grouped by (row_dim, col_dim) so each group is one dense
  ``(n_blocks+1, dr, dc)`` array (the +1 is a trash block absorbing masked
  contributions — the static-shape analog of ``is_vertex_active`` guards);
- per (factor type, slot pair) scatter maps tell the jitted value update
  where each factor's ``J_s^T dL P J_t`` lands, with orientation handled by
  direct/transposed target maps (the reference's transposed-rectangular
  handling, ops/hessian.hpp:39-49).

Value recomputation (`compute_hessian_values`) is pure jit: batched block
products + segment_sums (atomic adds on the GPU), replacing the per-block
atomicAdd kernels (ops/hessian.hpp:9-78, factor.hpp:771-853).

LM damping (`apply_damping`) augments diagonal-block diagonals from the
pre-damping backup: ``d + mu`` or ``d + mu*clamp(d, 1e-6, 1e32)``
(hessian.hpp:136-176). The backup is ``lin.diag`` (the scaled-system
diagonal) — identical to the reference's backup_diagonal (:102-134).

Scalar CSC export (`build_hessian_structure` precomputes the scatter;
`csc_values` fills it) mirrors csc_utils.hpp:73-193 but exports the FULL
symmetric matrix, which is what host sparse direct solvers consume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import hostops
from .graph import with_matmul_precision
from .linearize import DIAG_MIN, DIAG_MAX, Linearization, _apply_precision
from .ops.blockfmt import (
    flat_block_mm_nn,
    flat_block_mm_tn,
    flatten_blocks,
    unflatten_blocks,
)


@dataclasses.dataclass
class ContribMap:
    """Where one (factor type, slot s, slot t) pair's products go."""

    fname: str
    s: int
    t: int
    # group keys and per-factor block indices (trash = n_blocks of group)
    direct_group: Tuple[int, int]
    direct_idx: Optional[np.ndarray]  # (F,) int32 or None if all-trash
    trans_group: Tuple[int, int]
    trans_idx: Optional[np.ndarray]
    # when the direct map hits each target block at most once AND this is the
    # group's only contributor, the scatter degenerates to an inverse-
    # permutation GATHER (no scatter at all): (n_g+1,) source
    # factor index, or F (zero row) for untouched blocks
    direct_gather: Optional[np.ndarray] = None


@dataclasses.dataclass
class HessianStructure:
    """Static (host) description of the block-sparse Hessian."""

    # block bookkeeping, CSC order (sorted by (col, row))
    block_rows: np.ndarray  # (NB,) block-column ids
    block_cols: np.ndarray
    n_blocks: int
    # storage grouping
    group_keys: List[Tuple[int, int]]  # [(dr, dc)]
    group_of_block: np.ndarray  # (NB,) index into group_keys
    index_in_group: np.ndarray  # (NB,)
    group_sizes: Dict[Tuple[int, int], int]
    # contribution scatter maps
    contribs: List[ContribMap]
    # diagonal-block lookup: for block column j, (group, idx)
    diag_group: np.ndarray  # (n_block_cols,) group index (-1 if absent)
    diag_idx: np.ndarray
    # scalar CSC (full symmetric) export — built LAZILY by
    # ensure_csc_structure (only host sparse-direct solvers need it)
    csc_indptr: Optional[np.ndarray] = None  # (dim_h+1,)
    csc_indices: Optional[np.ndarray] = None  # (nnz,)
    nnz: int = 0
    # per group: flat scatter destinations for block entries (and their
    # transposes for off-diagonal blocks); trash entries -> nnz
    csc_dst: Optional[Dict[Tuple[int, int], np.ndarray]] = None
    csc_dst_t: Optional[Dict[Tuple[int, int], np.ndarray]] = None


def _block_ids_for(problem, fname: str):
    """Per-factor block ids for each slot ((F,) arrays), -1 when inactive."""
    fm = problem.factor_meta[fname]
    ids = problem.host.factor_ids[fname]
    smask = problem.host.slot_mask[fname]
    out = []
    for s, vt in enumerate(fm.ftype.vertex_types):
        bid = problem.host.vertex_block_id[vt.name][ids[:, s]].copy()
        bid[~smask[:, s]] = -1
        out.append(bid)
    return out


def _unique_merge_inverse(all_codes, diag_source, n_cols):
    """Global (unique sorted codes, concatenated inverse) across per-source
    code arrays.

    Each source is uniqued independently (self-pair sources via the
    bounded flag-array rank on the block id — their codes b*(n_cols+1)
    are strictly monotone in b), the per-source unique arrays are
    dedup-merged, and each source's inverse is remapped through its
    ranks in the merged array."""
    if not all_codes:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    uniqs, invs = [], []
    for codes_s, is_diag in zip(all_codes, diag_source):
        if is_diag and n_cols < (1 << 26):
            b = codes_s // (n_cols + 1)
            ub, inv = hostops.unique_inverse(b, bound=n_cols)
            uniqs.append(ub * (n_cols + 1))
        else:
            ub, inv = hostops.unique_inverse(codes_s)
            uniqs.append(ub)
        invs.append(inv)
    total = sum(c.shape[0] for c in all_codes)
    if len(uniqs) == 1:
        return uniqs[0], invs[0]
    merged = hostops.sorted_unique(np.concatenate(uniqs))
    out = np.empty(total, dtype=np.int64)
    off = 0
    for u, inv in zip(uniqs, invs):
        rank = hostops.searchsorted(merged, u)
        out[off:off + inv.shape[0]] = rank[inv]
        off += inv.shape[0]
    return merged, out


def build_hessian_structure(problem) -> HessianStructure:
    if "hessian_structure" in problem._cache:
        return problem._cache["hessian_structure"]

    from .perf import SectionTimer
    _tm = SectionTimer("hessian_structure")
    block_dims = problem.block_dims
    n_cols = problem.n_blocks

    # 1. Collect upper-triangular block coordinates from all factor
    # slot-pairs (hessian.hpp:48-85). Blocks are encoded as c*n_cols+r so a
    # sorted unique is exactly CSC order with the diagonal block last in its
    # column (r <= c means max row in column c is the diagonal).
    pair_sources = []  # (fname, s, t, bs (F,), bt (F,), valid (F,))
    all_codes = []
    diag_source = []  # s == t: code = b*(n_cols+1), rankable by b alone
    for fname, fm in problem.factor_meta.items():
        bids = _block_ids_for(problem, fname)
        n = fm.ftype.arity
        for s in range(n):
            for t in range(s, n):
                bs, bt = bids[s], bids[t]
                valid = (bs >= 0) & (bt >= 0)
                lo = np.minimum(bs, bt)[valid]
                hi = np.maximum(bs, bt)[valid]
                all_codes.append(hi * n_cols + lo)
                diag_source.append(s == t)
                pair_sources.append((fname, s, t, bs, bt, valid))

    _tm.lap("collect_codes")
    # Per-source unique+inverse, then a dedup merge of the per-source
    # unique code arrays and a rank remap — no per-pair binary searches
    # (the reference instead walks a host hash map per factor,
    # hessian.hpp:178-208 / factor.hpp:702-763). Splitting by source keeps
    # each radix pass at n_obs instead of (#slot-pairs * n_obs), and the
    # self-pair (s == t) sources rank by the block id alone (bounded flag
    # array, 3 linear passes): 7.1 s -> ~2 s at Venice-Final.
    codes, code_inverse = _unique_merge_inverse(
        all_codes, diag_source, n_cols)
    block_rows = codes % n_cols
    block_cols = codes // n_cols
    nb = codes.shape[0]

    # 2. Group by (dr, dc), preserving CSC order within each group.
    dr_all = block_dims[block_rows] if nb else np.zeros(0, dtype=np.int64)
    dc_all = block_dims[block_cols] if nb else np.zeros(0, dtype=np.int64)
    dim_codes = dr_all * 100000 + dc_all
    max_dim = int(block_dims.max()) if block_dims.size else 1
    uniq_dims, group_of_block = hostops.unique_inverse(
        dim_codes, bound=max_dim * 100000 + max_dim + 1)
    group_keys = [(int(d // 100000), int(d % 100000)) for d in uniq_dims]
    counts = np.bincount(group_of_block, minlength=len(group_keys)).astype(
        np.int64
    )
    group_counts = {key: int(c) for key, c in zip(group_keys, counts)}
    index_in_group = np.empty(nb, dtype=np.int64)
    perm = hostops.stable_argsort(group_of_block, len(group_keys))
    index_in_group[perm] = (
        np.arange(nb) - np.repeat(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                                  counts)
    )
    group_map = {key: i for i, key in enumerate(group_keys)}

    _tm.lap("unique_and_groups")
    # 3. Contribution maps: direct (bs<=bt) and transposed (bs>=bt, plus the
    # self-block transpose when bs==bt and s<t). Each pair source's segment
    # of `code_inverse` IS its normalized-code block position (the codes
    # were collected in this exact order), so orientation masks are the
    # only per-factor work.
    contribs: List[ContribMap] = []
    seg_start = 0
    for fname, s, t, bs, bt, valid in pair_sources:
        fm = problem.factor_meta[fname]
        ds = fm.ftype.vertex_types[s].dim
        dt_ = fm.ftype.vertex_types[t].dim
        dkey, tkey = (ds, dt_), (dt_, ds)
        d_trash = group_counts.get(dkey, 0)
        t_trash = group_counts.get(tkey, 0)
        all_valid = bool(valid.all())
        n_valid = valid.size if all_valid else int(valid.sum())
        inv_seg = code_inverse[seg_start:seg_start + n_valid]
        seg_start += n_valid
        idx_norm = index_in_group[inv_seg]  # block index of (lo, hi) code
        vpos = None if all_valid else np.nonzero(valid)[0]
        bs_v = bs if all_valid else bs[vpos]
        bt_v = bt if all_valid else bt[vpos]
        F = bs.shape[0]
        m_d = bs_v <= bt_v
        m_t = (bs_v > bt_v) | ((bs_v == bt_v) & (s < t))
        direct_idx = None
        trans_idx = None
        if m_d.all() and all_valid:
            # fully-valid, fully-direct source (self pairs; cross pairs
            # with type-ordered block ids — every BAL/pose-graph source):
            # the inverse segment IS the map, no fill + masked scatter
            direct_idx = np.ascontiguousarray(idx_norm, dtype=np.int32)
        elif np.any(m_d):
            direct_idx = np.full(F, d_trash, dtype=np.int32)
            sel = np.nonzero(m_d)[0] if all_valid else vpos[m_d]
            direct_idx[sel] = idx_norm[m_d]
        if np.any(m_t):
            trans_idx = np.full(F, t_trash, dtype=np.int32)
            sel = np.nonzero(m_t)[0] if all_valid else vpos[m_t]
            trans_idx[sel] = idx_norm[m_t]
        contribs.append(
            ContribMap(fname, s, t, dkey, direct_idx, tkey, trans_idx)
        )

    # Unique-destination detection: if exactly ONE contribution map targets a
    # group and every non-trash target is hit at most once, replace the
    # scatter-add with an inverse-permutation gather.
    _tm.lap("contrib_maps")
    by_group = {}
    for cm in contribs:
        if cm.direct_idx is not None:
            by_group.setdefault(cm.direct_group, []).append(("d", cm))
        if cm.trans_idx is not None:
            by_group.setdefault(cm.trans_group, []).append(("t", cm))
    for group, entries in by_group.items():
        if len(entries) != 1 or entries[0][0] != "d":
            continue
        cm = entries[0][1]
        ng = group_counts[group]
        idx = cm.direct_idx
        hits = np.bincount(idx[idx < ng], minlength=ng)
        if hits.max(initial=0) > 1:
            continue
        F = idx.shape[0]
        inv = np.full(ng + 1, F, dtype=np.int32)  # F -> zero source row
        src = np.nonzero(idx < ng)[0]
        inv[idx[src]] = src
        inv[ng] = F
        cm.direct_gather = inv

    _tm.lap("unique_dst_gather")
    # 4. Diagonal-block lookup per block column.
    cols_j = np.arange(n_cols)
    diag_codes = cols_j * n_cols + cols_j
    diag_pos = np.searchsorted(codes, diag_codes)
    diag_pos_c = np.clip(diag_pos, 0, max(nb - 1, 0))
    diag_found = (nb > 0) & (codes[diag_pos_c] == diag_codes)
    diag_group = np.where(diag_found, group_of_block[diag_pos_c], -1)
    diag_idx = np.where(diag_found, index_in_group[diag_pos_c], 0)

    hs = HessianStructure(
        block_rows=block_rows,
        block_cols=block_cols,
        n_blocks=nb,
        group_keys=group_keys,
        group_of_block=group_of_block,
        index_in_group=index_in_group,
        group_sizes=group_counts,
        contribs=contribs,
        diag_group=diag_group,
        diag_idx=diag_idx,
    )
    _tm.lap("diag_lookup")
    _tm.done()
    problem._cache["hessian_structure"] = hs
    return hs


def ensure_csc_structure(problem, hs: HessianStructure) -> HessianStructure:
    """Build the scalar CSC export on first use (it is O(nnz) host work
    that only the host sparse-direct solvers need)."""
    if hs.csc_indptr is not None:
        return hs
    block_rows, block_cols = hs.block_rows, hs.block_cols
    group_keys = hs.group_keys
    group_of_block = hs.group_of_block
    index_in_group = hs.index_in_group
    group_counts = hs.group_sizes
    # Scalar CSC (full symmetric) structure + per-group scatter maps
    # (csc_utils.hpp:73-193, extended to the full matrix). Entry arrays are
    # built group-vectorized: for each (dr, dc) group all direct entries,
    # then all transposed entries of its off-diagonal blocks.
    dim_h = problem.dim_h
    offsets = problem.block_offsets
    rows_segments: List[np.ndarray] = []
    cols_segments: List[np.ndarray] = []
    seg_layout = []  # (key, kind, block-index-in-group array)
    for gi, key in enumerate(group_keys):
        dr, dc = key
        members = np.nonzero(group_of_block == gi)[0]  # CSC order
        r_ids = block_rows[members]
        c_ids = block_cols[members]
        rr = (offsets[r_ids][:, None, None]
              + np.arange(dr)[None, :, None])  # (ng, dr, 1)
        cc = (offsets[c_ids][:, None, None]
              + np.arange(dc)[None, None, :])  # (ng, 1, dc)
        rows_segments.append(np.broadcast_to(rr, (len(members), dr, dc)).ravel())
        cols_segments.append(np.broadcast_to(cc, (len(members), dr, dc)).ravel())
        seg_layout.append((key, "direct", index_in_group[members]))
        off = members[r_ids != c_ids]
        if off.size:
            r_o = block_rows[off]
            c_o = block_cols[off]
            rr_t = (offsets[c_o][:, None, None]
                    + np.arange(dc)[None, None, :])  # transposed row = c+j
            cc_t = (offsets[r_o][:, None, None]
                    + np.arange(dr)[None, :, None])
            rows_segments.append(
                np.broadcast_to(rr_t, (off.size, dr, dc)).ravel())
            cols_segments.append(
                np.broadcast_to(cc_t, (off.size, dr, dc)).ravel())
            seg_layout.append((key, "trans", index_in_group[off]))

    if rows_segments:
        rows_cat = np.concatenate(rows_segments)
        cols_cat = np.concatenate(cols_segments)
    else:
        rows_cat = cols_cat = np.zeros(0, dtype=np.int64)

    order = np.lexsort((rows_cat, cols_cat))  # CSC: by col, then row
    nnz = rows_cat.shape[0]
    csc_indices = rows_cat[order]
    counts_c = np.bincount(cols_cat, minlength=dim_h)
    csc_indptr = np.zeros(dim_h + 1, dtype=np.int64)
    np.cumsum(counts_c, out=csc_indptr[1:])
    # position of each (block entry, orientation) in the CSC values array
    pos_of = np.empty(nnz, dtype=np.int64)
    pos_of[order] = np.arange(nnz)

    csc_dst: Dict[Tuple[int, int], np.ndarray] = {}
    csc_dst_t: Dict[Tuple[int, int], np.ndarray] = {}
    for key in group_keys:
        dr, dc = key
        ng = group_counts[key]
        csc_dst[key] = np.full((ng + 1, dr, dc), nnz, dtype=np.int64)
        csc_dst_t[key] = np.full((ng + 1, dr, dc), nnz, dtype=np.int64)
    cursor = 0
    for key, kind, in_group in seg_layout:
        dr, dc = key
        n_entries = in_group.size * dr * dc
        chunk = pos_of[cursor:cursor + n_entries].reshape(-1, dr, dc)
        if kind == "direct":
            csc_dst[key][in_group] = chunk
        else:
            csc_dst_t[key][in_group] = chunk
        cursor += n_entries

    hs.csc_indptr = csc_indptr
    hs.csc_indices = csc_indices
    hs.nnz = nnz
    hs.csc_dst = csc_dst
    hs.csc_dst_t = csc_dst_t
    return hs


# --------------------------------------------------------------------------
# Value computation (jit)
# --------------------------------------------------------------------------

# group -> (n_g+1, dr*dc): blocks stored flat 2-D (ops/blockfmt.py); the
# trailing trash block absorbs masked contributions.
HessianValues = Dict[Tuple[int, int], jax.Array]


@with_matmul_precision
def compute_hessian_values(problem, hs: HessianStructure,
                           lin: Linearization) -> HessianValues:
    """H = J^T dL P J into grouped block storage (hessian.hpp:210-220,
    factor.hpp:771-853). Jacobians are already scaled & masked."""
    acc = problem.precision.acc_dtype
    inv_dt = problem.precision.inv_dtype
    values: HessianValues = {
        key: jnp.zeros((hs.group_sizes[key] + 1, key[0] * key[1]),
                       dtype=inv_dt)
        for key in hs.group_keys
    }
    # cache P J_t per (fname, t), 3-D transient
    pj_cache: Dict[Tuple[str, int], jax.Array] = {}

    def unflat_j(fname, t):
        fm = problem.factor_meta[fname]
        return unflatten_blocks(
            lin.jacobians[fname][t], fm.ftype.residual_dim,
            fm.ftype.vertex_types[t].dim,
        ).astype(acc)

    def pj(fname, t):
        k = (fname, t)
        if k not in pj_cache:
            fa = problem.data.factors[fname]
            pj_cache[k] = _apply_precision(fa, unflat_j(fname, t), acc)
        return pj_cache[k]

    # Above this factor count, contributions are processed in chunks via
    # lax.scan so the transient (F, dr, dc) product stays bounded; below
    # it one fused pass is fastest.
    chunk_limit = 1 << 20

    def contribute(group, idx_np, blk_flat, key, n_local):
        idx = problem.shard_slice(problem.const(key, idx_np), n_local)
        values[group] = values[group] + jax.ops.segment_sum(
            blk_flat.astype(inv_dt), idx,
            num_segments=hs.group_sizes[group] + 1,
        )

    for ci, cm in enumerate(hs.contribs):
        if cm.direct_idx is None and cm.trans_idx is None:
            continue
        J = lin.jacobians[cm.fname]
        if J is None:
            raise ValueError(
                f"explicit Hessian requires stored Jacobians "
                f"('{cm.fname}' is dynamic)"
            )
        fm = problem.factor_meta[cm.fname]
        E = fm.ftype.residual_dim
        ds = fm.ftype.vertex_types[cm.s].dim
        dt_ = fm.ftype.vertex_types[cm.t].dim
        n_local = J[cm.s].shape[0]

        if problem.psum_axis is None:
            # Non-sharded: compute the flat (F, ds*dt) product rows in
            # byte-bounded scan_map chunks (no per-step accumulator
            # folding), then reduce each destination with an
            # inverse-permutation gather (unique dst) or one XLA
            # segment_sum (reference: factor.hpp:771-853's
            # per-(i,j)-stream atomicAdd assembly).
            from .ops.streamreduce import mapped_rows as _mapped_rows
            from .ops.streamreduce import reduce_rows as _reduce_rows

            fa = problem.data.factors[cm.fname]
            arrays = [J[cm.s], J[cm.t],
                      lin.chi2_deriv[cm.fname].astype(acc)]
            has_prec = fa.precision is not None
            if has_prec:
                arrays.append(fa.precision)

            def prod_body(chunk_arrays, E=E, ds=ds, dt_=dt_,
                          has_prec=has_prec):
                # flat 2-D block products (ops/blockfmt.py)
                js, jt, dl = chunk_arrays[:3]
                jt = jt.astype(acc)
                if has_prec:
                    jt = flat_block_mm_nn(
                        chunk_arrays[3].astype(acc), jt, E, E, dt_,
                        acc_dtype=acc)
                blk = flat_block_mm_tn(js.astype(acc), jt, ds, E, dt_,
                                       acc_dtype=acc)
                return (blk * dl[:, None]).astype(inv_dt)

            row_bytes = (E * ds + E * dt_ + ds * dt_ + 1
                         + (E * E if has_prec else 0)) * 4
            flat = _mapped_rows(prod_body, tuple(arrays), n_local,
                                row_bytes)
            if cm.direct_gather is not None:
                inv = problem.const(("hess_g", ci), cm.direct_gather)
                padded = jnp.concatenate(
                    [flat, jnp.zeros((1, flat.shape[1]), dtype=inv_dt)]
                )
                values[cm.direct_group] = values[cm.direct_group] + padded[
                    inv]
            elif cm.direct_idx is not None:
                values[cm.direct_group] = values[
                    cm.direct_group] + _reduce_rows(
                        problem, ("hess_d", ci), flat, cm.direct_idx,
                        hs.group_sizes[cm.direct_group] + 1)
            if cm.trans_idx is not None:
                # row-major (ds, dt) -> (dt, ds) transpose is a static
                # lane permutation of the flat rows
                tperm = np.arange(ds * dt_).reshape(ds, dt_).T.reshape(-1)
                flat_t = flat[:, tperm]
                values[cm.trans_group] = values[
                    cm.trans_group] + _reduce_rows(
                        problem, ("hess_t", ci), flat_t, cm.trans_idx,
                        hs.group_sizes[cm.trans_group] + 1)
            continue

        if n_local <= chunk_limit:
            blk = jnp.einsum(
                "fer,fec->frc", unflat_j(cm.fname, cm.s), pj(cm.fname, cm.t),
                preferred_element_type=acc,
            ) * dL_of(lin, cm.fname, acc)[:, None, None]
            if (cm.direct_gather is not None
                    and problem.psum_axis is None):
                inv = problem.const(("hess_g", ci), cm.direct_gather)
                flat = flatten_blocks(blk).astype(inv_dt)
                padded = jnp.concatenate(
                    [flat, jnp.zeros((1, flat.shape[1]), dtype=inv_dt)]
                )
                values[cm.direct_group] = values[cm.direct_group] + padded[inv]
            elif cm.direct_idx is not None:
                contribute(cm.direct_group, cm.direct_idx,
                           flatten_blocks(blk), ("hess_d", ci), n_local)
            if cm.trans_idx is not None:
                contribute(cm.trans_group, cm.trans_idx,
                           flatten_blocks(jnp.swapaxes(blk, -1, -2)),
                           ("hess_t", ci), n_local)
            continue

        # chunked path (huge factor counts)
        fa = problem.data.factors[cm.fname]
        chunk = chunk_limit // 2
        n_pad = (-n_local) % chunk
        n_chunks = (n_local + n_pad) // chunk

        def pad_to(a, fill=0):
            if n_pad == 0:
                return a
            return jnp.concatenate(
                [a, jnp.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)]
            )

        Js_c = pad_to(J[cm.s]).reshape(n_chunks, chunk, E * ds)
        Jt_c = pad_to(J[cm.t]).reshape(n_chunks, chunk, E * dt_)
        dL_c = pad_to(lin.chi2_deriv[cm.fname]).reshape(n_chunks, chunk)
        prec_c = (None if fa.precision is None
                  else pad_to(fa.precision).reshape(n_chunks, chunk, E * E))

        def seg_ids(idx_np, group, key):
            trash = hs.group_sizes[group]
            idx = problem.shard_slice(problem.const(key, idx_np), n_local)
            return pad_to(idx, fill=trash).reshape(n_chunks, chunk)

        d_ids = (None if cm.direct_idx is None
                 else seg_ids(cm.direct_idx, cm.direct_group, ("hess_d", ci)))
        t_ids = (None if cm.trans_idx is None
                 else seg_ids(cm.trans_idx, cm.trans_group, ("hess_t", ci)))

        def body(carry, xs):
            vd, vt = carry
            js, jt, dl, pc, di, ti = xs
            Js3 = unflatten_blocks(js, E, ds).astype(acc)
            Jt3 = unflatten_blocks(jt, E, dt_).astype(acc)
            if pc is not None:
                P3 = unflatten_blocks(pc, E, E).astype(acc)
                Jt3 = jnp.einsum("fij,fjc->fic", P3, Jt3,
                                 preferred_element_type=acc)
            blk = jnp.einsum("fer,fec->frc", Js3, Jt3,
                             preferred_element_type=acc) * dl.astype(acc)[
                :, None, None]
            if di is not None:
                vd = vd + jax.ops.segment_sum(
                    flatten_blocks(blk).astype(inv_dt), di,
                    num_segments=vd.shape[0],
                )
            if ti is not None:
                vt = vt + jax.ops.segment_sum(
                    flatten_blocks(jnp.swapaxes(blk, -1, -2)).astype(inv_dt),
                    ti, num_segments=vt.shape[0],
                )
            return (vd, vt), None

        vd0 = jnp.zeros(
            ((hs.group_sizes[cm.direct_group] + 1) if cm.direct_idx is not None
             else 1, ds * dt_), dtype=inv_dt)
        vt0 = jnp.zeros(
            ((hs.group_sizes[cm.trans_group] + 1) if cm.trans_idx is not None
             else 1, dt_ * ds), dtype=inv_dt)
        xs = (Js_c, Jt_c, dL_c,
              prec_c if prec_c is not None else jnp.zeros((n_chunks, 1)),
              d_ids if d_ids is not None else jnp.zeros((n_chunks, 1)),
              t_ids if t_ids is not None else jnp.zeros((n_chunks, 1)))

        def body_wrap(carry, xs_row):
            js, jt, dl, pc, di, ti = xs_row
            return body(carry, (
                js, jt, dl,
                pc if prec_c is not None else None,
                di if d_ids is not None else None,
                ti if t_ids is not None else None,
            ))

        (vd, vt), _ = jax.lax.scan(body_wrap, (vd0, vt0), xs)
        if cm.direct_idx is not None:
            values[cm.direct_group] = values[cm.direct_group] + vd
        if cm.trans_idx is not None:
            values[cm.trans_group] = values[cm.trans_group] + vt
    return {k: problem.allreduce(v) for k, v in values.items()}


def dL_of(lin, fname, acc):
    return lin.chi2_deriv[fname].astype(acc)


def _diag_rows_by_type(problem, hs: HessianStructure):
    """Per vertex type: its diagonal-block indices in type-row order."""
    if "diag_rows_by_type" in problem._cache:
        return problem._cache["diag_rows_by_type"]
    out = {}
    for name, vm in problem.vertex_meta.items():
        rv = problem.row_vertex.get(name)
        if rv is None or rv.size == 0:
            continue
        bids = problem.host.vertex_block_id[name][rv]  # block id per row
        gi = hs.diag_group[bids]
        if np.any(gi < 0):
            continue  # some active vertex has no diagonal block (no factor)
        assert np.all(gi == gi[0])
        key = hs.group_keys[int(gi[0])]
        out[name] = (key, hs.diag_idx[bids].astype(np.int32))
    problem._cache["diag_rows_by_type"] = out
    return out


@with_matmul_precision
def apply_damping(problem, hs: HessianStructure, values: HessianValues,
                  diag_backup: jax.Array, damping, use_identity: bool
                  ) -> HessianValues:
    """Damped copy of the block values (hessian.hpp:136-176).

    ``diag_backup`` is the pre-damping scaled diagonal — ``lin.diag``.
    Row-shaped per vertex type: the backup slice is a free reshape.
    """
    out = dict(values)
    for name, (key, idxs) in _diag_rows_by_type(problem, hs).items():
        d = key[0]
        store_dt = values[key].dtype
        d0 = problem.rows_view(diag_backup, name).astype(store_dt)
        mu = jnp.asarray(damping).astype(store_dt)
        if use_identity:
            dnew = d0 + mu
        else:
            dnew = d0 + mu * jnp.clip(d0, DIAG_MIN, DIAG_MAX)
        dnew = dnew.astype(store_dt)
        # flat (n, d*d) blocks: diagonal entries sit at i*d+i; overwrite them
        # with the damped backup via a static diag mask. Diagonal blocks of
        # one type are almost always a CONTIGUOUS index range of the group
        # array — a static slice + dynamic_update_slice keeps the update
        # pure-elementwise instead of a gather + row scatter.
        n_idx = int(idxs.size)
        contig = (n_idx > 0 and int(idxs[-1]) - int(idxs[0]) == n_idx - 1
                  and bool(np.all(np.diff(idxs) == 1)))
        if contig:
            lo = int(idxs[0])
            blocks = jax.lax.dynamic_slice_in_dim(out[key], lo, n_idx, 0)
        else:
            idxs_j = problem.const(("damp_idx", name), idxs)
            blocks = out[key][idxs_j]
        diag_pos = np.arange(d) * (d + 1)
        mask = np.zeros(d * d, dtype=bool)
        mask[diag_pos] = True
        dnew_full = jnp.zeros_like(blocks).at[:, jnp.asarray(diag_pos)].set(
            dnew
        )
        blocks = jnp.where(jnp.asarray(mask)[None, :], dnew_full, blocks)
        if contig:
            out[key] = jax.lax.dynamic_update_slice(
                out[key], blocks, (lo, 0))
        else:
            out[key] = out[key].at[idxs_j].set(blocks)
    return out


@with_matmul_precision
def csc_values(problem, hs: HessianStructure, values: HessianValues) -> jax.Array:
    """Scatter block values into the full-symmetric scalar CSC value array
    (csc_utils.hpp:149-193)."""
    ensure_csc_structure(problem, hs)
    acc = problem.precision.inv_dtype
    out = jnp.zeros(hs.nnz + 1, dtype=acc)
    for key in hs.group_keys:
        v = values[key].astype(acc)
        # csc_dst_t[k][i, j] is the CSC position of the transposed copy's
        # (j, i) entry, i.e. where original entry (i, j) lands — so both
        # scatters consume the block in its original entry order.
        out = out.at[jnp.asarray(hs.csc_dst[key]).reshape(-1)].add(
            v.reshape(-1)
        )
        out = out.at[jnp.asarray(hs.csc_dst_t[key]).reshape(-1)].add(
            v.reshape(-1)
        )
    return out[: hs.nnz]


def dense_hessian_matrix(problem, hs: HessianStructure,
                         values: HessianValues) -> jax.Array:
    """Traced dense (dim_h, dim_h) H from block values — feeds the
    on-device direct factorization path (the analog of cudss's
    full-matrix factorization, cudss.hpp:53-269; here the matrix is
    densified block-wise and factorized by the blocked Cholesky of
    ops/blocked_cholesky.py). Upper-tri block storage is mirrored on
    scatter."""
    n = problem.dim_h
    if n > 46_340:  # flat offsets r*n+c must fit int32
        raise ValueError(
            f"dense Hessian densify needs dim_h <= 46340 (got {n}); use a "
            "Schur-reduced or iterative solver at this scale")
    acc = problem.precision.inv_dtype
    cache = problem._cache
    if "dense_h_idx" not in cache:
        offsets = problem.block_offsets
        out = {}
        for gi, key in enumerate(hs.group_keys):
            dr, dc = key
            sel = np.nonzero(hs.group_of_block == gi)[0]
            sel = sel[np.argsort(hs.index_in_group[sel], kind="stable")]
            r0 = offsets[hs.block_rows[sel]]
            c0 = offsets[hs.block_cols[sel]]
            idx = ((r0[:, None, None] + np.arange(dr)[None, :, None]) * n
                   + c0[:, None, None] + np.arange(dc)[None, None, :])
            off = hs.block_rows[sel] != hs.block_cols[sel]
            o = np.nonzero(off)[0]
            idx_t = ((c0[o][:, None, None]
                      + np.arange(dc)[None, None, :]) * n
                     + r0[o][:, None, None] + np.arange(dr)[None, :, None])
            out[key] = (idx.reshape(sel.shape[0], dr * dc).astype(np.int32),
                        o.astype(np.int32),
                        idx_t.reshape(o.shape[0], dr * dc).astype(np.int32))
        cache["dense_h_idx"] = out
    h = jnp.zeros((n * n,), dtype=acc)
    for key, (idx, o, idx_t) in cache["dense_h_idx"].items():
        # value groups carry a trailing TRASH row (masked contributions);
        # only the first K real-block rows scatter into H
        v = values[key][: idx.shape[0]].astype(acc)
        h = h.at[problem.const(("dense_h", key), idx).reshape(-1)].add(
            v.reshape(-1))
        if o.shape[0]:
            vo = v[problem.const(("dense_h_o", key), o)]
            h = h.at[
                problem.const(("dense_h_t", key), idx_t).reshape(-1)
            ].add(vo.reshape(-1))
    return h.reshape(n, n)


def hessian_to_dense(problem, hs: HessianStructure,
                     values: HessianValues) -> np.ndarray:
    """Dense reconstruction for tests/oracles."""
    n = problem.dim_h
    H = np.zeros((n, n))
    offsets = problem.block_offsets
    dims = problem.block_dims
    for i in range(hs.n_blocks):
        r, c = int(hs.block_rows[i]), int(hs.block_cols[i])
        key = hs.group_keys[hs.group_of_block[i]]
        blk = np.asarray(
            values[key][hs.index_in_group[i]], dtype=np.float64
        ).reshape(key)
        r0, c0 = int(offsets[r]), int(offsets[c])
        H[r0:r0 + key[0], c0:c0 + key[1]] += blk
        if r != c:
            H[c0:c0 + key[1], r0:r0 + key[0]] += blk.T
    return H
