"""Schur complement: explicit S = Hpp - Hpl Hll^{-1} Hpl^T.

JAX analog of ``SchurComplement<T,S>`` (reference:
include/graphite/schur.hpp:87-1115 + ops/schur.hpp:21-282).

Structure discovery (host NumPy, once per topology):
- pose blocks = Hessian block columns < ``elimination_block``; landmark
  blocks = the trailing eliminated columns (graph.hpp:109-149);
- Schur fill-in: for every landmark, every ordered pair of pose blocks it
  touches (the reference's per-landmark pair discovery kernels,
  schur.hpp:397-476) unioned with the Hpp sparsity (Hpp copy ops,
  :616-647);
- triple-product work list ``dst -= left * mid * right^T`` grouped by
  (dp_a, dl, dp_b) dims — exactly the reference's ``ProductDim``-grouped
  ``MulOp`` lists (:484-585) — here executed as ONE gather + batched
  block product + segment_sum per group instead of per-dim CUDA kernels
  (ops/schur.hpp:117-188);
- Hll diagonal inversion grouped by block dim (cuBLAS matinvBatched with
  dim<=32, :1000-1114) becomes batched closed-form/Cholesky SPD inverses
  with no dim limit.

Runtime values (`schur_values`) consume *damped* Hessian block values, so
Schur-level damping is a no-op (block_jacobi_schur.hpp:153-155). Unlike the
reference, which requires T==S and no low-precision for the Schur path
(schur.hpp:109-113), the computation here always runs in ``InvP`` precision
regardless of the Jacobian storage dtype.

Also provided: ``b_schur = b_p - Hpl Hll^{-1} b_l`` (:886-920), the S
block matvec for PCG (:307-393), and landmark back-substitution
``dx_l = Hll^{-1} (b_l - Hpl^T dx_p)`` (:279-302).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import hostops
from .graph import with_matmul_precision
from .hessian import HessianValues, build_hessian_structure
from .ops.batched_linalg import spd_inverse_flat
from .ops.blockfmt import (
    flat_block_mm_nn,
    flat_block_mm_nt,
    flat_block_mv,
    flat_block_mv_t,
)
from .ops.chunked import device_bytes_limit, scan_accumulate
# Shared reduction helpers; underscore aliases kept so tests can
# monkeypatch via this namespace.
from .ops.streamreduce import (
    map_chunk_rows as _map_chunk_rows,
    mapped_rows as _mapped_rows,
    maybe_rows as _maybe_rows,
    reduce_rows as _reduce_rows,
)

# One-shot W = Hpl Hll^{-1} expansion-transient budget: (K, dl*dl) f32.
W_EXPAND_BYTES = 1 << 29

# Triple products run as one gather + product + segment_sum while their
# transient (rows x row bytes) stays within 1/TRANSIENT_SHARE of the
# device's memory; above it they fold through lax.scan chunks of CHUNK
# rows. Backends that report no memory limit (the CPU) use the fixed
# CHUNK_THRESHOLD row bound instead (tests lower it to force the fold).
TRANSIENT_SHARE = 4
CHUNK_THRESHOLD = 1 << 22
CHUNK = 1 << 16


def _chunk_threshold(row_bytes: int) -> int:
    """Largest product batch (rows) that runs without scan chunking."""
    limit = device_bytes_limit()
    if limit is None:
        return CHUNK_THRESHOLD
    return limit // TRANSIENT_SHARE // max(row_bytes, 1)


@dataclasses.dataclass
class SchurStructure:
    """Static (host) description of the Schur system."""

    dim_p: int  # pose columns
    n_pose_blocks: int
    pose_offsets: np.ndarray  # (n_pose_blocks+1,) column offsets
    pose_dims: np.ndarray

    # landmark diagonal blocks, grouped by dim
    lm_dims: List[int]
    lm_h_idx: Dict[int, np.ndarray]  # dim -> indices into H group (d,d)
    lm_col_offset: Dict[int, np.ndarray]  # dim -> column offset (into dim_h)
    lm_group_index: np.ndarray  # per absolute landmark block id -> idx in its dim group
    lm_dim_of: np.ndarray  # per absolute landmark block id -> dim

    # Hpl blocks grouped by (dp, dl)
    hpl_keys: List[Tuple[int, int]]
    hpl_h_idx: Dict[Tuple[int, int], np.ndarray]  # idx into H group (dp,dl)
    hpl_pose: Dict[Tuple[int, int], np.ndarray]  # pose block id
    hpl_lm: Dict[Tuple[int, int], np.ndarray]  # absolute landmark block id

    # S blocks (upper-tri, CSC sorted), grouped by (dr, dc)
    s_keys: List[Tuple[int, int]]
    s_sizes: Dict[Tuple[int, int], int]
    s_rows: Dict[Tuple[int, int], np.ndarray]  # pose block ids
    s_cols: Dict[Tuple[int, int], np.ndarray]
    # Hpp copy: per (H group key) -> (h_idx, s_key, s_idx)
    hpp_copy: List[Tuple[Tuple[int, int], np.ndarray, np.ndarray]]
    # triple products grouped by (dpa, dl, dpb):
    # arrays (left hpl key+idx, mid dim group idx, right hpl key+idx, dst s key+idx, flip)
    products: List[dict]
    # S diagonal blocks per pose block: (s_key index, idx) for preconditioner
    s_diag_key: np.ndarray  # (n_pose_blocks,) index into s_keys
    s_diag_idx: np.ndarray
    # block -> (vertex type, row-in-type-segment) for row-shaped IO
    block_type: np.ndarray  # (n_blocks_total,) unicode type names
    block_row: np.ndarray  # (n_blocks_total,)


def build_schur_structure(problem) -> SchurStructure:
    if "schur_structure" in problem._cache:
        return problem._cache["schur_structure"]
    from .perf import SectionTimer
    _tm = SectionTimer("schur_structure")
    hs = build_hessian_structure(problem)
    _tm.lap("hessian_structure")
    eb = problem.elimination_block
    nb_total = problem.n_blocks
    if eb >= nb_total:
        raise ValueError(
            "no eliminated vertices: call set_eliminate(True) on the "
            "landmark vertex set before freeze (vertex.hpp:293)"
        )
    dims = problem.block_dims
    offsets = problem.block_offsets
    dim_p = problem.elimination_col
    n_pose = eb
    n_lm = nb_total - eb
    rows_h, cols_h = hs.block_rows, hs.block_cols

    if np.any((rows_h >= eb) & (cols_h >= eb) & (rows_h != cols_h)):
        raise ValueError(
            "Hll is not block-diagonal: factors connect two eliminated "
            "vertices; Schur elimination requires landmark-only factors "
            "to be absent (as in the reference BAL setup)"
        )

    def _cumcount(group_ids, n_groups):
        """Rank within group, preserving order."""
        counts = np.bincount(group_ids, minlength=n_groups)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        out = np.empty(group_ids.shape[0], dtype=np.int64)
        perm = hostops.stable_argsort(group_ids, n_groups)
        out[perm] = np.arange(group_ids.shape[0]) - np.repeat(starts, counts)
        return out

    # --- landmark diagonal blocks by dim (vectorized) ---
    lm_j = np.arange(eb, nb_total)
    lm_dim_of = dims[lm_j].astype(np.int64)
    lm_dims = sorted(set(int(d) for d in np.unique(lm_dim_of)))
    lm_h_idx: Dict[int, np.ndarray] = {}
    lm_col_offset: Dict[int, np.ndarray] = {}
    dim_rank = {d: i for i, d in enumerate(lm_dims)}
    lm_group_index = _cumcount(
        np.asarray([dim_rank[int(d)] for d in lm_dim_of]), len(lm_dims)
    )
    for d in lm_dims:
        sel = lm_j[lm_dim_of == d]
        assert np.all(hs.diag_group[sel] >= 0), "landmark without a diagonal block"
        lm_h_idx[d] = hs.diag_idx[sel].astype(np.int32)
        lm_col_offset[d] = offsets[sel].astype(np.int64)

    _tm.lap("lm_groups")
    # --- classify H blocks (vectorized) ---
    is_hpp = cols_h < eb
    is_hpl = (~is_hpp) & (rows_h < eb)
    hpl_sel = np.nonzero(is_hpl)[0]  # CSC order: sorted by (lm, pose)
    hpl_dims_r = dims[rows_h[hpl_sel]]
    hpl_dims_c = dims[cols_h[hpl_sel]]
    hpl_code = hpl_dims_r * 100000 + hpl_dims_c
    hpl_keys: List[Tuple[int, int]] = []
    hpl_h_idx: Dict[Tuple[int, int], np.ndarray] = {}
    hpl_pose: Dict[Tuple[int, int], np.ndarray] = {}
    hpl_lm: Dict[Tuple[int, int], np.ndarray] = {}
    key_id_of = np.zeros(hpl_sel.shape[0], dtype=np.int32)
    idx_in_key = np.zeros(hpl_sel.shape[0], dtype=np.int32)
    for code in hostops.sorted_unique(hpl_code):
        key = (int(code // 100000), int(code % 100000))
        m = hpl_code == code
        sel = hpl_sel[m]
        ki = len(hpl_keys)
        hpl_keys.append(key)
        hpl_h_idx[key] = hs.index_in_group[sel].astype(np.int32)
        hpl_pose[key] = rows_h[sel].astype(np.int64)
        hpl_lm[key] = (cols_h[sel] - eb).astype(np.int64)
        key_id_of[m] = ki
        idx_in_key[m] = np.arange(sel.shape[0])

    _tm.lap("hpl_groups")
    # --- per-landmark attach lists + pose-pair fill-in discovery
    # (schur.hpp:397-476; native C++ with NumPy fallback) ---
    att_lm = cols_h[hpl_sel] - eb
    att_pose = rows_h[hpl_sel]
    # Single-(dp,dl)-group fast path (uniform dims, e.g. BAL): the pair
    # fill emits left/right attach values directly — no ai/bi arrays and
    # no 17M-row gathers.
    single_pair_group = len(hpl_keys) == 1 and len(lm_dims) == 1
    hpp_sel = np.nonzero(is_hpp)[0]
    hpp_codes = cols_h[hpp_sel] * n_pose + rows_h[hpp_sel]
    plan_sorted = None
    if single_pair_group:
        # Fused native plan: pair histogram (no pair materialization) +
        # S sparsity scan + regeneration scattered straight into
        # dst-sorted order — replaces pair fill + bounded unique +
        # counting sort (~3 fewer 17M-row passes at Venice-Final).
        plan_sorted = hostops.schur_pair_plan(
            att_lm, att_pose, n_lm, n_pose, idx_in_key, hpp_codes)
    if plan_sorted is not None:
        (att_order, left_s, right_s, mid_s, dst_s, s_codes,
         hpp_pos) = plan_sorted
        pair_pos = pair_lm = pair_codes = None
    elif single_pair_group:
        (att_order, left_v, right_v, pair_lm,
         pair_codes) = hostops.attach_pairs_vals(
            att_lm, att_pose, n_lm, n_pose, idx_in_key)
    else:
        (att_order, counts, seg_off, ai, bi, pair_lm, pair_codes,
         pose_a, pose_b) = hostops.attach_pairs(att_lm, att_pose, n_lm,
                                                n_pose)
        att_key_s = key_id_of[att_order]
        att_idx_s = idx_in_key[att_order]

    _tm.lap("attach_pairs")
    # --- S sparsity: union of Hpp coords and fill-in pairs. One
    # bounded-rank pass gives both the unique S codes and, via the
    # inverse, every Hpp block's and every pair's destination position
    # (already produced by the fused plan when it ran) ---
    if plan_sorted is None:
        s_codes, s_inverse = hostops.unique_inverse(
            np.concatenate([hpp_codes, pair_codes]), bound=n_pose * n_pose)
        hpp_pos = s_inverse[: hpp_codes.shape[0]]
        pair_pos = s_inverse[hpp_codes.shape[0]:]
    _tm.lap("s_sparsity.unique")
    s_rows_all = (s_codes % n_pose).astype(np.int64)
    s_cols_all = (s_codes // n_pose).astype(np.int64)
    ns_total = s_codes.shape[0]
    s_dim_code = dims[s_rows_all] * 100000 + dims[s_cols_all]
    _maxd = int(dims.max()) if dims.size else 1
    uniq_sdims, s_group_of = hostops.unique_inverse(
        s_dim_code, bound=_maxd * 100000 + _maxd + 1)
    s_keys = [(int(c // 100000), int(c % 100000)) for c in uniq_sdims]
    s_index_in_group = _cumcount(s_group_of, len(s_keys))
    s_sizes = {
        key: int(c)
        for key, c in zip(s_keys, np.bincount(s_group_of,
                                              minlength=len(s_keys)))
    }
    s_rows = {key: s_rows_all[s_group_of == gi]
              for gi, key in enumerate(s_keys)}
    s_cols = {key: s_cols_all[s_group_of == gi]
              for gi, key in enumerate(s_keys)}

    _tm.lap("s_sparsity")
    # --- Hpp copy ops grouped by H group (vectorized) ---
    hpp_copy = []
    hpp_dims_code = (dims[rows_h[hpp_sel]] * 100000 + dims[cols_h[hpp_sel]])
    hpp_s_idx = s_index_in_group[hpp_pos]
    for code in np.unique(hpp_dims_code):
        key = (int(code // 100000), int(code % 100000))
        m = hpp_dims_code == code
        hpp_copy.append(
            (key, hs.index_in_group[hpp_sel[m]].astype(np.int32),
             hpp_s_idx[m].astype(np.int32))
        )

    _tm.lap("hpp_copy")
    # --- triple products grouped by (dpa, dl, dpb), dst-sorted + chunked.
    # Single-group fast path (uniform block dims, e.g. BAL): no per-group
    # masks over the pair arrays ---
    products = []
    if single_pair_group:
        # Uniform-dims fast path (BAL): one (dpa, dl, dpb) group; with a
        # single S group, index_in_group is the identity (dst = pair_pos),
        # with a single lm dim lm_group_index is the identity
        # (mid = pair_lm), and left/right came straight from the pair
        # fill — no 17M-row gathers.
        dp, dl = hpl_keys[0]
        dst_key = (dp, dp)
        if plan_sorted is None:
            if len(s_keys) == 1:
                dst = pair_pos.astype(np.int32)
            else:
                dst = s_index_in_group[pair_pos].astype(np.int32)
            _tm.lap("products.gather")
            # one native pass: stable counting sort by dst applied to
            # left/right/mid instead of perm materialization + 4 gathers
            dst_s, left_s, right_s, mid_s = hostops.sort_apply3(
                dst, s_sizes[dst_key], left_v, right_v, pair_lm)
            _tm.lap("products.sort")
        elif len(s_keys) > 1:
            # fused plan emitted GLOBAL s ranks; remap to in-group index
            # (monotone within the pair group — order preserved)
            dst_s = s_index_in_group[dst_s].astype(np.int32)
        products.append(
            dict(
                dims=(dp, dl, dp),
                left_key=hpl_keys[0], right_key=hpl_keys[0],
                dst_key=dst_key,
                left=left_s, right=right_s, mid=mid_s, dst=dst_s,
            )
        )
        _tm.lap("products.apply_perm")
    else:
        dst_idx_all = s_index_in_group[pair_pos]
        dst_group_all = s_group_of[pair_pos]
        dpa_all = dims[pose_a]
        dpb_all = dims[pose_b]
        dl_all = lm_dim_of[pair_lm]
        tri_code = (dpa_all * 100000 + dl_all) * 100000 + dpb_all
        for code in hostops.sorted_unique(tri_code):
            m = tri_code == code
            dpa = int(code // (100000 * 100000))
            dl = int((code // 100000) % 100000)
            dpb = int(code % 100000)
            lkeys = att_key_s[ai[m]]
            rkeys = att_key_s[bi[m]]
            assert np.all(lkeys == lkeys[0]) and np.all(rkeys == rkeys[0])
            dst_g = dst_group_all[m]
            assert np.all(dst_g == dst_g[0])
            dst_key = s_keys[int(dst_g[0])]
            left = att_idx_s[ai[m]].astype(np.int32)
            right = att_idx_s[bi[m]].astype(np.int32)
            mid = lm_group_index[pair_lm[m]].astype(np.int32)
            dst = dst_idx_all[m].astype(np.int32)
            order = hostops.stable_argsort(dst, s_sizes[dst_key])
            products.append(
                dict(
                    dims=(dpa, dl, dpb),
                    left_key=hpl_keys[int(lkeys[0])],
                    right_key=hpl_keys[int(rkeys[0])],
                    dst_key=dst_key,
                    left=left[order], right=right[order],
                    mid=mid[order], dst=dst[order],
                )
            )

    # Product RIGHT operands are gathered straight from the (dp, dl)
    # H value group (hvals[right_key]) at runtime, but the pair lists
    # index among the group's HPL blocks only. Compose through hpl_h_idx
    # so MIXED groups (dp == dl: the group also holds diagonal / Hpp
    # blocks) read the correct rows — exact identity for BAL-style
    # pure-Hpl groups, so the hot path is unchanged.
    for pg in products:
        hidx = hpl_h_idx[pg["right_key"]]
        n_h = hidx.shape[0]
        if not (n_h and int(hidx[0]) == 0 and int(hidx[-1]) == n_h - 1
                and np.array_equal(hidx,
                                   np.arange(n_h, dtype=hidx.dtype))):
            pg["right"] = hidx[pg["right"]].astype(np.int32)

    _tm.lap("products")
    # --- S diagonal lookup (vectorized) ---
    diag_codes = np.arange(n_pose) * n_pose + np.arange(n_pose)
    pos = np.searchsorted(s_codes, diag_codes)
    pos_c = np.clip(pos, 0, max(ns_total - 1, 0))
    found = (ns_total > 0) & (s_codes[pos_c] == diag_codes)
    s_diag_key = np.where(found, s_group_of[pos_c], -1).astype(np.int64)
    s_diag_idx = np.where(found, s_index_in_group[pos_c], 0).astype(np.int64)

    # --- block -> (type, row) for row-shaped vector IO (vectorized:
    # per-block Python tuples cost seconds at 1.1M blocks) ---
    bv = problem.block_vertex
    block_type = bv.type_of()
    block_row = np.empty(nb_total, dtype=np.int64)
    for ti, tname in enumerate(bv.type_names):
        m = bv.type_codes == ti
        if np.any(m):
            block_row[m] = (
                problem.host.vertex_active_row[tname][bv.local_ids[m]])

    ss = SchurStructure(
        dim_p=dim_p,
        n_pose_blocks=n_pose,
        pose_offsets=offsets[: n_pose + 1].copy(),
        pose_dims=dims[:n_pose].copy(),
        lm_dims=lm_dims,
        lm_h_idx=lm_h_idx,
        lm_col_offset=lm_col_offset,
        lm_group_index=lm_group_index,
        lm_dim_of=lm_dim_of,
        hpl_keys=hpl_keys,
        hpl_h_idx=hpl_h_idx,
        hpl_pose=hpl_pose,
        hpl_lm=hpl_lm,
        s_keys=s_keys,
        s_sizes=s_sizes,
        s_rows=s_rows,
        s_cols=s_cols,
        hpp_copy=hpp_copy,
        products=products,
        s_diag_key=s_diag_key,
        s_diag_idx=s_diag_idx,
        block_type=block_type,
        block_row=block_row,
    )
    _tm.lap("diag_and_block_maps")
    _tm.done()
    problem._cache["schur_structure"] = ss
    return ss


# --------------------------------------------------------------------------
# Runtime values (jit)
# --------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SchurValues:
    hll_inv: Dict[int, jax.Array]  # dim -> (Lg, d*d) flat
    s_vals: Dict[Tuple[int, int], jax.Array]  # key -> (nS_g, dr*dc) flat


def _product_sum(W, R, left, right, dst, dims, k: int, ns: int, inv_dt):
    """sum_pairs W[left] R[right]^T into ``ns`` destination blocks
    (ops/schur.hpp:117-188, the reference's triple-product kernels, whose
    atomicAdd scatter is what XLA's segment_sum lowers to on the GPU).

    ``dst`` is non-decreasing (the freeze-time plans sort it); ids equal
    to ``ns`` land in a trash row. Above the transient budget the pairs
    fold through scan chunks, whose padding rows also target the trash
    row. Returns (ns, dpa*dpb).
    """
    dpa, dl, dpb = dims

    def body(carry, arrays):
        li, ri, di = arrays
        prod = flat_block_mm_nt(W[li], R[ri].astype(inv_dt), dpa, dl, dpb,
                                acc_dtype=inv_dt)
        return carry + jax.ops.segment_sum(
            prod, di, num_segments=ns + 1, indices_are_sorted=True)

    acc0 = jnp.zeros((ns + 1, dpa * dpb), dtype=inv_dt)
    row_bytes = (dpa * dpb + (dpa + dpb) * dl) * jnp.dtype(inv_dt).itemsize
    if k <= _chunk_threshold(row_bytes):
        return body(acc0, (left, right, dst))[:ns]
    return scan_accumulate(body, (left, right, dst), k, CHUNK, acc0,
                           fills=[0, 0, ns])[:ns]


@with_matmul_precision
def schur_values(problem, ss: SchurStructure,
                 hvals: HessianValues) -> SchurValues:
    """S = Hpp - Hpl Hll^{-1} Hpl^T from damped H values
    (schur.hpp:227-235: Hpp copy -> block inversion -> triple products).

    All block batches are stored flat 2-D (ops/blockfmt.py); 3-D views exist
    only transiently inside fused einsums.
    """
    inv_dt = problem.precision.inv_dtype

    # 1. Hll^{-1} per dim group (schur.hpp:1067-1114) — flat 2-D closed
    # form with identity gathers eliminated.
    hll_inv = {}
    for d in ss.lm_dims:
        hll_flat = _maybe_rows(problem, ("lm_h_idx", d), hvals[(d, d)],
                               ss.lm_h_idx[d])
        hll_inv[d] = spd_inverse_flat(hll_flat.astype(inv_dt), d)

    # 2. S storage: copy Hpp (schur.hpp:587-614).
    s_vals = {
        key: jnp.zeros((ss.s_sizes[key], key[0] * key[1]), dtype=inv_dt)
        for key in ss.s_keys
    }
    for hi, (hkey, h_idx, s_idx) in enumerate(ss.hpp_copy):
        s_vals[hkey] = s_vals[hkey].at[
            problem.const(("hpp_s", hi), s_idx)
        ].add(
            hvals[hkey][problem.const(("hpp_h", hi), h_idx)].astype(inv_dt)
        )

    # 3. Triple products (schur.hpp:649-734). First precompute
    # W = Hpl * Hll^{-1} once per Hpl BLOCK (one small gather), so each
    # product is W_left * Hpl_right^T — one fewer big gather per product
    # than the naive L,M,R form (Hll_inv is symmetric, so L M R^T =
    # (L M) R^T exactly).
    hpl_w: Dict[Tuple[int, int], jax.Array] = {}
    for key in ss.hpl_keys:
        dp, dl = key
        # identity gathers eliminated: hpl_h_idx is iota when the (dp,dl)
        # H group holds exactly the Hpl blocks in CSC order (BAL)
        hpl_flat = _maybe_rows(problem, ("hpl_h", key), hvals[key],
                               ss.hpl_h_idx[key])
        K = hpl_flat.shape[0]
        gi_np = ss.lm_group_index[ss.hpl_lm[key]].astype(np.int32)

        # CSC landmark-major order makes gi NON-DECREASING (every obs of a
        # landmark is contiguous), so the Hll^{-1} lookup can be a
        # repeat-EXPANSION with host-side counts instead of a gather.
        # One-shot: the (K, dl*dl) expansion transient is bounded by
        # W_EXPAND_BYTES.
        wcache = problem._cache.setdefault("hpl_w_expand", {})
        if key not in wcache:
            is_sorted = bool(gi_np.size == 0
                             or np.all(np.diff(gi_np) >= 0))
            counts = None
            if is_sorted:
                counts = np.bincount(
                    gi_np, minlength=int(ss.lm_h_idx[dl].shape[0]),
                ).astype(np.int32)
            wcache[key] = (is_sorted, counts)
        is_sorted, counts_np = wcache[key]

        if is_sorted and K * dl * dl * 4 <= W_EXPAND_BYTES:
            # barrier: hll_inv is a computed expression here — without the
            # fence XLA fuses the 3x3 inverse INTO the repeat's gather and
            # recomputes it per OBSERVATION; materializing the (n_lm, 9)
            # table first keeps it per landmark
            inv_exp = jnp.repeat(
                jax.lax.optimization_barrier(hll_inv[dl]),
                problem.const(("hpl_w_counts", key), counts_np),
                axis=0, total_repeat_length=K)
            hpl_w[key] = flat_block_mm_nn(
                hpl_flat.astype(inv_dt), inv_exp, dp, dl, dl,
                acc_dtype=inv_dt)
        else:
            lm_gidx = problem.const(("hpl_lm_gidx", key), gi_np)

            def w_body(chunk_arrays, dp=dp, dl=dl, inv=hll_inv[dl]):
                hf, gi = chunk_arrays
                return flat_block_mm_nn(hf.astype(inv_dt), inv[gi],
                                        dp, dl, dl, acc_dtype=inv_dt)

            hpl_w[key] = _mapped_rows(
                w_body, (hpl_flat, lm_gidx), K,
                (dp * dl * 2 + dl * dl) * 4)

    # Inside a factor-sharded shard_map with a known mesh size, the triple
    # products — the dominant stage at scale (schur.hpp:484-585: the work
    # lists are already grouped; we shard the groups) — are partitioned
    # across devices BY DESTINATION RANGE: the pair list is dst-sorted, so
    # segment-aligned contiguous slices give each device ~K/n products
    # whose outputs land in a disjoint S-block range. Each device reduces
    # only its own range, and ONE all-gather of the disjoint slices
    # replaces a full (ns, d*d)-accumulator psum per group. Everything
    # upstream (psum'd H values, Hll^{-1}, W) is replicated and cheap by
    # comparison.
    nsh = problem.psum_size if problem.psum_axis is not None else None
    if nsh is not None and nsh > 1:
        i_dev = jax.lax.axis_index(problem.psum_axis)
        for gi, pg in enumerate(ss.products):
            key = pg["dst_key"]
            sp = _plan_sharded_partition(problem, gi, pg, nsh)

            def dev_row(name, arr, gi=gi):
                c = problem.const(("shprod", name, gi, nsh), arr)
                return jax.lax.dynamic_index_in_dim(
                    c, i_dev, 0, keepdims=False)

            local = _product_sum(
                hpl_w[pg["left_key"]], hvals[pg["right_key"]],
                dev_row("l", sp["left"]), dev_row("r", sp["right"]),
                dev_row("seg", sp["seg"]), pg["dims"], sp["k_pad"],
                sp["ns_max"], inv_dt)
            # disjoint-slice combine: all devices receive every device's
            # ns_max-row slice once and place it at its static offset
            gathered = jax.lax.all_gather(local, problem.psum_axis)
            for d in range(nsh):
                ns_d = sp["ns_list"][d]
                if ns_d:
                    s0 = sp["seg0"][d]
                    s_vals[key] = s_vals[key].at[s0:s0 + ns_d].add(
                        -gathered[d, :ns_d])
        return SchurValues(hll_inv=hll_inv, s_vals=s_vals)

    for gi, pg in enumerate(ss.products):
        key = pg["dst_key"]
        # dst -= W R^T (ops/schur.hpp:117-188) as a fused flat 2-D block
        # product feeding one sorted segment_sum
        s_vals[key] = s_vals[key] - _product_sum(
            hpl_w[pg["left_key"]], hvals[pg["right_key"]],
            problem.const(("prod_l", gi), pg["left"]),
            problem.const(("prod_r", gi), pg["right"]),
            problem.const(("prod_dst", gi), pg["dst"]),
            pg["dims"], pg["dst"].shape[0], ss.s_sizes[key], inv_dt)
    return SchurValues(hll_inv=hll_inv, s_vals=s_vals)


def _plan_sharded_partition(problem, gi, pg, nsh):
    """Freeze-time plan (cached) for the dst-partitioned sharded product
    stage: segment-aligned contiguous per-device pair ranges (≈ K/nsh
    rows each), with per-device gather and segment arrays padded to a
    common k_pad. Pad rows gather row 0 and target the trash segment
    ns_max, so every device's segment ids stay non-decreasing."""
    cache = problem._cache.setdefault("sharded_product_plans", {})
    ck = (gi, nsh)
    if ck in cache:
        return cache[ck]

    dst = pg["dst"]
    K = dst.shape[0]
    bounds = [0]
    for p in range(1, nsh):
        idx = p * (K // nsh)
        # align down to a segment boundary so ranges never split a segment
        idx = int(np.searchsorted(dst, dst[min(idx, max(K - 1, 0))],
                                  side="left"))
        bounds.append(max(idx, bounds[-1]))
    bounds.append(K)

    seg_slices, ns_list, seg0s, lefts, rights, rows = [], [], [], [], [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi > lo:
            seg0 = int(dst[lo])
            ns_d = int(dst[hi - 1]) - seg0 + 1
        else:
            seg0, ns_d = 0, 0
        seg_slices.append(dst[lo:hi].astype(np.int64) - seg0)
        ns_list.append(ns_d)
        seg0s.append(seg0)
        lefts.append(pg["left"][lo:hi])
        rights.append(pg["right"][lo:hi])
        rows.append(hi - lo)

    k_pad = max(max(rows), 1)
    ns_max = max(ns_list)

    def stackpad(arrs, fill):
        out = np.full((nsh, k_pad), fill, dtype=np.int32)
        for i, a in enumerate(arrs):
            out[i, :a.shape[0]] = a
        return out

    cache[ck] = dict(
        k_pad=k_pad, ns_max=ns_max, ns_list=ns_list, seg0=seg0s, rows=rows,
        left=stackpad(lefts, 0), right=stackpad(rights, 0),
        seg=stackpad(seg_slices, ns_max),
    )
    return cache[ck]


def _partition_blocks_by_type(ss: SchurStructure, block_ids: np.ndarray):
    """Split an array of Hessian-block ids by vertex type.

    Returns [(type_name, sel, rows)] where ``sel`` indexes into ``block_ids``
    and ``rows`` are the blocks' rows within the type's segment. One
    partition per type (a single partition for the common one-pose-type /
    one-landmark-type case, so no overhead there).
    """
    types = np.asarray(ss.block_type)[block_ids]
    out = []
    for t in np.unique(types):
        sel = np.nonzero(types == t)[0]
        out.append((str(t), sel, ss.block_row[block_ids[sel]]))
    return out


def _smv_chunk_rows(row_bytes: int) -> int:
    """Scan-chunk rows for the folded S matvec (same byte budget as
    streamreduce.map_chunk_rows; separate symbol so tests can monkeypatch
    it to force the fold, or the stepwise path, at toy scale)."""
    return _map_chunk_rows(row_bytes)


class SchurOps:
    """Bundles static structure with one set of (damped) H values.

    All vector IO is row-shaped per vertex type (free reshapes under the
    type-major column layout).
    """

    def __init__(self, problem, ss: SchurStructure, hvals: HessianValues,
                 sv: SchurValues):
        self.problem = problem
        self.ss = ss
        self.hvals = hvals
        self.sv = sv
        self._gdt = problem.precision.graph_dtype

    def hpl(self, key):
        return _maybe_rows(self.problem, ("hpl_h", key), self.hvals[key],
                           self.ss.hpl_h_idx[key])

    def _cached_partition(self, tag, block_ids):
        cache = self.problem._cache.setdefault("schur_partitions", {})
        if tag not in cache:
            cache[tag] = _partition_blocks_by_type(self.ss, block_ids)
        return cache[tag]

    def _hll_solve_rows(self, t_rows: Dict[str, jax.Array]
                        ) -> Dict[str, jax.Array]:
        """w = Hll^{-1} t per landmark type (rows in type-row order)."""
        problem = self.problem
        ss = self.ss
        out = {}
        eb = problem.elimination_block
        lm_ids = np.arange(eb, problem.n_blocks)
        for t, sel, rows in self._cached_partition("lm_diag", lm_ids):
            d = problem.vertex_meta[t].vtype.dim
            # landmarks of this type, ordered by row == block order ✓
            order = np.argsort(rows, kind="stable")
            gidx = ss.lm_group_index[sel[order]].astype(np.int32)
            inv_flat = _maybe_rows(self.problem, ("hllsolve_gidx", t),
                                   self.sv.hll_inv[d], gidx)
            out[t] = flat_block_mv(inv_flat, t_rows[t], d, d,
                                   acc_dtype=inv_flat.dtype)
        return out

    def b_schur(self, b: jax.Array) -> jax.Array:
        """b_S = b_p - Hpl Hll^{-1} b_l (schur.hpp:886-920) -> (dim_p,)."""
        with jax.default_matmul_precision(
                self.problem.precision.matmul_precision), \
                jax.named_scope("b_schur"):
            return self._b_schur(b)

    def _b_schur(self, b: jax.Array) -> jax.Array:
        problem = self.problem
        ss = self.ss
        gdt = self._gdt
        b_l_rows = {
            t: problem.rows_view(b, t)
            for t, _, _ in self._cached_partition(
                "lm_diag", np.arange(problem.elimination_block,
                                     problem.n_blocks))
        }
        w = self._hll_solve_rows(b_l_rows)
        out_rows: Dict[str, jax.Array] = {}
        for key in ss.hpl_keys:
            dp, dl = key
            Hpl = self.hpl(key)
            lm_abs = ss.hpl_lm[key] + problem.elimination_block
            for pt, psel, prow in self._cached_partition(
                    f"hpl_pose_{key}", ss.hpl_pose[key]):
                # landmark rows for this subset (landmark type per entry)
                for lt, lsel, lrow in self._cached_partition(
                        f"hpl_lm_{key}_{pt}", lm_abs[psel]):
                    sub = psel[lsel]
                    ck = ("bschur", key, pt, lt)
                    K = sub.shape[0]
                    # Natural (lm, pose)-sorted order: the Hpl gather is
                    # typically iota (eliminated); the pose-row
                    # destination is unsorted with ~n_pose segments.
                    Hsub_flat = _maybe_rows(problem, ck + ("sub",), Hpl,
                                            sub)
                    # w lookup: in CSC order lrow is NON-DECREASING, so
                    # the lookup from the small (n_lm, dl) solve table is
                    # a repeat-EXPANSION (host counts), not a gather —
                    # same trick as the W build above (schur.hpp:886-920
                    # walks the same streams with atomicAdd).
                    bcache = problem._cache.setdefault("bschur_expand", {})
                    if ck not in bcache:
                        n_lm_rows = problem.seg_rows[lt]
                        is_sorted = bool(
                            lrow.size == 0 or np.all(np.diff(lrow) >= 0))
                        counts = None
                        if is_sorted:
                            counts = np.bincount(
                                lrow.astype(np.int64), minlength=n_lm_rows
                            ).astype(np.int32)
                        bcache[ck] = (is_sorted, counts)
                    is_sorted, counts_np = bcache[ck]

                    if is_sorted and K * dl * 4 <= W_EXPAND_BYTES:
                        w_exp = jnp.repeat(
                            jax.lax.optimization_barrier(w[lt]),
                            problem.const(ck + ("wcounts",), counts_np),
                            axis=0, total_repeat_length=K)

                        def y_body(chunk_arrays, dp=dp, dl=dl):
                            hf, we = chunk_arrays
                            return flat_block_mv(
                                hf, we, dp, dl,
                                acc_dtype=we.dtype).astype(gdt)

                        y = _mapped_rows(y_body, (Hsub_flat, w_exp), K,
                                         (dp * dl + dp + dl) * 4)
                    else:
                        lrow_c = problem.const(ck + ("lrow",),
                                               lrow.astype(np.int32))

                        def y_body(chunk_arrays, dp=dp, dl=dl, wlt=w[lt]):
                            hf, lr = chunk_arrays
                            return flat_block_mv(
                                hf, wlt[lr], dp, dl,
                                acc_dtype=wlt.dtype).astype(gdt)

                        y = _mapped_rows(y_body, (Hsub_flat, lrow_c), K,
                                         (dp * dl + dp + dl) * 4)
                    acc = _reduce_rows(problem, ck, y, prow[lsel],
                                       problem.seg_rows[pt])
                    prev = out_rows.get(pt)
                    out_rows[pt] = acc if prev is None else prev + acc
        flat = problem.flat_from_rows(
            {t: -v for t, v in out_rows.items()}, dtype=gdt
        )
        return flat[: ss.dim_p] + b[: ss.dim_p].astype(gdt)

    def s_matvec(self, x: jax.Array) -> jax.Array:
        """y = S x on (dim_p,) vectors (schur.hpp:307-393)."""
        with jax.default_matmul_precision(
                self.problem.precision.matmul_precision), \
                jax.named_scope("s_matvec"):
            return self._s_matvec(x)

    def _s_matvec(self, x: jax.Array) -> jax.Array:
        problem = self.problem
        ss = self.ss
        gdt = self._gdt
        y_rows: Dict[str, jax.Array] = {}

        def add_rows(t, acc):
            prev = y_rows.get(t)
            y_rows[t] = acc if prev is None else prev + acc

        for key in ss.s_keys:
            dr_k, dc_k = key
            S = self.sv.s_vals[key]
            rows_b, cols_b = ss.s_rows[key], ss.s_cols[key]
            for rt, rsel, rrow in self._cached_partition(
                    f"s_rows_{key}", rows_b):
                for ct, csel, crow in self._cached_partition(
                        f"s_cols_{key}_{rt}", cols_b[rsel]):
                    sub = rsel[csel]
                    ck = ("smv", key, rt, ct)
                    K = sub.shape[0]
                    rrow_l = rrow[csel]
                    x_ct = problem.rows_view(x, ct)
                    x_rt = problem.rows_view(x, rt)
                    # Forward S x in natural CSC order: the S-block gather
                    # is typically iota (eliminated); the row-block
                    # destination is unsorted but has only ~n_pose
                    # segments.
                    S_flat = _maybe_rows(problem, ck + ("sub",), S, sub)
                    crow_c = problem.const(ck + ("crow",),
                                           crow.astype(np.int32))

                    row_bytes = (dr_k * dc_k + dr_k + dc_k + 3) * 4
                    chunk = _smv_chunk_rows(row_bytes)
                    if K > chunk:
                        # Folded single-pass matvec for the scan regime:
                        # one scan reads each S block ONCE and folds both
                        # the forward (y_r += S x_c) and transposed
                        # (y_c += S^T x_r, off-diagonal only) segment sums
                        # into the carry — the stepwise path below reads
                        # S twice plus an off-diagonal S gather.
                        off = rows_b[sub] != cols_b[sub]
                        rrow_c = problem.const(
                            ck + ("rrow",), rrow_l.astype(np.int32))
                        offm = problem.const(
                            ck + ("offm",), off.astype(np.float32))
                        nseg_r = problem.seg_rows[rt]
                        nseg_c = problem.seg_rows[ct]

                        def fold_body(carry, chunk_arrays, dr_k=dr_k,
                                      dc_k=dc_k, x_ct=x_ct, x_rt=x_rt,
                                      nseg_r=nseg_r, nseg_c=nseg_c):
                            yr, yc = carry
                            sf, cr, rr, om = chunk_arrays
                            yf = flat_block_mv(sf, x_ct[cr], dr_k, dc_k,
                                               acc_dtype=gdt)
                            yt = flat_block_mv_t(sf, x_rt[rr], dr_k, dc_k,
                                                 acc_dtype=gdt)
                            yt = yt * om[:, None].astype(gdt)
                            yr = yr + jax.ops.segment_sum(
                                yf.astype(gdt), rr, num_segments=nseg_r)
                            yc = yc + jax.ops.segment_sum(
                                yt.astype(gdt), cr, num_segments=nseg_c)
                            return yr, yc

                        carry0 = (jnp.zeros((nseg_r, dr_k), gdt),
                                  jnp.zeros((nseg_c, dc_k), gdt))
                        yr, yc = scan_accumulate(
                            fold_body, (S_flat, crow_c, rrow_c, offm), K,
                            chunk, carry0)
                        add_rows(rt, yr)
                        add_rows(ct, yc)
                        continue

                    def y_fwd(chunk_arrays, dr_k=dr_k, dc_k=dc_k,
                              x_ct=x_ct):
                        sf, cr = chunk_arrays
                        return flat_block_mv(sf, x_ct[cr], dr_k, dc_k,
                                             acc_dtype=gdt)

                    y = _mapped_rows(y_fwd, (S_flat, crow_c), K,
                                     (dr_k * dc_k + dr_k + dc_k) * 4)
                    acc = _reduce_rows(problem, ck, y, rrow_l,
                                       problem.seg_rows[rt])
                    add_rows(rt, acc)
                    # transpose contribution for off-diagonal blocks: the
                    # CSC (col-major) storage order makes the column
                    # destination already sorted
                    off = rows_b[sub] != cols_b[sub]
                    if np.any(off):
                        o = np.nonzero(off)[0]
                        Ko = o.shape[0]
                        cko = ck + ("t",)
                        St_flat = _maybe_rows(problem, cko + ("sub",), S,
                                              sub[o])
                        rrow_o = problem.const(
                            cko + ("rr",), rrow_l[o].astype(np.int32))

                        def y_t(chunk_arrays, dr_k=dr_k, dc_k=dc_k,
                                x_rt=x_rt):
                            sf, rr = chunk_arrays
                            return flat_block_mv_t(sf, x_rt[rr], dr_k,
                                                   dc_k, acc_dtype=gdt)

                        y2 = _mapped_rows(y_t, (St_flat, rrow_o), Ko,
                                          (dr_k * dc_k + dr_k + dc_k) * 4)
                        acct = _reduce_rows(problem, cko, y2, crow[o],
                                            problem.seg_rows[ct])
                        add_rows(ct, acct)
        return problem.flat_from_rows(y_rows, dtype=gdt)[: ss.dim_p]

    def landmark_update(self, b: jax.Array,
                        dx_p: jax.Array) -> Dict[str, jax.Array]:
        """dx_l = Hll^{-1} (b_l - Hpl^T dx_p) (schur.hpp:279-302).

        Returns per-landmark-type rows (type-row order).
        """
        with jax.default_matmul_precision(
                self.problem.precision.matmul_precision), \
                jax.named_scope("landmark_update"):
            return self._landmark_update(b, dx_p)

    def _landmark_update(self, b: jax.Array,
                         dx_p: jax.Array) -> Dict[str, jax.Array]:
        problem = self.problem
        ss = self.ss
        gdt = self._gdt
        lm_ids = np.arange(problem.elimination_block, problem.n_blocks)
        t_rows = {
            t: problem.rows_view(b, t).astype(gdt)
            for t, _, _ in self._cached_partition("lm_diag", lm_ids)
        }
        for key in ss.hpl_keys:
            dp, dl = key
            Hpl = self.hpl(key)
            lm_abs = ss.hpl_lm[key] + problem.elimination_block
            for pt, psel, prow in self._cached_partition(
                    f"hpl_pose_{key}", ss.hpl_pose[key]):
                # dx_p rows in InvP precision, like every Schur stage
                x_pt = problem.rows_view(dx_p, pt).astype(
                    problem.precision.inv_dtype)
                for lt, lsel, lrow in self._cached_partition(
                        f"hpl_lm_{key}_{pt}", lm_abs[psel]):
                    sub = psel[lsel]
                    ck = ("lu", key, pt, lt)
                    K = sub.shape[0]
                    # Hpl is CSC (lm, pose)-sorted: lrow is already
                    # destination-sorted and `sub` is typically iota
                    # (gather eliminated).
                    Hsub_flat = _maybe_rows(problem, ck + ("sub",), Hpl,
                                            sub)
                    pr_c = problem.const(
                        ck + ("pr",), prow[lsel].astype(np.int32))

                    def y_body(chunk_arrays, dp=dp, dl=dl, x_pt=x_pt):
                        hf, pr = chunk_arrays
                        return flat_block_mv_t(hf, x_pt[pr], dp, dl,
                                               acc_dtype=gdt)

                    y = _mapped_rows(y_body, (Hsub_flat, pr_c), K,
                                     (dp * dl + dp + dl) * 4)
                    acc = _reduce_rows(problem, ck, y, lrow,
                                       problem.seg_rows[lt])
                    t_rows[lt] = t_rows[lt] - acc
        return self._hll_solve_rows(t_rows)

    def compose_delta(self, dx_p: jax.Array,
                      dx_l_rows: Dict[str, jax.Array]) -> jax.Array:
        """(dim_p,) pose delta + landmark rows -> full (dim_x,) delta."""
        problem = self.problem
        out = problem.flat_from_rows(dx_l_rows, dtype=self._gdt)
        return jax.lax.dynamic_update_slice(
            out, dx_p.astype(self._gdt), (0,)
        )
