"""Graph container and topology freeze.

JAX analog of the reference ``Graph<T,S>`` (include/graphite/graph.hpp:30-334)
plus the per-descriptor device setup (``initialize_optimization``,
graph.hpp:92-167; ``initialize_device_ids``, factor.hpp:455-524;
``deactivate_unused_vertices``, graph.hpp:171-210).

Design: all dynamic sparsity discovery happens **once per topology** on the
host in NumPy (`freeze`), producing

- static metadata (column offsets, block ids, elimination boundary) that jit
  sees as Python constants — relinearization never retraces, and
- a `GraphData` pytree of device arrays (indices, masks, observations) that
  jit sees as ordinary arguments.

Runtime level/fixed changes that the reference handles with `copy_if`
compaction (active.hpp:24-47) are handled here by *masks* so shapes stay
static; changing the topology itself (add/remove) means re-freezing — the
same cost point as the reference's `initialize_optimization`.

Column ordering parity: vertices are sorted by (eliminated, global_id) so
Schur-eliminated vertices occupy the trailing columns (graph.hpp:109-149);
`elimination_col` is the scalar column where the eliminated segment starts
(graph.hpp:134-140).

Fixed / inactive vertices get no Hessian column; their scatter target is a
"trash" pad region past ``dim_h`` (always ``pad`` wide) and their Jacobian
blocks are masked to zero — the static-shape equivalent of the reference's
``is_vertex_active`` guards (active.hpp:18-21).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .factors import MAX_LEVEL, FactorSet, FactorType
from .precision import FP32_FP32, Precision
from .vertices import VertexSet, VertexType


def with_matmul_precision(fn):
    """Run ``fn`` under the problem's matmul precision (see
    Precision.matmul_precision) and a named scope of its own name, which
    a profiler trace attributes the stage's device operations to."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        problem = next(a for a in args if hasattr(a, "precision"))
        with jax.default_matmul_precision(
                problem.precision.matmul_precision), \
                jax.named_scope(fn.__name__):
            return fn(*args, **kw)

    return wrapped


def is_factor_active(level_byte: np.ndarray, opt_level: int) -> np.ndarray:
    """Reference ``is_factor_active`` (active.hpp:11-15)."""
    return ((level_byte & MAX_LEVEL) <= opt_level) & ((level_byte & 0x80) == 0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class VertexArrays:
    """Per-vertex-type device arrays."""

    col_offset: jax.Array  # (V,) int32; dim_h for inactive (trash column)
    active: jax.Array  # (V,) bool
    active_row: jax.Array  # (V,) int32 row in the type's segment; trash row
    # (== n_active) for inactive vertices


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FactorArrays:
    """Per-factor-type device arrays."""

    ids: Tuple[jax.Array, ...]  # N arrays of (F,) int32 local vertex indices
    rows: Tuple[jax.Array, ...]  # N arrays of (F,) int32 active-row indices
    cols_base: jax.Array  # (F, N) int32 first Hessian column per slot
    obs: Optional[jax.Array]  # (F, *obs_shape) graph dtype or None
    data: Optional[jax.Array]
    precision: Optional[jax.Array]  # (F, E*E) flat, solver dtype; None ==
    # identity (flat 2-D storage: see ops/blockfmt.py)
    loss_params: jax.Array  # (F,) graph dtype
    factor_mask: jax.Array  # (F,) bool — active at frozen level
    slot_mask: jax.Array  # (F, N) bool — factor_mask & vertex-active per slot


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GraphData:
    """The dynamic (pytree) half of a frozen problem."""

    vertices: Dict[str, VertexArrays]
    factors: Dict[str, FactorArrays]


@dataclasses.dataclass(frozen=True)
class VertexMeta:
    vtype: VertexType
    count: int
    n_active: int


@dataclasses.dataclass(frozen=True)
class FactorMeta:
    ftype: FactorType
    count: int
    n_active: int
    store_jacobians: bool


class BlockVertexMap:
    """Array-backed block-id -> (vertex type, local index) map.

    Semantically the reference's per-block vertex bookkeeping
    (graph.hpp:109-149); stored as two NumPy arrays (type code + local id)
    because materializing one Python tuple per Hessian block is a
    multi-second loop at Venice-Final scale (1.1M blocks). Indexing
    returns the classic ``(name, local)`` tuple; vectorized consumers use
    ``type_codes`` / ``local_ids`` / ``type_of`` directly.
    """

    def __init__(self, type_names, type_codes: np.ndarray,
                 local_ids: np.ndarray):
        self.type_names: List[str] = list(type_names)
        self.type_codes = np.asarray(type_codes, dtype=np.int64)
        self.local_ids = np.asarray(local_ids, dtype=np.int64)

    def __len__(self) -> int:
        return self.type_codes.shape[0]

    def __getitem__(self, j):
        return (self.type_names[int(self.type_codes[j])],
                int(self.local_ids[j]))

    def __iter__(self):
        for t, l in zip(self.type_codes, self.local_ids):
            yield (self.type_names[int(t)], int(l))

    def type_of(self, ids=None) -> np.ndarray:
        """Type NAMES per block id as a NumPy unicode array (vectorized)."""
        names = np.asarray(self.type_names)
        codes = self.type_codes if ids is None else self.type_codes[ids]
        return names[codes]


class Problem:
    """A frozen, jit-ready optimization problem.

    Static attributes (host ints/NumPy — safe to close over in jit):
      dim_h: total Hessian dimension (active columns only).
      pad: width of the trash pad region; internal flat vectors have length
        ``dim_h + pad``.
      block_offsets: (n_blocks+1,) int64 — column offset of each Hessian
        block column, mirroring ``Graph::get_offset_vector`` (graph.hpp:53).
      block_vertex: per block id, (vertex type name, local index).
      block_dims: (n_blocks,) int64 tangent dims.
      elimination_block / elimination_col: first eliminated block / column
        (== n_blocks / dim_h when nothing is eliminated).

    Dynamic attribute:
      data: GraphData pytree (device arrays).
      params0: dict name -> (V, ambient_dim) initial parameters.
    """

    def __init__(self, meta_v, meta_f, data, params0, *,
                 dim_h, pad, block_offsets, block_vertex, block_dims,
                 elimination_block, elimination_col, opt_level,
                 precision, host, seg_start=None, seg_rows=None,
                 segment_order=None, row_vertex=None):
        self.vertex_meta: Dict[str, VertexMeta] = meta_v
        self.factor_meta: Dict[str, FactorMeta] = meta_f
        self.data: GraphData = data
        self.params0: Dict[str, jax.Array] = params0
        self.dim_h: int = dim_h
        self.pad: int = pad
        self.block_offsets: np.ndarray = block_offsets
        self.block_vertex: BlockVertexMap = block_vertex
        self.block_dims: np.ndarray = block_dims
        self.elimination_block: int = elimination_block
        self.elimination_col: int = elimination_col
        self.opt_level: int = opt_level
        self.precision: Precision = precision
        self.host = host  # host-side NumPy copies of index arrays/masks
        # Row-segment layout: each vertex type's active columns form one
        # contiguous [seg_start, seg_start + n_rows*dim) segment, so flat
        # vectors reshape to (n_rows, dim) per type for free.
        self.seg_start: Dict[str, int] = seg_start or {}
        self.seg_rows: Dict[str, int] = seg_rows or {}
        self.segment_order: List[str] = segment_order or []
        self.row_vertex: Dict[str, np.ndarray] = row_vertex or {}
        self._cache: dict = {}
        # When set (inside shard_map over a factor-sharded mesh axis),
        # cross-factor reductions (b, diag, chi2, J^T v, Hessian values) are
        # psum'ed over this axis — multi-device assembly.
        self.psum_axis = None
        self.psum_size = None  # mesh axis size (enables Schur-stage sharding)
        # Large static index arrays (Hessian/Schur scatter maps). When a
        # jitted entry point binds tracers (bind_consts), `const` returns the
        # corresponding argument tracer so multi-hundred-MB index arrays ride
        # as executable ARGUMENTS instead of being inlined into the HLO
        # (which makes the compiled module huge at Venice-1778 scale).
        self._const_store: dict = {}
        self._const_tracers = None

    # ---- const store -------------------------------------------------------
    def const(self, key, np_array):
        """Register/fetch a static device array by key.

        Inside a consts-bound trace, returns the argument tracer; otherwise
        returns the cached device array (inlined as an HLO constant — fine
        for small problems and eager use).
        """
        if key not in self._const_store:
            # store HOST arrays: converting inside a trace would capture a
            # tracer and leak it out of the transformation
            self._const_store[key] = np.asarray(np_array)
        if self._const_tracers is not None and key in self._const_tracers:
            return self._const_tracers[key]
        return jnp.asarray(self._const_store[key])

    def consts(self):
        """The full const dict as device arrays (pass as a jit argument).

        Only call outside of traces.
        """
        dev = self._cache.setdefault("const_device", {})
        for k, v in self._const_store.items():
            if k not in dev:
                dev[k] = jnp.asarray(v)
        return dict(dev)

    def bind_consts(self, tracers):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            prev = self._const_tracers
            self._const_tracers = tracers
            try:
                yield
            finally:
                self._const_tracers = prev

        return ctx()

    def bind_data(self, data):
        """Temporarily swap ``self.data`` (used by jit_with_consts so the
        GraphData pytree rides as an executable ARGUMENT — runtime remasking
        then only swaps array values, never retracing)."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            prev = self.data
            self.data = data
            try:
                yield
            finally:
                self.data = prev

        return ctx()

    def jit_with_consts(self, fn):
        """jit ``fn(*args)`` with this problem's static index arrays passed
        as arguments rather than inlined HLO constants.

        First call runs ``jax.eval_shape`` (abstract trace, no compile) to
        populate the const store, then compiles ``fn`` with the consts bound
        to argument tracers.
        """
        cell = {}
        mat_prec = self.precision.matmul_precision

        def wrapper(*args):
            if "f" not in cell:
                with jax.default_matmul_precision(mat_prec):
                    jax.eval_shape(fn, *args)  # registers consts, no compile

                def inner(consts, data, *a):
                    with self.bind_consts(consts), self.bind_data(data), \
                            jax.default_matmul_precision(mat_prec):
                        return fn(*a)

                cell["f"] = jax.jit(inner)
            return cell["f"](self.consts(), self.data, *args)

        wrapper._cell = cell  # introspection: tests assert no-retrace
        return wrapper

    # ---- row-view helpers (row-shaped gathers/scatters) -------------------
    def rows_view(self, x: jax.Array, vname: str) -> jax.Array:
        """Flat (dim_x,) -> (n_rows, dim) view of one type's segment."""
        d = self.vertex_meta[vname].vtype.dim
        n = self.seg_rows[vname]
        seg = jax.lax.dynamic_slice_in_dim(x, self.seg_start[vname], n * d, 0)
        return seg.reshape(n, d)

    def rows_view_padded(self, x: jax.Array, vname: str) -> jax.Array:
        """Row view plus one trailing zero trash row (index n_rows)."""
        rows = self.rows_view(x, vname)
        return jnp.concatenate(
            [rows, jnp.zeros((1, rows.shape[1]), dtype=rows.dtype)], axis=0
        )

    def flat_from_rows(self, rows: Dict[str, jax.Array],
                       dtype=None) -> jax.Array:
        """Per-type (n_rows, dim) arrays -> flat (dim_x,) vector (pad = 0).

        Missing types contribute zeros.
        """
        dtype = dtype or self.precision.graph_dtype
        parts = []
        for name in self.segment_order:
            d = self.vertex_meta[name].vtype.dim
            n = self.seg_rows[name]
            r = rows.get(name)
            if r is None:
                parts.append(jnp.zeros(n * d, dtype=dtype))
            else:
                parts.append(r.reshape(n * d).astype(dtype))
        parts.append(jnp.zeros(self.pad, dtype=dtype))
        return jnp.concatenate(parts)

    def allreduce(self, x):
        if self.psum_axis is None:
            return x
        return jax.lax.psum(x, self.psum_axis)

    def shard_slice(self, arr, n_local: int):
        """Slice a global per-factor constant down to this shard's rows.

        Inside shard_map, host-side per-factor index maps (e.g. Hessian
        scatter targets) are closure constants over the GLOBAL factor count;
        each device needs its contiguous n_local slice.
        """
        if self.psum_axis is None or arr.shape[0] == n_local:
            return arr
        start = jax.lax.axis_index(self.psum_axis) * n_local
        return jax.lax.dynamic_slice_in_dim(arr, start, n_local, 0)

    def shard_replica(self, data: "GraphData", axis: str,
                      n_devices: Optional[int] = None) -> "Problem":
        """Shallow copy bound to shard-local data, reducing over ``axis``.

        Used inside ``shard_map``: static metadata and caches are shared;
        only the factor arrays differ (each device sees its F/n slice).
        ``n_devices`` (the mesh axis size) additionally enables sharding of
        the Schur triple-product stage (schur.py) — without it that stage
        runs replicated.
        """
        import copy

        p = copy.copy(self)
        p.data = data
        p.psum_axis = axis
        p.psum_size = n_devices
        return p

    # ---- runtime remasking (remaskable freezes) ----------------------------
    def remask(self, opt_level: Optional[int] = None) -> None:
        """Recompute activity masks at ``opt_level`` without refreezing.

        The reference re-runs ``initialize_optimization(level)`` per
        optimizer call (graph.hpp:92-167, factor.hpp:419-461) so levels /
        active flags / fixed flags can change between runs at O(setup)
        cost. Here — on a problem frozen with ``remaskable=True`` — only
        the GraphData mask leaves are rebuilt (O(#factors) NumPy) and
        swapped in as new jit ARGUMENTS: shapes are static, nothing
        retraces, structure is never rediscovered.
        """
        if not getattr(self, "remaskable", False):
            raise ValueError(
                "runtime remasking requires Graph.freeze(remaskable=True)")
        if opt_level is not None:
            self.opt_level = int(opt_level)
        host = self.host
        factor_mask = {
            name: is_factor_active(host.factor_levels[name], self.opt_level)
            for name in host.factor_levels
        }
        referenced = {
            name: np.zeros(vm.count, dtype=bool)
            for name, vm in self.vertex_meta.items()
        }
        for name, local in host.factor_ids.items():
            mask = factor_mask[name]
            for slot, vt in enumerate(self.factor_meta[name].ftype.vertex_types):
                np.logical_or.at(referenced[vt.name], local[mask, slot], True)
        vertex_active = {
            name: referenced[name] & ~host.vertex_fixed[name]
            for name in referenced
        }
        vdata = {
            name: VertexArrays(
                col_offset=va.col_offset,
                active=jnp.asarray(vertex_active[name]),
                active_row=va.active_row,
            )
            for name, va in self.data.vertices.items()
        }
        fdata = {}
        for name, fa in self.data.factors.items():
            local = host.factor_ids[name]
            fmask = factor_mask[name]
            smask = np.zeros(local.shape, dtype=bool)
            for slot, vt in enumerate(
                    self.factor_meta[name].ftype.vertex_types):
                smask[:, slot] = fmask & vertex_active[vt.name][local[:, slot]]
            fdata[name] = dataclasses.replace(
                fa, factor_mask=jnp.asarray(fmask),
                slot_mask=jnp.asarray(smask),
            )
        self.data = GraphData(vertices=vdata, factors=fdata)
        host.factor_mask = factor_mask
        host.vertex_active = vertex_active

    def set_opt_level(self, level: int) -> None:
        """Switch optimization level post-freeze (active.hpp:11-15)."""
        self.remask(opt_level=level)

    def set_factor_active(self, fname: str, handle: int,
                          level_byte: int) -> None:
        """Post-freeze ``FactorDescriptor::set_active`` (factor.hpp:419):
        bits 0-6 = level, MSB = disabled."""
        idx = self._factor_handle_idx(fname, int(handle))
        self.host.factor_levels[fname][idx] = int(level_byte)
        self.remask()

    def _factor_handle_idx(self, fname: str, handle: int) -> int:
        maps = self._cache.setdefault("handle_maps", {})
        if fname not in maps:
            arr = self.host.factor_handles[fname]
            maps[fname] = {int(h): i for i, h in enumerate(arr)}
        return maps[fname][handle]

    def set_vertex_fixed(self, vname: str, global_id: int,
                         fixed: bool = True) -> None:
        """Post-freeze ``VertexDescriptor::set_fixed`` (vertex.hpp:262)."""
        local = self.host_local_index(vname, global_id)
        self.host.vertex_fixed[vname][local] = bool(fixed)
        self.remask()

    # number of columns in the flat internal vectors (b, delta_x, diag, ...)
    @property
    def dim_x(self) -> int:
        return self.dim_h + self.pad

    @property
    def n_blocks(self) -> int:
        return len(self.block_vertex)

    def get_hessian_dimension(self) -> int:
        """Reference ``Graph::get_hessian_dimension`` (graph.hpp:47)."""
        return self.dim_h

    def get_variable_dimension(self, block_index: int) -> int:
        return int(self.block_offsets[block_index + 1] - self.block_offsets[block_index])

    def get_num_block_columns(self) -> int:
        return self.n_blocks

    def get_elimination_block_column(self) -> int:
        return self.elimination_block

    def get_vertex(self, params, vtype_name: str, global_id: int):
        """Read one vertex's optimized parameters by its user global id
        (reference ``VertexDescriptor::get_vertex``, circle.cu:168)."""
        local = self.host_local_index(vtype_name, global_id)
        return params[vtype_name][local]

    def host_local_index(self, vtype_name: str, global_id: int) -> int:
        idx = self._cache.setdefault("id_maps", {})
        if vtype_name not in idx:
            idx[vtype_name] = dict(self._id_map_source(vtype_name))
        return idx[vtype_name][global_id]

    def _id_map_source(self, vtype_name: str):
        # rebuilt from the global-ids array stashed at freeze (the dict
        # form is only built here, on first by-id lookup)
        arr = self.host.global_ids[vtype_name]
        return zip(arr.tolist(), range(arr.shape[0]))

    def residual_sizes(self) -> Dict[str, int]:
        return {
            name: fm.count * fm.ftype.residual_dim
            for name, fm in self.factor_meta.items()
        }


@dataclasses.dataclass
class HostStructure:
    """NumPy copies of freeze products, used for structure discovery by the
    Hessian/Schur builders and by tests."""

    vertex_col_offset: Dict[str, np.ndarray]
    vertex_block_id: Dict[str, np.ndarray]
    vertex_active: Dict[str, np.ndarray]
    vertex_active_row: Dict[str, np.ndarray]
    vertex_fixed: Dict[str, np.ndarray]
    factor_ids: Dict[str, np.ndarray]  # (F, N) local indices
    factor_mask: Dict[str, np.ndarray]
    slot_mask: Dict[str, np.ndarray]
    # id/handle lookup SOURCES: plain arrays (dicts of millions of Python
    # ints cost seconds to build at freeze; the dict form is built lazily
    # on first by-id lookup — see Problem.host_local_index /
    # _factor_handle_idx)
    global_ids: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    # recorded for runtime remasking (remaskable freezes)
    factor_levels: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)
    factor_handles: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict)


class Graph:
    """Mutable graph-construction container (reference graph.hpp:30-334).

    Vertices and factors are added with user-chosen global ids; `freeze`
    performs the reference's ``initialize_optimization`` + ``build_structure``
    work and returns a `Problem`.
    """

    def __init__(self, precision: Precision = FP32_FP32):
        self.precision = precision
        self.vertex_sets: Dict[str, VertexSet] = {}
        self.factor_sets: Dict[str, FactorSet] = {}
        self._scale_jacobians = True

    # ---- construction API ------------------------------------------------
    def add_vertex_set(self, vtype: VertexType) -> VertexSet:
        if vtype.name in self.vertex_sets:
            raise KeyError(f"vertex set '{vtype.name}' already added")
        vs = VertexSet(vtype)
        self.vertex_sets[vtype.name] = vs
        return vs

    def add_factor_set(self, ftype: FactorType) -> FactorSet:
        if ftype.name in self.factor_sets:
            raise KeyError(f"factor set '{ftype.name}' already added")
        for vt in ftype.vertex_types:
            if vt.name not in self.vertex_sets:
                raise KeyError(
                    f"factor '{ftype.name}' references vertex type "
                    f"'{vt.name}' which has not been added to the graph"
                )
        fs = FactorSet(ftype)
        self.factor_sets[ftype.name] = fs
        return fs

    def scale_system(self, enable: bool) -> None:
        """Toggle Jacobi column scaling (reference graph.hpp:331)."""
        self._scale_jacobians = bool(enable)

    @property
    def scale_jacobians(self) -> bool:
        return self._scale_jacobians

    # ---- freeze ------------------------------------------------------------
    def freeze(self, opt_level: int = 0,
               precision: Optional[Precision] = None,
               pad_factors_to: int = 1,
               remaskable: bool = False) -> Problem:
        """Discover structure and build the jit-ready `Problem`.

        Mirrors ``Graph::initialize_optimization`` (graph.hpp:92-167):
        sort vertices by (eliminated, global id), map factor global ids to
        local ids, deactivate unreferenced/fixed vertices, assign Hessian
        block columns with eliminated descriptors last.

        ``remaskable=True`` assigns Hessian columns to EVERY vertex (not
        just currently-active ones) and records factor levels, so
        optimization levels / factor activity / fixed flags can be changed
        AFTER freeze via `Problem.remask` and friends at O(masks) cost —
        no structure rediscovery, no retrace (the reference instead re-runs
        ``initialize_optimization(level)`` per optimize call at O(setup),
        graph.hpp:92-167). Inactive vertices then contribute zeros and are
        held exactly in place by the update's activity mask; their
        damping-only diagonal keeps all solves well-posed.
        """
        precision = precision or self.precision
        gdt = precision.graph_dtype
        sdt = precision.solver_dtype
        from .perf import SectionTimer
        _tm = SectionTimer("freeze")

        # 0. Optional padding of every factor block to a multiple of
        # ``pad_factors_to`` (disabled padding factors, MSB level byte) so a
        # factor-sharded mesh sees equal per-device slices.
        def _pad_count(n: int) -> int:
            if pad_factors_to <= 1:
                return 0
            return (-n) % pad_factors_to

        # Empty descriptors: the reference prints an error and continues
        # (graph.hpp:174-186); here empty sets are warned about and skipped
        # entirely (a zero-length factor block can't even call its residual).
        import sys

        for name, vs in self.vertex_sets.items():
            if vs.count == 0:
                print(f"Error: Vertex set '{name}' has no entries.",
                      file=sys.stderr)
        skipped_factor_sets = set()
        for name, fs in self.factor_sets.items():
            if fs.count == 0:
                print(f"Error: Factor set '{name}' has no entries.",
                      file=sys.stderr)
                skipped_factor_sets.add(name)
        factor_sets_active = {
            name: fs for name, fs in self.factor_sets.items()
            if name not in skipped_factor_sets
        }

        _tm.lap("pad")
        # 1. Active factors per set + local id resolution.
        factor_ids_local: Dict[str, np.ndarray] = {}
        factor_mask: Dict[str, np.ndarray] = {}
        factor_levels: Dict[str, np.ndarray] = {}
        for name, fs in factor_sets_active.items():
            gids = fs.ids_array()  # (F, N) global
            npad = _pad_count(gids.shape[0])
            if npad:
                if gids.shape[0] == 0:
                    raise ValueError(f"cannot pad empty factor set '{name}'")
                gids = np.concatenate(
                    [gids, np.repeat(gids[:1], npad, axis=0)], axis=0
                )
            levels = fs.level_array()
            if npad:
                levels = np.concatenate(
                    [levels, np.full(npad, 0x80, dtype=levels.dtype)]
                )
            factor_levels[name] = levels
            local = np.zeros_like(gids)
            for slot, vt in enumerate(fs.ftype.vertex_types):
                vs = self.vertex_sets[vt.name]
                vs_gids = np.asarray(vs.global_ids, dtype=np.int64)
                g = gids[:, slot]
                # Contiguous-ids fast path: builders that add vertices in
                # order (every example/io loader) produce global_ids that
                # are base + arange — resolution is then a subtraction +
                # range check instead of argsort + 5M binary searches
                # (2.6 s -> ~0.1 s at Venice-Final, BENCHMARKS.md freeze
                # table; reference analog: the host id->index hash walk in
                # graph.hpp:171-210 has no such path).
                n_v = len(vs_gids)
                base = int(vs_gids[0]) if n_v else 0
                if n_v and int(vs_gids[-1]) == base + n_v - 1 and np.array_equal(
                        vs_gids, np.arange(base, base + n_v, dtype=np.int64)):
                    loc = g - base
                    ok = (loc >= 0) & (loc < n_v)
                    if not np.all(ok):
                        bad = g[~ok][0]
                        raise KeyError(
                            f"factor set '{name}' slot {slot} references "
                            f"unknown vertex id {bad} of type '{vt.name}'"
                        )
                    local[:, slot] = loc
                    continue
                sorter = np.argsort(vs_gids, kind="stable")
                sorted_gids = vs_gids[sorter]
                pos = np.searchsorted(sorted_gids, g)
                pos_c = np.clip(pos, 0, max(len(sorted_gids) - 1, 0))
                ok = (len(sorted_gids) > 0) & (
                    sorted_gids[pos_c] == g
                )
                if not np.all(ok):
                    bad = g[~np.asarray(ok, dtype=bool)][0]
                    raise KeyError(
                        f"factor set '{name}' slot {slot} references unknown "
                        f"vertex id {bad} of type '{vt.name}'"
                    )
                local[:, slot] = sorter[pos_c]
            factor_ids_local[name] = local
            factor_mask[name] = is_factor_active(factor_levels[name], opt_level)

        _tm.lap("active_factors")
        # 2. Vertex active state: !fixed AND referenced by an active factor
        # (graph.hpp:171-210, ops/active.hpp:15-58).
        referenced = {
            name: np.zeros(vs.count, dtype=bool)
            for name, vs in self.vertex_sets.items()
        }
        for name, fs in factor_sets_active.items():
            mask = factor_mask[name]
            local = factor_ids_local[name]
            for slot, vt in enumerate(fs.ftype.vertex_types):
                np.logical_or.at(referenced[vt.name], local[mask, slot], True)
        vertex_active = {}
        for name, vs in self.vertex_sets.items():
            vertex_active[name] = referenced[name] & ~vs.fixed_array()
        # Column-active set: drives Hessian column assignment. In remaskable
        # mode EVERY vertex gets a column so later mask changes never alter
        # shapes; runtime activity lives only in the GraphData mask leaves.
        if remaskable:
            col_active = {
                name: np.ones(vs.count, dtype=bool)
                for name, vs in self.vertex_sets.items()
            }
        else:
            col_active = vertex_active

        _tm.lap("vertex_active")
        # 3. Sort all vertices by (eliminated, type, global_id) and assign
        # columns to active ones. The reference sorts by (eliminated,
        # global_id) only (graph.hpp:109-149); grouping by TYPE keeps every
        # vertex type's columns in one contiguous, uniformly-strided segment
        # so flat vectors reshape to (rows, dim) for free and gathers and
        # scatters move whole rows, not scalars.
        # The semantic invariant (eliminated descriptors occupy the trailing
        # columns) is preserved.
        type_names = list(self.vertex_sets)
        type_order = {name: i for i, name in enumerate(type_names)}

        col = 0
        block_id = 0
        elimination_block = None
        block_offsets = []
        block_dims: List[int] = []
        vertex_col_offset = {
            name: np.full(vs.count, -1, dtype=np.int64)
            for name, vs in self.vertex_sets.items()
        }
        vertex_block_id = {
            name: np.full(vs.count, -1, dtype=np.int64)
            for name, vs in self.vertex_sets.items()
        }
        vertex_active_row = {
            name: np.full(vs.count, -1, dtype=np.int64)
            for name, vs in self.vertex_sets.items()
        }
        seg_start: Dict[str, int] = {}
        seg_rows: Dict[str, int] = {}
        row_vertex: Dict[str, np.ndarray] = {}
        segment_order: List[str] = []

        # Vectorized column assignment: concatenate per-type vertex arrays,
        # globally sort by (eliminated, type, global_id), then exclusive-scan
        # the active dims.
        elim_cat, torder_cat, gid_cat, local_cat, active_cat, dim_cat = (
            [], [], [], [], [], []
        )
        for name, vs in self.vertex_sets.items():
            n = vs.count
            elim_cat.append(np.full(n, bool(vs.eliminate)))
            torder_cat.append(np.full(n, type_order[name], dtype=np.int64))
            gid_cat.append(np.asarray(vs.global_ids, dtype=np.int64))
            local_cat.append(np.arange(n, dtype=np.int64))
            active_cat.append(col_active[name])
            dim_cat.append(np.full(n, vs.vtype.dim, dtype=np.int64))
        elim_cat = np.concatenate(elim_cat)
        torder_cat = np.concatenate(torder_cat)
        gid_cat = np.concatenate(gid_cat)
        local_cat = np.concatenate(local_cat)
        active_cat = np.concatenate(active_cat)
        dim_cat = np.concatenate(dim_cat)

        order = np.lexsort((gid_cat, torder_cat, elim_cat))
        sel = order[active_cat[order]]
        n_active_total = sel.shape[0]
        dims_sel = dim_cat[sel]
        col_sel = np.concatenate([[0], np.cumsum(dims_sel)[:-1]]).astype(
            np.int64
        )
        dim_h = int(dims_sel.sum())
        block_ids_sel = np.arange(n_active_total, dtype=np.int64)
        elim_sel = elim_cat[sel]
        if np.any(elim_sel):
            elimination_block = int(np.argmax(elim_sel))
        block_offsets = col_sel.tolist()
        block_dims = dims_sel.tolist()
        block_id = n_active_total
        col = dim_h

        # scatter results back per type + segment bookkeeping.
        # block_vertex stays ARRAY-shaped (type code + local id per block):
        # materializing 1M+ (name, local) tuples is a multi-second Python
        # loop at Venice-Final scale, and every consumer is vectorizable.
        torder_sel = torder_cat[sel]
        local_sel = local_cat[sel]
        block_vertex = BlockVertexMap(type_names, torder_sel, local_sel)
        for ti, name in enumerate(type_names):
            m = torder_sel == ti
            if not np.any(m):
                seg_start[name] = dim_h
                seg_rows[name] = 0
                row_vertex[name] = np.zeros(0, dtype=np.int64)
                continue
            locs = local_sel[m]
            vertex_col_offset[name][locs] = col_sel[m]
            vertex_block_id[name][locs] = block_ids_sel[m]
            vertex_active_row[name][locs] = np.arange(locs.shape[0])
            seg_start[name] = int(col_sel[m][0])
            seg_rows[name] = int(locs.shape[0])
            row_vertex[name] = locs
            segment_order.append(name)
        segment_order.sort(key=lambda n: seg_start[n])
        block_offsets.append(dim_h)
        if elimination_block is None:
            elimination_block = block_id
        elimination_col = (
            block_offsets[elimination_block]
            if elimination_block < block_id
            else dim_h
        )

        _tm.lap("assign_columns")
        # 4. Trash pad: inactive vertices scatter past dim_h (flat view) /
        # to the trash row seg_rows[name] (row view).
        pad = max([vs.vtype.dim for vs in self.vertex_sets.values()] + [1])
        for name in vertex_col_offset:
            off = vertex_col_offset[name]
            off[off < 0] = dim_h  # trash column
            ar = vertex_active_row[name]
            ar[ar < 0] = seg_rows[name]  # trash row

        _tm.lap("trash_pad")
        # 5. Build device arrays.
        vdata: Dict[str, VertexArrays] = {}
        params0: Dict[str, jax.Array] = {}
        meta_v: Dict[str, VertexMeta] = {}
        for name, vs in self.vertex_sets.items():
            vdata[name] = VertexArrays(
                col_offset=jnp.asarray(vertex_col_offset[name], dtype=jnp.int32),
                active=jnp.asarray(vertex_active[name]),
                active_row=jnp.asarray(vertex_active_row[name],
                                       dtype=jnp.int32),
            )
            params0[name] = jnp.asarray(vs.values_array(), dtype=gdt)
            meta_v[name] = VertexMeta(
                vtype=vs.vtype,
                count=vs.count,
                n_active=int(vertex_active[name].sum()),
            )

        fdata: Dict[str, FactorArrays] = {}
        meta_f: Dict[str, FactorMeta] = {}
        slot_mask_h: Dict[str, np.ndarray] = {}
        def _pad_rows(arr: Optional[np.ndarray], n_total: int):
            if arr is None or arr.shape[0] == n_total:
                return arr
            pad = np.zeros((n_total - arr.shape[0],) + arr.shape[1:],
                           dtype=arr.dtype)
            return np.concatenate([arr, pad], axis=0)

        for name, fs in factor_sets_active.items():
            local = factor_ids_local[name]
            fmask = factor_mask[name]
            n = local.shape[0]  # padded count
            nslots = fs.ftype.arity
            cols_base = np.zeros((n, nslots), dtype=np.int64)
            rows_arr = np.zeros((n, nslots), dtype=np.int64)
            smask = np.zeros((n, nslots), dtype=bool)
            for slot, vt in enumerate(fs.ftype.vertex_types):
                cols_base[:, slot] = vertex_col_offset[vt.name][local[:, slot]]
                rows_arr[:, slot] = vertex_active_row[vt.name][local[:, slot]]
                smask[:, slot] = fmask & vertex_active[vt.name][local[:, slot]]
            # Structure discovery uses the superset mask in remaskable mode:
            # every factor's blocks exist; runtime activity only zeroes
            # contributions (GraphData slot_mask below stays the live mask).
            slot_mask_h[name] = (np.ones_like(smask) if remaskable else smask)

            obs = _pad_rows(fs.obs_array(), n)
            data = _pad_rows(fs.data_array(), n)
            has_p = fs.has_precision()
            fdata[name] = FactorArrays(
                ids=tuple(
                    jnp.asarray(local[:, s], dtype=jnp.int32)
                    for s in range(nslots)
                ),
                rows=tuple(
                    jnp.asarray(rows_arr[:, s], dtype=jnp.int32)
                    for s in range(nslots)
                ),
                cols_base=jnp.asarray(cols_base, dtype=jnp.int32),
                obs=None if obs is None else jnp.asarray(obs, dtype=gdt),
                data=None if data is None else jnp.asarray(data, dtype=gdt),
                precision=(
                    jnp.asarray(
                        _pad_rows(fs.precision_array(), n).reshape(n, -1),
                        dtype=sdt,
                    )
                    if has_p else None
                ),
                # padding rows use the loss default so vectorized loss
                # derivatives stay finite (0/0 guards)
                loss_params=jnp.asarray(
                    np.concatenate([
                        fs.loss_params_array(),
                        np.full(n - fs.count, fs.ftype.loss.default_param()),
                    ]),
                    dtype=gdt,
                ),
                factor_mask=jnp.asarray(fmask),
                slot_mask=jnp.asarray(smask),
            )
            meta_f[name] = FactorMeta(
                ftype=fs.ftype,
                count=n,
                n_active=int(fmask.sum()),
                store_jacobians=fs.store_jacobians,
            )

        host = HostStructure(
            vertex_col_offset=vertex_col_offset,
            vertex_block_id=vertex_block_id,
            vertex_active=vertex_active,
            vertex_active_row=vertex_active_row,
            vertex_fixed={
                name: vs.fixed_array() for name, vs in self.vertex_sets.items()
            },
            factor_ids=factor_ids_local,
            factor_mask=factor_mask,
            slot_mask=slot_mask_h,
            global_ids={
                name: np.asarray(vs.global_ids, dtype=np.int64)
                for name, vs in self.vertex_sets.items()
            },
            factor_levels=factor_levels,
            factor_handles={
                name: np.asarray(fs.handle_array())
                for name, fs in factor_sets_active.items()
            },
        )

        problem = Problem(
            meta_v, meta_f, GraphData(vertices=vdata, factors=fdata), params0,
            dim_h=dim_h, pad=pad,
            block_offsets=np.asarray(block_offsets, dtype=np.int64),
            block_vertex=block_vertex,
            block_dims=np.asarray(block_dims, dtype=np.int64),
            elimination_block=elimination_block,
            elimination_col=elimination_col,
            opt_level=opt_level,
            precision=precision,
            host=host,
            seg_start=seg_start,
            seg_rows=seg_rows,
            segment_order=segment_order,
            row_vertex={
                name: np.asarray(v, dtype=np.int64)
                for name, v in row_vertex.items()
            },
        )
        problem.scale_jacobians = self._scale_jacobians
        problem.remaskable = remaskable
        _tm.lap("device_arrays")
        _tm.done()
        return problem
