"""Linearization engine: residuals, Jacobians, chi2, Jacobi scaling, b.

JAX analog of ``Graph::linearize`` / ``compute_error`` / ``chi2``
(reference: graph.hpp:221-290) and the underlying kernels:

- residual + autodiff Jacobian (ops/error.hpp:100-180, 252-293) becomes one
  vmapped ``jax.jacfwd`` trace per factor type — one fused XLA computation
  instead of one CUDA kernel per vertex slot;
- manual Jacobians (ops/linearize.hpp:10-80) become a vmapped user function;
- chi2 + robust loss + derivative (ops/chi2.hpp:32-44);
- Jacobi column scaling ``s = 1/(eps + sqrt(diag(J^T dL P J)))``
  (graph.hpp:254-281, ops/linearize.hpp:140-231);
- ``b = -sum_f J^T dL P r`` via deterministic segment_sum instead of
  atomicAdd (ops/linearize.hpp:240-303).

All functions are pure and jit-compatible; the `Problem` provides static
structure via closure, and `GraphData` rides along as a pytree argument so
relinearization never retraces.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .graph import FactorArrays, GraphData, Problem, with_matmul_precision
from .ops.blockfmt import flatten_blocks, unflatten_blocks
from .precision import clamp_to_storage

# Diagonal clamp range used for LM damping and Jacobi preconditioning
# (reference: pcg.hpp:102-104, ops/hessian.hpp:100-109).
DIAG_MIN = 1.0e-6
DIAG_MAX = 1.0e32


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Linearization:
    """Everything produced by one linearization pass (a pytree)."""

    residuals: Dict[str, jax.Array]  # (F, E) graph dtype
    jacobians: Dict[str, Optional[Tuple[jax.Array, ...]]]  # (F, E*d_i) solver
    # dtype, flat row-major (see ops/blockfmt.py)
    chi2_vec: Dict[str, jax.Array]  # (F,) robust per-factor chi2
    chi2_deriv: Dict[str, jax.Array]  # (F,) loss derivative dL
    scales: jax.Array  # (dim_x,) Jacobi column scales (1.0 in pad region)
    diag: jax.Array  # (dim_x,) diagonal of the *scaled* Hessian, unclamped
    b: jax.Array  # (dim_x,) b = -J^T dL P r (scaled system)
    chi2: jax.Array  # scalar sum of chi2_vec


# --------------------------------------------------------------------------
# Per-factor residual / Jacobian evaluation
# --------------------------------------------------------------------------

def _call_args(fa: FactorArrays):
    """Gather the vmapped (obs, data) tail arguments and their in_axes."""
    tail = []
    axes = []
    if fa.obs is not None:
        tail.append(fa.obs)
        axes.append(0)
    if fa.data is not None:
        tail.append(fa.data)
        axes.append(0)
    return tuple(tail), tuple(axes)


def _gather_params(problem: Problem, params, name: str):
    fa = problem.data.factors[name]
    fm = problem.factor_meta[name]
    return tuple(
        params[vt.name][fa.ids[slot]]
        for slot, vt in enumerate(fm.ftype.vertex_types)
    )


def compute_residuals_block(problem: Problem, params, name: str) -> jax.Array:
    """Residuals (F, E) for one factor block (ops/error.hpp:252-293)."""
    fm = problem.factor_meta[name]
    fa = problem.data.factors[name]
    gathered = _gather_params(problem, params, name)
    tail, tail_axes = _call_args(fa)
    fn = fm.ftype.residual_fn

    def one(*args):
        return jnp.asarray(fn(*args)).reshape(fm.ftype.residual_dim)

    in_axes = (0,) * fm.ftype.arity + tail_axes
    return jax.vmap(one, in_axes=in_axes)(*gathered, *tail)


def _residual_and_jacobian_block(problem: Problem, params, name: str,
                                 fa_override=None):
    """(F,E) residuals and per-slot (F,E,d_i) tangent Jacobians.

    AUTO mode: jacfwd of the residual through each vertex type's ``retract``
    at delta=0 (replaces the reference's Dual-number kernels,
    ops/error.hpp:100-180). MANUAL: user-provided analytic blocks
    (ops/linearize.hpp:10-80).
    """
    fm = problem.factor_meta[name]
    fa = fa_override if fa_override is not None else problem.data.factors[name]
    ftype = fm.ftype
    gathered = tuple(
        params[vt.name][fa.ids[slot]]
        for slot, vt in enumerate(ftype.vertex_types)
    )
    tail, tail_axes = _call_args(fa)
    gdt = problem.precision.graph_dtype
    n = ftype.arity

    if ftype.jacobian_fn is not None:
        def one_manual(*args):
            ps, rest = args[:n], args[n:]
            r = jnp.asarray(ftype.residual_fn(*ps, *rest))
            J = ftype.jacobian_fn(*ps, *rest)
            J = tuple(
                jnp.asarray(Ji).reshape(ftype.residual_dim, vt.dim)
                for Ji, vt in zip(J, ftype.vertex_types)
            )
            return r.reshape(ftype.residual_dim), J

        in_axes = (0,) * n + tail_axes
        return jax.vmap(one_manual, in_axes=in_axes)(*gathered, *tail)

    def one_auto(*args):
        ps, rest = args[:n], args[n:]

        def g(deltas):
            xs = tuple(
                vt.retract(p, d)
                for vt, p, d in zip(ftype.vertex_types, ps, deltas)
            )
            return jnp.asarray(ftype.residual_fn(*xs, *rest)).reshape(
                ftype.residual_dim
            )

        zeros = tuple(
            jnp.zeros(vt.dim, dtype=gdt) for vt in ftype.vertex_types
        )
        r = g(zeros)
        J = jax.jacfwd(g)(zeros)
        return r, J

    in_axes = (0,) * n + tail_axes
    return jax.vmap(one_auto, in_axes=in_axes)(*gathered, *tail)


#: factor counts above this are linearized in lax.map chunks of half this
#: size, bounding the (F, E, d) jacfwd transient.
LINEARIZE_CHUNK_LIMIT = 1 << 20


def _residuals_and_flat_jacobians(problem: Problem, params, name: str):
    """(F, E) residuals + per-slot masked flat (F, E*d) Jacobians, with
    chunked evaluation for huge factor blocks."""
    fm = problem.factor_meta[name]
    fa = problem.data.factors[name]
    ftype = fm.ftype
    F = fa.factor_mask.shape[0]

    def compute(sl):
        sub = jax.tree.map(lambda a: a[sl], fa) if sl is not None else fa
        r, J = _residual_and_jacobian_block(problem, params, name,
                                            fa_override=sub)
        jflat = tuple(
            flatten_blocks(
                Ji * sub.slot_mask[:, s, None, None].astype(Ji.dtype)
            )
            for s, Ji in enumerate(J)
        )
        return r, jflat

    if F <= LINEARIZE_CHUNK_LIMIT:
        return compute(None)

    chunk = LINEARIZE_CHUNK_LIMIT // 2
    n_pad = (-F) % chunk
    n_chunks = (F + n_pad) // chunk

    def run_chunk(i):
        start = i * chunk
        sl = jnp.arange(chunk) + start  # gather indices (clamped pad tail)
        sl = jnp.minimum(sl, F - 1)
        return compute(sl)

    r_chunks, j_chunks = jax.lax.map(run_chunk, jnp.arange(n_chunks))
    r = r_chunks.reshape(n_chunks * chunk, -1)[:F]
    jflat = tuple(
        jc.reshape(n_chunks * chunk, -1)[:F] for jc in j_chunks
    )
    return r, jflat


# --------------------------------------------------------------------------
# chi2 (ops/chi2.hpp)
# --------------------------------------------------------------------------

def _weighted_residual(fa: FactorArrays, r: jax.Array, acc_dtype) -> jax.Array:
    """P @ r per factor; identity precision short-circuits to r."""
    if fa.precision is None:
        return r
    E = r.shape[-1]
    P = unflatten_blocks(fa.precision, E, E).astype(acc_dtype)
    return jnp.einsum(
        "fij,fj->fi", P, r.astype(acc_dtype),
        preferred_element_type=acc_dtype,
    ).astype(r.dtype)


def _host_factor_rows(problem, fname: str, s: int,
                      vt_name: str) -> np.ndarray:
    """Host copy of fa.rows[s] (active-row index per factor, trash row for
    inactive vertices) for freeze-time reduction planning."""
    cache = problem._cache.setdefault("host_factor_rows", {})
    key = (fname, s)
    if key not in cache:
        ids = problem.host.factor_ids[fname][:, s]
        cache[key] = problem.host.vertex_active_row[vt_name][ids].astype(
            np.int32)
    return cache[key]


def _factor_row_reduce(problem, tag, contrib, fa, fname, s, vt_name, gdt):
    """(F, d) per-factor contributions -> (n_rows, d) per-vertex rows.

    Non-sharded: one segment_sum over the freeze-time host row ids
    (ops/streamreduce.py). Sharded: the traced local fa.rows scatter
    (per-shard segment ids are runtime values there).
    """
    n_seg = problem.seg_rows[vt_name] + 1
    if problem.psum_axis is None:
        from .ops.streamreduce import reduce_rows

        seg = _host_factor_rows(problem, fname, s, vt_name)
        return reduce_rows(problem, tag, contrib, seg, n_seg)[:-1]
    return jax.ops.segment_sum(
        contrib, fa.rows[s], num_segments=n_seg,
    )[:-1]


def _apply_precision(fa: FactorArrays, J3: jax.Array, acc_dtype) -> jax.Array:
    """P @ J per factor on a (F, E, d) block; identity short-circuits."""
    if fa.precision is None:
        return J3
    E = J3.shape[1]
    P = unflatten_blocks(fa.precision, E, E).astype(acc_dtype)
    return jnp.einsum(
        "fij,fjc->fic", P, J3, preferred_element_type=acc_dtype
    )


def compute_chi2_block(problem: Problem, name: str, r: jax.Array):
    """Per-factor robust chi2 and loss derivative (ops/chi2.hpp:32-44).

    raw = r^T P r; chi2 = loss(raw) (masked to active factors);
    dL = loss'(raw) re-weights all downstream H/b/JtPv products.
    """
    fm = problem.factor_meta[name]
    fa = problem.data.factors[name]
    pr = _weighted_residual(fa, r, problem.precision.acc_dtype)
    raw = jnp.sum(r * pr, axis=-1)
    lp = fa.loss_params
    chi2 = fm.ftype.loss.value(raw, lp) * fa.factor_mask
    deriv = fm.ftype.loss.derivative(raw, lp)
    return chi2, deriv


# --------------------------------------------------------------------------
# Full linearization pass (graph.hpp:236-290)
# --------------------------------------------------------------------------

@with_matmul_precision
def linearize(problem: Problem, params) -> Linearization:
    gdt = problem.precision.graph_dtype
    sdt = problem.precision.solver_dtype
    acc = problem.precision.acc_dtype
    dim_x = problem.dim_x
    scale_on = getattr(problem, "scale_jacobians", True)

    residuals: Dict[str, jax.Array] = {}
    jac_flat: Dict[str, Tuple[jax.Array, ...]] = {}
    chi2_vec: Dict[str, jax.Array] = {}
    chi2_deriv: Dict[str, jax.Array] = {}

    # 1. residuals + Jacobians + chi2. Jacobian blocks are kept flat (F, E*d)
    # in device memory (see ops/blockfmt.py) and reshaped transiently
    # around einsums. Huge blocks are processed in lax.map chunks so the
    # (F, E, d) jacfwd transient stays bounded.
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        r, jflat = _residuals_and_flat_jacobians(problem, params, name)
        residuals[name] = r.astype(gdt)
        jac_flat[name] = jflat
        chi2_vec[name], chi2_deriv[name] = compute_chi2_block(
            problem, name, residuals[name]
        )

    E_of = {
        name: fm.ftype.residual_dim for name, fm in problem.factor_meta.items()
    }

    # 2. Jacobi scaling (graph.hpp:254-281): diag of unscaled J^T dL P J.
    # Accumulated per vertex type in row form ((F,d) -> (n_rows+1,d) with a
    # trash row), then flattened (row-shaped segment reductions,
    # ops/streamreduce.py).
    diag_rows: Dict[str, jax.Array] = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        dL = chi2_deriv[name].astype(acc)
        E = E_of[name]
        for s, vt in enumerate(fm.ftype.vertex_types):
            Ji = unflatten_blocks(jac_flat[name][s], E, vt.dim).astype(acc)
            PJ = _apply_precision(fa, Ji, acc)
            contrib = jnp.einsum(
                "fec,fec->fc", Ji, PJ, preferred_element_type=acc
            ) * dL[:, None]
            acc_rows = _factor_row_reduce(
                problem, ("lindiag", name, s), contrib.astype(gdt),
                fa, name, s, vt.name, gdt)
            prev = diag_rows.get(vt.name)
            diag_rows[vt.name] = acc_rows if prev is None else prev + acc_rows

    diag_raw = problem.allreduce(problem.flat_from_rows(diag_rows))

    if scale_on:
        eps = jnp.asarray(np.finfo(np.float64).eps, dtype=gdt)
        scales = (1.0 / (eps + jnp.sqrt(diag_raw))).astype(gdt)
        # pad region (and any untouched active column) must stay sane
        scales = jnp.where(diag_raw > 0, scales, jnp.ones_like(scales))
    else:
        scales = jnp.ones(dim_x, dtype=gdt)

    # 3. scale + store Jacobians (ops/linearize.hpp:140-231); diag of the
    # scaled Hessian is diag_raw * s^2 (algebraically identical to the
    # reference's recompute from scaled J, pcg.hpp:93-99). In flat layout,
    # column c of error-row e is index e*d+c, so the per-column scale tiles
    # E times.
    jacobians: Dict[str, Optional[Tuple[jax.Array, ...]]] = {}
    scales_rows = {
        name: problem.rows_view_padded(scales, name)
        for name in problem.vertex_meta
    } if scale_on else None
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = E_of[name]
        scaled = []
        for s, vt in enumerate(fm.ftype.vertex_types):
            Ji = jac_flat[name][s]
            if scale_on:
                si = scales_rows[vt.name][fa.rows[s]]  # (F, d) row gather
                Ji = Ji * jnp.tile(si, (1, E)).astype(Ji.dtype)
            scaled.append(clamp_to_storage(Ji, sdt))
        if fm.store_jacobians:
            jacobians[name] = tuple(scaled)
        else:
            jacobians[name] = None  # dynamic mode: recomputed in matvecs
        jac_flat[name] = tuple(scaled)  # used below for b regardless

    diag = diag_raw * scales * scales

    # 4. b = -J^T dL P r over all factor blocks (ops/linearize.hpp:240-303).
    b_rows: Dict[str, jax.Array] = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        r = residuals[name]
        E = E_of[name]
        w = _weighted_residual(fa, r, acc) * chi2_deriv[name][:, None]
        for s, vt in enumerate(fm.ftype.vertex_types):
            Ji = unflatten_blocks(jac_flat[name][s], E, vt.dim).astype(acc)
            contrib = -jnp.einsum(
                "fec,fe->fc", Ji, w.astype(acc), preferred_element_type=acc
            )
            acc_rows = _factor_row_reduce(
                problem, ("linb", name, s), contrib.astype(gdt),
                fa, name, s, vt.name, gdt)
            prev = b_rows.get(vt.name)
            b_rows[vt.name] = acc_rows if prev is None else prev + acc_rows
    b = problem.allreduce(problem.flat_from_rows(b_rows))

    chi2 = problem.allreduce(sum(jnp.sum(v) for v in chi2_vec.values()))

    return Linearization(
        residuals=residuals,
        jacobians=jacobians,
        chi2_vec=chi2_vec,
        chi2_deriv=chi2_deriv,
        scales=scales,
        diag=diag,
        b=b,
        chi2=jnp.asarray(chi2, dtype=gdt),
    )


def slim_linearization(lin: Linearization) -> Linearization:
    """Drop the per-factor arrays (residuals, Jacobian storage, chi2
    vectors) from a Linearization, keeping only the solve-facing vectors
    (scales, diag, b, chi2).

    Solvers that consume the factor arrays in ``prepare`` only (the
    Schur / dense / sparse-direct families assemble Hessian values there;
    ``solve`` reads just ``b``/``diag``) declare ``slim_carry = True`` and
    the LM loop carries the slimmed form: at Venice-Final scale the
    Jacobian storage alone is ~0.5 GB, and keeping it in the while_loop
    carry makes the accept/reject ``lax.cond`` merge pay a full
    read+select+write pass over it every iteration (the reference has no
    analog — its trust-region loop mutates in place,
    levenberg_marquardt.hpp:166-238)."""
    return dataclasses.replace(
        lin, residuals={}, jacobians={}, chi2_vec={}, chi2_deriv={})


@with_matmul_precision
def compute_chi2(problem: Problem, params) -> jax.Array:
    """chi2 only (``Graph::compute_error`` + ``chi2``, graph.hpp:221-234)."""
    total = jnp.asarray(0.0, dtype=problem.precision.graph_dtype)
    for name in problem.factor_meta:
        r = compute_residuals_block(problem, params, name)
        c, _ = compute_chi2_block(problem, name, r)
        total = total + jnp.sum(c)
    return problem.allreduce(total)


# --------------------------------------------------------------------------
# Matrix-free products (ops/product.hpp)
# --------------------------------------------------------------------------

def _dynamic_residual_fn(problem: Problem, params, name: str):
    """g(deltas) = residual(retract(params, deltas)) for one factor block,
    vmapped — the linearization point for jvp/vjp-based dynamic matvecs."""
    fm = problem.factor_meta[name]
    fa = problem.data.factors[name]
    ftype = fm.ftype
    gathered = _gather_params(problem, params, name)
    tail, tail_axes = _call_args(fa)
    n = ftype.arity

    def one(*args):
        deltas = args[:n]
        ps = args[n:2 * n]
        rest = args[2 * n:]
        xs = tuple(
            vt.retract(p, d)
            for vt, p, d in zip(ftype.vertex_types, ps, deltas)
        )
        return jnp.asarray(ftype.residual_fn(*xs, *rest)).reshape(
            ftype.residual_dim
        )

    batched = jax.vmap(one, in_axes=(0,) * (2 * n) + tail_axes)

    def g(deltas):
        return batched(*deltas, *gathered, *tail)

    gdt = problem.precision.graph_dtype
    zeros = tuple(
        jnp.zeros((fm_count_of(problem, name), vt.dim), dtype=gdt)
        for vt in ftype.vertex_types
    )
    return g, zeros


def fm_count_of(problem, name):
    return problem.data.factors[name].factor_mask.shape[0]


def _dynamic_Jv_block(problem, lin, params, name, x_rows, acc):
    """J x for one dynamic block via jvp (scaled + masked tangents)."""
    fa = problem.data.factors[name]
    fm = problem.factor_meta[name]
    g, zeros = _dynamic_residual_fn(problem, params, name)
    deltas = []
    for s, vt in enumerate(fm.ftype.vertex_types):
        xg = x_rows[vt.name][fa.rows[s]]
        si = problem.rows_view_padded(lin.scales, vt.name)[fa.rows[s]]
        d = (xg * si) * fa.slot_mask[:, s, None].astype(xg.dtype)
        deltas.append(d.astype(zeros[s].dtype))
    _, out = jax.jvp(g, (zeros,), (tuple(deltas),))
    return out.astype(acc)


def _dynamic_JtPv_block(problem, lin, params, name, w, acc):
    """Per-slot J^T w for one dynamic block via vjp (scaled + masked)."""
    fa = problem.data.factors[name]
    fm = problem.factor_meta[name]
    g, zeros = _dynamic_residual_fn(problem, params, name)
    _, pullback = jax.vjp(g, zeros)
    (grads,) = pullback(w.astype(zeros[0].dtype))
    out = []
    for s, vt in enumerate(fm.ftype.vertex_types):
        si = problem.rows_view_padded(lin.scales, vt.name)[fa.rows[s]]
        out.append(
            (grads[s] * si * fa.slot_mask[:, s, None].astype(si.dtype)
             ).astype(acc)
        )
    return tuple(out)


@with_matmul_precision
def Jv(problem: Problem, lin: Linearization, x: jax.Array,
       params=None) -> Dict[str, jax.Array]:
    """v1 = J x per factor block (ops/product.hpp:49-99).

    ``x`` is a (dim_x,) vector over Hessian columns (pad region ignored
    because masked J columns are zero).
    """
    acc = problem.precision.acc_dtype
    gdt = problem.precision.graph_dtype
    x_rows = {
        name: problem.rows_view_padded(x, name) for name in problem.vertex_meta
    }
    out = {}
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        J = lin.jacobians[name]
        if J is None:
            # dynamic mode: jvp through the residual — J is never
            # materialized (the reference's storage-free kernels,
            # ops/product.hpp:101-142)
            if params is None:
                raise ValueError(
                    f"factor block '{name}' uses dynamic Jacobians; pass "
                    "params to the matvec"
                )
            out[name] = _dynamic_Jv_block(
                problem, lin, params, name, x_rows, acc
            ).astype(gdt)
            continue
        E = fm.ftype.residual_dim
        # J[0].shape[0] is the local factor count (== fm.count single-device,
        # == fm.count / n_devices inside a factor-sharded shard_map).
        y = jnp.zeros((J[0].shape[0], E), dtype=acc)
        for s, vt in enumerate(fm.ftype.vertex_types):
            xg = x_rows[vt.name][fa.rows[s]].astype(acc)  # (F, d) row gather
            J3 = unflatten_blocks(J[s], E, vt.dim).astype(acc)
            y = y + jnp.einsum(
                "fec,fc->fe", J3, xg, preferred_element_type=acc
            )
        out[name] = y.astype(gdt)
    return out


@with_matmul_precision
def JtPv(problem: Problem, lin: Linearization, v: Dict[str, jax.Array],
         params=None) -> jax.Array:
    """v2 = J^T dL P v accumulated over all blocks (ops/product.hpp:226-288)."""
    acc = problem.precision.acc_dtype
    gdt = problem.precision.graph_dtype
    out_rows: Dict[str, jax.Array] = {}

    def accumulate(vt_name, rows_idx, contrib):
        acc_rows = jax.ops.segment_sum(
            contrib.astype(gdt), rows_idx,
            num_segments=problem.seg_rows[vt_name] + 1,
        )[:-1]
        prev = out_rows.get(vt_name)
        out_rows[vt_name] = acc_rows if prev is None else prev + acc_rows

    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        J = lin.jacobians[name]
        w = _weighted_residual(fa, v[name], acc) * lin.chi2_deriv[name][:, None]
        if J is None:
            if params is None:
                raise ValueError(
                    f"factor block '{name}' uses dynamic Jacobians; pass "
                    "params to the matvec"
                )
            contribs = _dynamic_JtPv_block(problem, lin, params, name, w, acc)
            for s, vt in enumerate(fm.ftype.vertex_types):
                accumulate(vt.name, fa.rows[s], contribs[s])
            continue
        E = fm.ftype.residual_dim
        for s, vt in enumerate(fm.ftype.vertex_types):
            J3 = unflatten_blocks(J[s], E, vt.dim).astype(acc)
            contrib = jnp.einsum(
                "fec,fe->fc", J3, w.astype(acc),
                preferred_element_type=acc,
            )
            accumulate(vt.name, fa.rows[s], contrib)
    return problem.allreduce(problem.flat_from_rows(out_rows))


@with_matmul_precision
def hessian_matvec(problem: Problem, lin: Linearization, x: jax.Array,
                   params=None) -> jax.Array:
    """Implicit H x = J^T dL P (J x) — the PCG core (pcg.hpp:141-163)."""
    return JtPv(problem, lin, Jv(problem, lin, x, params), params)


# --------------------------------------------------------------------------
# Parameter update / backup (graph.hpp:292-318, ops/update.hpp, ops/state.hpp)
# --------------------------------------------------------------------------

def apply_update(problem: Problem, params, lin: Linearization,
                 delta_x: jax.Array):
    """params' = retract(params, scales * delta_x) for active vertices
    (ops/update.hpp:9-31; scale correction graph.hpp:292-300)."""
    new_params = {}
    scaled = delta_x * lin.scales
    for name, vm in problem.vertex_meta.items():
        va = problem.data.vertices[name]
        vt = vm.vtype
        rows = problem.rows_view_padded(scaled, name)  # (n_rows+1, d)
        delta = rows[va.active_row].astype(params[name].dtype)  # (V, d)
        updated = jax.vmap(vt.retract)(params[name], delta)
        new_params[name] = jnp.where(va.active[:, None], updated, params[name])
    return new_params


def backup_parameters(problem: Problem, params):
    """Trust-region backup (graph.hpp:302-309): functional — save_state."""
    return {
        name: jax.vmap(vm.vtype.save_state)(params[name])
        for name, vm in problem.vertex_meta.items()
    }


def restore_parameters(problem: Problem, params, backup):
    """Revert to backup with partial-State semantics (ops/state.hpp:46-61)."""
    return {
        name: jax.vmap(vm.vtype.load_state)(params[name], backup[name])
        for name, vm in problem.vertex_meta.items()
    }
