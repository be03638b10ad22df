"""Multi-chip factor-parallel execution over a JAX device mesh.

The reference is a single-process, single-GPU library (SURVEY.md §2
checklist: no DP/TP/PP of any kind; CUDA streams are the only concurrency).
Scaling beyond one card is therefore a pure extension: the natural axis is
**factor parallelism** — shard every factor batch's leading F dimension
across the mesh, replicate vertex parameters and solver vectors, and psum
the cross-factor reductions (b, scalar/block diagonals, chi2, J^T v,
Hessian block values). The mesh is flat and 1-D: every card reaches every
other at the same NVLink rate, so the mesh follows the algorithm alone.

Mechanics:
- ``Graph.freeze(pad_factors_to=n_devices)`` pads every factor block with
  disabled factors so shards are equal;
- ``shard_data`` lays out the GraphData pytree with factor leaves sharded
  on axis 0 and vertex leaves replicated;
- ``problem.shard_replica(local_data, axis)`` is used inside ``shard_map``:
  the same single-chip kernels run on the local shard, and every
  cross-factor reduction point calls ``problem.allreduce`` (lax.psum);
- the Schur triple-product stage is SHARDED too (schur.py): each device
  computes the pair products of one contiguous, segment-aligned range of
  destination blocks, and one all-gather of the disjoint slices
  reassembles S — the dominant stage at scale runs at 1/n per-device
  work. Hll inversion
  and W = Hpl Hll^{-1} stay replicated (cheap). The full LM step,
  including PCG-Schur, runs inside one ``shard_map``.

The LM while_loop itself runs *inside* shard_map (`sharded_lm`), so a whole
optimization is one XLA program with all collectives scheduled by XLA —
zero host round-trips.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # JAX >= 0.6
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map(f, mesh=mesh, in_specs=in_specs,
                          out_specs=out_specs, check_vma=False)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map_old

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map_old(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs, check_rep=False)

from ..graph import GraphData
from ..linearize import apply_update, compute_chi2, linearize

FACTOR_AXIS = "factors"


def make_mesh(n_devices: Optional[int] = None, axis: str = FACTOR_AXIS) -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.asarray(devices[:n]), (axis,))


def data_specs(problem, axis: str = FACTOR_AXIS) -> GraphData:
    """PartitionSpec pytree for GraphData: factors sharded, vertices
    replicated."""
    fspecs = jax.tree.map(lambda _: P(axis), problem.data.factors)
    vspecs = jax.tree.map(lambda _: P(), problem.data.vertices)
    return GraphData(vertices=vspecs, factors=fspecs)


def shard_data(problem, mesh: Mesh, axis: str = FACTOR_AXIS) -> GraphData:
    """Lay the GraphData out across the mesh (factor axis 0 sharded)."""
    specs = data_specs(problem, axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        problem.data, specs,
    )


def sharded_linearize_fn(problem, mesh: Mesh, axis: str = FACTOR_AXIS):
    """jit(shard_map) of one linearization: (data, params) -> (chi2, b,
    scales, diag). For tests and as a building block."""

    def local(data, params):
        p = problem.shard_replica(data, axis, n_devices=mesh.shape[axis])
        lin = linearize(p, params)
        return lin.chi2, lin.b, lin.scales, lin.diag

    pspec = jax.tree.map(lambda _: P(), problem.params0)
    f = shard_map(
        local, mesh,
        in_specs=(data_specs(problem, axis), pspec),
        out_specs=(P(), P(), P(), P()),
    )
    return jax.jit(f)


def sharded_lm_step_fn(problem, mesh: Mesh, solver, damping: float,
                       use_identity: bool = False, axis: str = FACTOR_AXIS):
    """jit(shard_map) of ONE full LM trial step (linearize -> solve ->
    update -> chi2) with a fixed damping factor.

    Returns f(data, params) -> (new_params, chi2_before, chi2_after).
    """

    def local(data, params):
        p = problem.shard_replica(data, axis, n_devices=mesh.shape[axis])
        lin = linearize(p, params)
        sstate = solver.prepare(p, lin, params)
        delta, ok = solver.solve(p, lin, sstate, damping, use_identity, params)
        new_params = apply_update(p, params, lin, delta)
        new_chi2 = compute_chi2(p, new_params)
        return new_params, lin.chi2, new_chi2

    pspec = jax.tree.map(lambda _: P(), problem.params0)
    f = shard_map(
        local, mesh,
        in_specs=(data_specs(problem, axis), pspec),
        out_specs=(pspec, P(), P()),
    )
    return jax.jit(f)


def sharded_lm(problem, mesh: Mesh, solver, options, params=None,
               axis: str = FACTOR_AXIS, with_trace: bool = False):
    """Full LM optimization (accept/reject while_loop) inside one
    shard_map — the multi-chip equivalent of
    ``levenberg_marquardt(..., jit_loop=True)``.

    Returns (params, chi2, iterations, accepted_steps), plus the
    per-iteration (chi2, mu, rho, accepted) device trace when
    ``with_trace`` (observability parity with the single-chip jit_loop).
    """
    import dataclasses

    import jax.numpy as jnp

    from ..optimizers.lm import _initial_carry_traced, _lm_iteration

    params = params if params is not None else problem.params0
    data = shard_data(problem, mesh, axis)

    def local(data, params):
        p = problem.shard_replica(data, axis, n_devices=mesh.shape[axis])
        step = _lm_iteration(p, solver, options)
        carry = _initial_carry_traced(p, solver, params, options)
        if with_trace:
            carry = dataclasses.replace(
                carry, trace=jnp.zeros((options.iterations, 4),
                                       p.precision.graph_dtype))

        def cond(c):
            return (c.k < options.iterations) & c.run

        carry = jax.lax.while_loop(cond, step, carry)
        out = (carry.params, carry.chi2, carry.k, carry.num_accepted)
        return out + ((carry.trace,) if with_trace else ())

    # the compiled program is cached on the problem (as the single-device
    # jit loop is), so a second call with the same mesh, solver and
    # options runs without a retrace
    key = ("sharded_lm", id(mesh), id(solver),
           tuple(sorted(dataclasses.asdict(options).items())), axis,
           with_trace)
    if key not in problem._cache:
        pspec = jax.tree.map(lambda _: P(), problem.params0)
        problem._cache[key] = jax.jit(shard_map(
            local, mesh,
            in_specs=(data_specs(problem, axis), pspec),
            out_specs=(pspec, P(), P(), P())
            + ((P(),) if with_trace else ()),
        ))
    return problem._cache[key](data, params)
