"""Levenberg-Marquardt.

JAX analog of ``optimizer::levenberg_marquardt`` /
``levenberg_marquardt2`` (reference: optimizer/levenberg_marquardt.hpp:109-242,
255-417). Semantics preserved:

- gain ratio ``rho = (chi2 - chi2_new) / (sum dx*(mu*dx + b) + 1e-3)``
  (compute_rho, :19-47);
- accept: ``mu *= clamp(1 - (2 rho - 1)^3, 1/3, 2/3)``, ``nu = 2``,
  relinearize + refresh solver values (:187-196);
- reject: revert parameters, ``mu *= nu``, ``nu *= 2`` (:198-210);
- failed solve => chi2_new = +inf => rejected step (:181-183);
- terminate on non-finite mu (:224-228), rho == 0 (:230-233), or stop flag;
- ``levenberg_marquardt2`` adds the ORB-SLAM-style early stop: 3 accepted
  steps in a row with relative decrease < 1e-3 (:403-413).

Trust-region backup/restore is functional: the previous params pytree *is*
the backup (graph.hpp:302-318 becomes a no-op), with partial-``State``
semantics honored through ``save_state``/``load_state``.

Two execution modes:
- ``jit_loop=False`` (default): Python loop around one jitted LM iteration —
  one scalar readback per iteration (exactly the reference's per-iteration
  host sync, levenberg_marquardt.hpp:166-238) and verbose-table parity.
- ``jit_loop=True``: the entire optimization is one ``lax.while_loop`` —
  zero host round-trips; the fast path for benchmarking.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..linearize import (
    Linearization,
    apply_update,
    backup_parameters,
    compute_chi2,
    linearize,
    restore_parameters,
    slim_linearization,
)


def _slim_carry(solver) -> bool:
    """True when the LM carry should hold a slimmed Linearization (see
    slim_linearization): the solver opted in via ``slim_carry = True``
    (its ``solve`` reads only b/diag/scales) and the
    ``GRAPHITE_TPU_FULL_CARRY`` A/B kill switch is unset."""
    import os

    return (getattr(solver, "slim_carry", False)
            and not os.environ.get("GRAPHITE_TPU_FULL_CARRY"))


@dataclasses.dataclass
class LevenbergMarquardtOptions:
    """Reference ``LevenbergMarquardtOptions`` (levenberg_marquardt.hpp:52-98).

    ``solver``/``streams`` pointers become arguments; ``optimization_level``
    is fixed at ``Graph.freeze`` time.
    """

    iterations: int = 10
    initial_damping: float = 1e-4
    verbose: bool = False
    use_identity: bool = False
    jit_loop: bool = False
    # levenberg_marquardt2 early-stop (":403-413"); None disables.
    early_stop_bad_steps: Optional[int] = None
    early_stop_relative: float = 1e-3
    # capture a device trace of the optimization (jax.profiler) — an
    # upgrade of the reference's wall-clock-only instrumentation
    # (levenberg_marquardt.hpp:153-163)
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class LMResult:
    params: Any
    chi2: float
    initial_chi2: float
    mu: float
    iterations: int
    accepted_steps: int
    run_ok: bool
    history: list


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LMCarry:
    params: Any
    backup: Any
    lin: Linearization
    sstate: Any
    mu: jax.Array
    nu: jax.Array
    chi2: jax.Array
    rho: jax.Array
    accepted: jax.Array  # bool: last step accepted
    num_accepted: jax.Array
    num_bad: jax.Array  # consecutive low-progress accepted steps (LM2)
    run: jax.Array  # bool: keep iterating
    k: jax.Array
    # (iterations, 4) per-iteration [chi2, mu, rho, accepted] trace for
    # jit_loop observability parity with the reference's always-on table
    # (levenberg_marquardt.hpp:153-163); None outside jit_loop mode.
    trace: Any = None


def _lm_iteration(problem, solver, options: LevenbergMarquardtOptions):
    """One LM iteration as a pure function of LMCarry."""

    gdt = problem.precision.graph_dtype
    big = jnp.asarray(jnp.finfo(gdt).max, dtype=gdt)

    def step(carry: LMCarry) -> LMCarry:
        lin = carry.lin
        delta_x, ok = solver.solve(
            problem, lin, carry.sstate, carry.mu, options.use_identity,
            params=carry.params,
        )

        # Try the step (backup is functional: keep old params).
        new_params = apply_update(problem, carry.params, lin, delta_x)
        new_chi2 = compute_chi2(problem, new_params)
        new_chi2 = jnp.where(ok, new_chi2, big)

        # rho (compute_rho, levenberg_marquardt.hpp:19-47)
        dx = delta_x[: problem.dim_h]
        bb = lin.b[: problem.dim_h]
        denom = jnp.where(
            ok, jnp.sum(dx * (carry.mu * dx + bb)) + 1e-3, jnp.asarray(1.0, gdt)
        )
        rho = (carry.chi2 - new_chi2) / denom

        accept = ok & jnp.isfinite(new_chi2) & (rho > 0)

        def on_accept(_):
            alpha = 1.0 - (2.0 * rho - 1.0) ** 3
            alpha = jnp.clip(alpha, 1.0 / 3.0, 2.0 / 3.0)
            lin2 = linearize(problem, new_params)
            sstate2 = solver.prepare(problem, lin2, new_params)
            if _slim_carry(solver):
                # structure matches the (slimmed) initial carry; the
                # factor arrays die inside this branch once prepare has
                # consumed them
                lin2 = slim_linearization(lin2)
            return (
                new_params,
                backup_parameters(problem, new_params),
                lin2,
                sstate2,
                carry.mu * alpha.astype(gdt),
                jnp.asarray(2.0, gdt),
                new_chi2,
            )

        def on_reject(_):
            # Functional revert: re-apply the backup through load_state
            # (partial-State semantics, ops/state.hpp:46-61).
            params = restore_parameters(problem, new_params, carry.backup)
            return (
                params,
                carry.backup,
                lin,
                carry.sstate,
                carry.mu * carry.nu,
                carry.nu * 2.0,
                carry.chi2,
            )

        params2, backup2, lin2, sstate2, mu2, nu2, chi2_2 = jax.lax.cond(
            accept, on_accept, on_reject, None
        )

        # LM2 early-stop bookkeeping (levenberg_marquardt.hpp:403-413).
        # The reference hard-codes the 1e3 factor; `early_stop_relative`
        # generalizes it (default 1e-3 reproduces the reference exactly:
        # (chi2-new)*1e3 < chi2  <=>  chi2-new < chi2*1e-3).
        low_progress = (carry.chi2 - new_chi2) < (
            carry.chi2 * options.early_stop_relative)
        num_bad = jnp.where(
            accept,
            jnp.where(low_progress, carry.num_bad + 1, 0),
            carry.num_bad,
        )

        run = carry.run & jnp.isfinite(mu2) & (rho != 0)
        if options.early_stop_bad_steps is not None:
            run = run & (num_bad < options.early_stop_bad_steps)

        trace = carry.trace
        if trace is not None:
            row = jnp.stack([chi2_2, mu2, rho, accept]).astype(trace.dtype)
            trace = jax.lax.dynamic_update_slice(
                trace, row[None, :], (carry.k, jnp.asarray(0, jnp.int32)))

        return LMCarry(
            params=params2,
            backup=backup2,
            lin=lin2,
            sstate=sstate2,
            mu=mu2,
            nu=nu2,
            chi2=chi2_2,
            rho=rho,
            accepted=accept,
            num_accepted=carry.num_accepted + accept.astype(jnp.int32),
            num_bad=num_bad,
            run=run,
            k=carry.k + 1,
            trace=trace,
        )

    return step


def _initial_carry_traced(problem, solver, params, options) -> LMCarry:
    """Traceable initial-carry construction (used inside shard_map too)."""
    gdt = problem.precision.graph_dtype
    lin = linearize(problem, params)
    sstate = solver.prepare(problem, lin, params)
    if _slim_carry(solver):
        lin = slim_linearization(lin)
    return _make_carry(problem, params, lin, sstate, options)


def _initial_carry(problem, solver, params, options) -> LMCarry:
    init_key = ("lm_init", id(solver))
    if init_key not in problem._cache:
        def _init(p):
            lin = linearize(problem, p)
            return lin, solver.prepare(problem, lin, p)

        problem._cache[init_key] = problem.jit_with_consts(_init)
    lin, sstate = problem._cache[init_key](params)
    if _slim_carry(solver):
        lin = slim_linearization(lin)
    return _make_carry(problem, params, lin, sstate, options)


def _make_carry(problem, params, lin, sstate, options) -> LMCarry:
    gdt = problem.precision.graph_dtype
    return LMCarry(
        params=params,
        backup=backup_parameters(problem, params),
        lin=lin,
        sstate=sstate,
        mu=jnp.asarray(options.initial_damping, gdt),
        nu=jnp.asarray(2.0, gdt),
        chi2=lin.chi2,
        rho=jnp.asarray(1.0, gdt),
        accepted=jnp.asarray(False),
        num_accepted=jnp.asarray(0, jnp.int32),
        num_bad=jnp.asarray(0, jnp.int32),
        run=jnp.asarray(True),
        k=jnp.asarray(0, jnp.int32),
    )


def levenberg_marquardt(problem, solver, params=None,
                        options: Optional[LevenbergMarquardtOptions] = None,
                        stop_flag=None) -> LMResult:
    options = options or LevenbergMarquardtOptions()
    params = params if params is not None else problem.params0

    if options.profile_dir:
        import dataclasses as _dc

        inner = _dc.replace(options, profile_dir=None)
        with jax.profiler.trace(options.profile_dir):
            return levenberg_marquardt(problem, solver, params, inner,
                                       stop_flag)

    # _slim_carry is read at TRACE time (GRAPHITE_TPU_FULL_CARRY env +
    # solver attribute): it must be part of the cache key or toggling the
    # A/B switch after a first run silently reuses the compiled loop
    key = ("lm", id(solver), options.use_identity,
           options.early_stop_bad_steps, options.early_stop_relative,
           options.jit_loop, options.iterations if options.jit_loop else None,
           _slim_carry(solver))
    if options.jit_loop:
        if key not in problem._cache:

            def run_all(p):
                # initial linearize/prepare fused into the same program as
                # the while loop: one device program per optimization call.
                #
                # The step closure MUST be created inside run_all: JAX
                # caches while_loop body jaxprs keyed on the body function
                # object, so a step reused across the consts-registration
                # eval_shape pass (which runs with concrete problem.data)
                # and the real jit trace would bake the GraphData leaves
                # into the loop body as constants — silently breaking
                # runtime remasking (Problem.remask).
                step = _lm_iteration(problem, solver, options)
                carry0 = _initial_carry_traced(problem, solver, p, options)
                gdt = problem.precision.graph_dtype
                carry0 = dataclasses.replace(
                    carry0,
                    trace=jnp.zeros((options.iterations, 4), gdt))

                def cond(c):
                    return (c.k < options.iterations) & c.run

                return carry0.chi2, jax.lax.while_loop(cond, step, carry0)

            problem._cache[key] = problem.jit_with_consts(run_all)
        t0 = _time.perf_counter()
        initial_chi2, carry = problem._cache[key](params)
        # ONE batched device->host transfer instead of one synchronizing
        # float()/int() pull per value.
        chi2, initial_chi2, mu, k, num_accepted, run, trace = jax.device_get(
            (carry.chi2, initial_chi2, carry.mu, carry.k,
             carry.num_accepted, carry.run, carry.trace))
        wall = _time.perf_counter() - t0
        # rebuild the per-iteration table from the on-device trace (parity
        # with the reference's always-printed table on the fast path)
        history = []
        prev = float(initial_chi2)
        # The fused while_loop has no per-iteration host sync, so the only
        # observable per-iteration wall clock is the AVERAGE over the run
        # (wall includes initial linearize + compile-cache hit + readback;
        # the reference prints true per-iteration times because it syncs
        # every iteration, levenberg_marquardt.hpp:153-163).
        avg_dt = wall / max(int(k), 1)
        for i in range(int(k)):
            c_i, mu_i, rho_i, acc_i = (float(trace[i, 0]), float(trace[i, 1]),
                                       float(trace[i, 2]), float(trace[i, 3]))
            history.append(
                dict(iteration=i, chi2_before=prev, chi2=c_i, mu=mu_i,
                     rho=rho_i, accepted=bool(acc_i), time=avg_dt))
            prev = c_i
        if options.verbose and history:
            hdr = (f"{'Iteration':>12} {'Initial Chi2':>18} "
                   f"{'Current Chi2':>18} {'Lambda':>14} {'Rho':>12}")
            print(hdr)
            print("-" * len(hdr))
            for h in history:
                print(f"{h['iteration']:>12d} {h['chi2_before']:>18.10g} "
                      f"{h['chi2']:>18.10g} {h['mu']:>14.6g} "
                      f"{h['rho']:>12.6g}")
        return LMResult(
            params=carry.params,
            chi2=float(chi2),
            initial_chi2=float(initial_chi2),
            mu=float(mu),
            iterations=int(k),
            accepted_steps=int(num_accepted),
            run_ok=bool(run),
            history=history,
        )

    if key not in problem._cache:
        problem._cache[key] = problem.jit_with_consts(
            _lm_iteration(problem, solver, options)
        )
    step = problem._cache[key]

    t0 = _time.perf_counter()
    carry = _initial_carry(problem, solver, params, options)
    initial_chi2 = float(carry.chi2)
    total = _time.perf_counter() - t0

    if options.verbose:
        hdr = (f"{'Iteration':>12} {'Initial Chi2':>18} {'Current Chi2':>18} "
               f"{'Lambda':>14} {'Time':>12} {'Total Time':>12}")
        print(hdr)
        print("-" * len(hdr))

    history = []
    run_ok = True
    for i in range(options.iterations):
        t0 = _time.perf_counter()
        prev_chi2 = float(carry.chi2)
        carry = step(carry)
        # one batched host sync per iteration (the reference syncs scalars
        # per iteration too, levenberg_marquardt.hpp:166-238)
        chi2, mu, rho, accepted, run = (
            jax.device_get((carry.chi2, carry.mu, carry.rho,
                            carry.accepted, carry.run)))
        chi2, mu, rho = float(chi2), float(mu), float(rho)
        dt = _time.perf_counter() - t0
        total += dt
        history.append(
            dict(iteration=i, chi2_before=prev_chi2, chi2=chi2, mu=mu,
                 rho=rho, accepted=bool(accepted), time=dt)
        )
        if options.verbose:
            print(f"{i:>12d} {prev_chi2:>18.10g} {chi2:>18.10g} "
                  f"{mu:>14.6g} {dt:>12.4g} {total:>12.4g}")
        if not bool(run):
            import math

            if not math.isfinite(mu):
                print("Damping factor is infinite, terminating optimization")
                run_ok = False
            elif rho == 0:
                print("Rho is zero, terminating optimization")
            break
        if stop_flag is not None and stop_flag():
            print("Stopping optimization due to stop flag")
            break

    return LMResult(
        params=carry.params,
        chi2=float(carry.chi2),
        initial_chi2=initial_chi2,
        mu=float(carry.mu),
        iterations=int(carry.k),
        accepted_steps=int(carry.num_accepted),
        run_ok=run_ok,
        history=history,
    )


def levenberg_marquardt2(problem, solver, params=None,
                         options: Optional[LevenbergMarquardtOptions] = None,
                         stop_flag=None) -> LMResult:
    """LM with ORB-SLAM-style early termination
    (reference levenberg_marquardt2, :255-417)."""
    options = options or LevenbergMarquardtOptions()
    options = dataclasses.replace(options, early_stop_bad_steps=3)
    return levenberg_marquardt(problem, solver, params, options, stop_flag)
