"""Headline benchmark: BAL Ladybug-49-scale LM iterations/sec on one GPU.

Workload (mirrors the reference BAL app defaults, examples/bal.cu:284-309):
synthetic Ladybug-49-sized bundle adjustment (49 cameras, 7776 points, 31843
observations; seeded synthetic data, no downloads), fp32, LM with PCG-Schur
(10 inner iterations, tol 1.0, rejection 5.0), block-Jacobi-Schur
preconditioner. The whole LM loop runs as ONE XLA program (jit_loop);
each iteration is: solve (Schur rebuild + 10 PCG iterations) + update +
chi2 + accept/reject (+ full relinearization and Hessian reassembly on
accepted steps).

Grounding: alongside the headline iters/sec the JSON carries a FLOP/MFU
ledger (graphite_tpu/perf.py) — useful FLOPs counted analytically from the
static structure, per-stage device milliseconds (each stage run STAGE_N
times inside one jitted fori_loop), achieved GFLOP/s and GB/s per stage,
and MFU against the card's published bf16 peak (omitted for a device kind
perf.device_peak does not know). This workload is gather/scatter-bound
(3x3..9x9 blocks), so MFU is intrinsically low; the meaningful roofline is
memory bandwidth.

The reference publishes no numbers (BASELINE.md), so there is no baseline
ratio. Every result names the device and the card's power limit; with no
GPU the script exits non-zero and prints no result.

Output: ONE JSON line on stdout.
"""

import json
import sys
import time

# No argument = the default run: ladybug with full stage probes, PLUS quick
# venice-big + pose throughput passes in subprocesses (their JSON lines are
# printed first and nested into the final object). Explicit sizes run one
# regime; "venice-quick"/"pose" are the probe-free quick modes.
SIZE = sys.argv[1] if len(sys.argv) > 1 else "default"
QUICK = SIZE.endswith("-quick")
if SIZE == "venice-quick":
    SIZE = "venice-big"
elif SIZE == "default":
    SIZE = "ladybug"
ITERATIONS = 20
STAGE_N = 200  # per-stage calls inside one jitted fori_loop


def run_extra_regimes():
    """Run the quick venice-big + pose passes as SUBPROCESSES and return
    their parsed JSON metrics. The parent has not imported JAX yet when
    they run (main() imports it afterwards), so only one process at a
    time holds the card: a JAX process reserves most of its memory."""
    import os
    import subprocess

    if os.environ.get("GRAPHITE_TPU_BENCH_EXTRAS", "1") == "0":
        return {}
    out = {}
    for mode, budget_s in (("venice-quick", 3600), ("pose", 1800)):
        log(f"--- extra regime: {mode} (subprocess) ---")
        try:
            r = subprocess.run(
                [sys.executable, __file__, mode], capture_output=True,
                text=True, timeout=budget_s)
            sys.stderr.write(r.stderr[-4000:])
            line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() \
                else ""
            parsed = json.loads(line)
            print(line, flush=True)  # extra JSON line before the final one
            out[mode] = parsed
        except Exception as e:  # noqa: BLE001 - extras are best-effort
            log(f"extra regime {mode} FAILED: {type(e).__name__}: {e}")
    return out


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def setup_device():
    """The device record for the JSON (exits non-zero without a GPU) and
    the persistent compile cache."""
    from graphite_tpu.runtime import (
        card_info,
        device_record,
        enable_compile_cache,
        require_gpu,
    )

    devices = require_gpu()
    enable_compile_cache()
    card = card_info()
    log(f"devices: {devices}; card (name, power limit): {card}")
    return dict(device=device_record(devices), card=card)


def stage_ms(jax, jnp, problem, body, *args):
    # jit_with_consts semantics, but AOT (lower+compile explicitly) so the
    # compiled program's own cost analysis is available: XLA's
    # bytes-accessed figure per stage call turns the measured ms into an
    # achieved-GB/s column — the meaningful roofline for this
    # gather/scatter-bound workload. The static index arrays and the
    # probe's live arrays (lin0/hv0/sv0/...) ride as executable arguments,
    # not inlined HLO constants.
    def fn(*a):
        return jax.lax.fori_loop(
            0, STAGE_N, lambda i, acc: body(i, acc, *a), jnp.float32(0))

    mat_prec = problem.precision.matmul_precision
    with jax.default_matmul_precision(mat_prec):
        jax.eval_shape(fn, *args)  # registers consts, no compile

    def inner(consts, data, *a):
        with problem.bind_consts(consts), problem.bind_data(data), \
                jax.default_matmul_precision(mat_prec):
            return fn(*a)

    compiled = jax.jit(inner).lower(
        problem.consts(), problem.data, *args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    ca = ca or {}
    xla_bytes = float(ca.get("bytes accessed", 0.0)) / STAGE_N
    jax.block_until_ready(compiled(problem.consts(), problem.data, *args))
    best = float("inf")
    for _ in range(2):
        t = time.perf_counter()
        jax.block_until_ready(
            compiled(problem.consts(), problem.data, *args))
        best = min(best, time.perf_counter() - t)
    return best * 1e3 / STAGE_N, xla_bytes


def pose_main():
    """BASELINE config 3: sphere2500-scale SE3 pose graph, LM + matrix-free
    PCG (block-Jacobi), jit_loop. Emits ONE JSON line like the BA modes."""
    where = setup_device()

    import graphite_tpu as gt
    from graphite_tpu.io import g2o, synthetic
    from graphite_tpu.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )
    from graphite_tpu.preconditioners import BlockJacobiPreconditioner
    from graphite_tpu.solvers import PCGSolver

    t0 = time.perf_counter()
    ds = synthetic.make_sphere_se3(2500, seed=0)
    g, *_ = g2o.build_graph(ds, precision=gt.FP32_FP32)
    problem = g.freeze()
    log(f"pose graph: {ds.num_vertices} poses / {ds.num_edges} edges, "
        f"dim_h={problem.dim_h} ({time.perf_counter() - t0:.1f}s)")

    solver = PCGSolver(max_iter=50, tol=1e-10, rejection_ratio=1e6,
                       preconditioner=BlockJacobiPreconditioner())
    iters = 30
    opts = LevenbergMarquardtOptions(iterations=iters, initial_damping=1e-4,
                                     jit_loop=True)
    t0 = time.perf_counter()
    res = levenberg_marquardt(problem, solver, options=opts)
    log(f"warmup (compile+run): {time.perf_counter() - t0:.1f}s, "
        f"chi2 {res.initial_chi2:.6g} -> {res.chi2:.6g}, "
        f"{res.iterations} iters ({res.accepted_steps} accepted)")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = levenberg_marquardt(problem, solver, options=opts)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"timed run: {dt:.3f}s ({res.iterations / dt:.2f} iters/sec)")
    iters_per_sec = res.iterations / best

    time_to_1e6 = None
    per_it = best / max(res.iterations, 1)
    for h in res.history:
        if h["chi2"] - res.chi2 <= 1e-6 * abs(res.chi2):
            time_to_1e6 = round((h["iteration"] + 1) * per_it, 4)
            break
    print(json.dumps({
        "metric": "pose_sphere2500_lm_pcg_iters_per_sec",
        "value": round(iters_per_sec, 3),
        "unit": "iter/s",
        "per_iter_ms": round(1e3 / iters_per_sec, 2),
        "time_to_1e6_rel_final_cost_s": time_to_1e6,
        "pcg_inner_iters": solver.max_iter,
        "accept_rate": round(res.accepted_steps / max(res.iterations, 1), 2),
        "chi2_final": float(f"{res.chi2:.6g}"),
        **where,
    }))


def main(extras=None):
    where = setup_device()

    import jax
    import jax.numpy as jnp

    import graphite_tpu as gt
    from graphite_tpu import perf
    from graphite_tpu.hessian import (
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu.io import bal as bal_io
    from graphite_tpu.io import synthetic
    from graphite_tpu.linearize import linearize
    from graphite_tpu.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )
    from graphite_tpu.schur import build_schur_structure, schur_values
    from graphite_tpu.solvers import PCGSchurSolver

    import os

    t0 = time.perf_counter()
    ds = synthetic.make_bal(SIZE, seed=0)
    # GRAPHITE_TPU_BENCH_PRECISION=fp32_bf16 A/Bs the low-precision
    # STORAGE policy (bf16 J + Hessian/S blocks, f32 graph/accum)
    prec = {"fp32_fp32": gt.FP32_FP32,
            "fp32_bf16": gt.FP32_BF16}[os.environ.get(
                "GRAPHITE_TPU_BENCH_PRECISION", "fp32_fp32")]
    g, *_ = bal_io.build_graph(ds, precision=prec)
    problem = g.freeze()
    log(f"problem built: {ds.num_cameras} cams / {ds.num_points} pts / "
        f"{ds.num_observations} obs, dim_h={problem.dim_h} "
        f"({time.perf_counter() - t0:.1f}s)")

    solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    opts = LevenbergMarquardtOptions(
        iterations=ITERATIONS, initial_damping=1e-4, jit_loop=True
    )

    t0 = time.perf_counter()
    res = levenberg_marquardt(problem, solver, options=opts)
    log(f"warmup (compile+run): {time.perf_counter() - t0:.1f}s, "
        f"chi2 {res.initial_chi2:.6g} -> {res.chi2:.6g}, "
        f"{res.iterations} iters ({res.accepted_steps} accepted)")

    # timed runs (executable cached)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = levenberg_marquardt(problem, solver, options=opts)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        log(f"timed run: {dt:.3f}s ({res.iterations / dt:.2f} iters/sec)")

    iters_per_sec = res.iterations / best
    accept_rate = res.accepted_steps / max(res.iterations, 1)

    if QUICK:
        # probe-free throughput pass (subprocess regime of the default
        # run): one JSON line, no stage probes / ledger
        time_to_1e6 = None
        per_it = best / max(res.iterations, 1)
        for h in res.history:
            if h["chi2"] - res.chi2 <= 1e-6 * abs(res.chi2):
                time_to_1e6 = round((h["iteration"] + 1) * per_it, 4)
                break
        metric_size = "ladybug49" if SIZE == "ladybug" else SIZE
        print(json.dumps({
            "metric": f"bal_{metric_size}_lm_pcg_schur_iters_per_sec",
            "value": round(iters_per_sec, 3),
            "unit": "iter/s",
            "per_iter_ms": round(1e3 / iters_per_sec, 2),
            "time_to_1e6_rel_final_cost_s": time_to_1e6,
            "accept_rate": round(accept_rate, 2),
            "chi2_final": float(f"{res.chi2:.6g}"),
            **where,
        }))
        return

    # ---- FLOP/MFU ledger + per-stage device timings ------------------------
    led = perf.flop_ledger(problem, pcg_iters=solver.max_iter)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    params = problem.params0

    lin0 = jax.jit(lambda p: linearize(problem, p))(params)
    hv0 = jax.jit(lambda l: compute_hessian_values(problem, hs, l))(lin0)

    def _fence(acc, *trees):
        # loop-variance WITHOUT perturbation traffic: tying the invariant
        # stage inputs to the carry through an optimization_barrier makes
        # them loop-variant for LICM at zero data-movement cost (a
        # `v + acc * 1e-30` perturbation would add a full elementwise pass
        # over the big block arrays)
        out = jax.lax.optimization_barrier((acc, *trees))
        return out[0], *out[1:]

    def lin_body(i, acc, params):
        acc, p = _fence(acc, params)
        return acc + linearize(problem, p).chi2 * 1e-30

    def hess_body(i, acc, lin0):
        acc, lin = _fence(acc, lin0)
        hv = compute_hessian_values(problem, hs, lin)
        return acc + jnp.sum(next(iter(hv.values()))[0]) * 1e-30

    def schur_body(i, acc, hv0):
        acc, hv = _fence(acc, hv0)
        sv = schur_values(problem, ss, hv)
        return acc + jnp.sum(next(iter(sv.s_vals.values()))[0]) * 1e-30

    def chi2_body(i, acc, params):
        from graphite_tpu.linearize import compute_chi2
        acc, p = _fence(acc, params)
        return acc + compute_chi2(problem, p) * 1e-30

    def damping_body(i, acc, hv0, diag):
        from graphite_tpu.hessian import apply_damping
        acc, hv, dg = _fence(acc, hv0, diag)
        hd = apply_damping(problem, hs, hv, dg,
                           jnp.asarray(1e-4, jnp.float32), False)
        return acc + jnp.sum(next(iter(hd.values()))[0]) * 1e-30

    def solve_body(i, acc, lin0, hv0, params):
        import dataclasses
        lin = dataclasses.replace(lin0, b=lin0.b + acc * 1e-30)
        from graphite_tpu.solvers.pcg_schur import SchurSolverState
        dx, ok = solver.solve(problem, lin, SchurSolverState(hvals=hv0),
                              jnp.asarray(1e-4, lin0.b.dtype) + acc * 1e-30,
                              False, params=params)
        return acc + dx[0] * 1e-30

    # --- solve-breakdown probes: where do the per-solve
    # milliseconds go — b_schur, one S matvec (block-sparse and, when
    # enabled, dense), preconditioner apply, landmark back-substitution.
    # Every live array rides as a jit argument (see stage_ms). ---
    from graphite_tpu.hessian import apply_damping
    from graphite_tpu.schur import SchurOps

    stages = {}
    try:
        sv0 = problem.jit_with_consts(lambda hv, dg: schur_values(
            problem, ss, apply_damping(
                problem, hs, hv, dg, jnp.asarray(1e-4, lin0.b.dtype),
                False)))(hv0, lin0.diag)
        b_s0 = problem.jit_with_consts(
            lambda hv, sv, b: SchurOps(problem, ss, hv, sv).b_schur(b)
        )(hv0, sv0, lin0.b)
        pstate0 = problem.jit_with_consts(
            lambda sv: solver.preconditioner.prepare(problem, ss, sv))(sv0)
        solve_probes_ok = True
    except Exception as e:  # noqa: BLE001 - probes are best-effort
        log(f"solve-breakdown prep FAILED: {type(e).__name__}: {e}")
        solve_probes_ok = False

    def bschur_body(i, acc, hv0, sv0, b):
        ops = SchurOps(problem, ss, hv0, sv0)
        return acc + ops.b_schur(b + acc * 1e-30)[0] * 1e-30

    def smatvec_body(i, acc, hv0, sv0, b_s0):
        ops = SchurOps(problem, ss, hv0, sv0)
        return acc + ops.s_matvec(b_s0 + acc * 1e-30)[0] * 1e-30

    def dense_matvec_body(i, acc, sv0, b_s0):
        from graphite_tpu.solvers.dense_cholesky_schur import schur_to_dense
        S = schur_to_dense(problem, ss, sv0)
        p = b_s0 + acc * 1e-30
        return acc + (S @ p.astype(S.dtype))[0] * 1e-30

    def precond_body(i, acc, pstate0, b_s0):
        y = solver.preconditioner.apply(problem, ss, pstate0,
                                        b_s0 + acc * 1e-30)
        return acc + y[0] * 1e-30

    def backsub_body(i, acc, hv0, sv0, b, b_s0):
        ops = SchurOps(problem, ss, hv0, sv0)
        rows = ops.landmark_update(b, b_s0 + acc * 1e-30)
        return acc + next(iter(rows.values()))[0, 0] * 1e-30

    schur_flops = (led.get("hll_inverse", 0) + led.get("hpl_w", 0)
                   + led.get("triple_products", 0))
    # logical byte floors per stage (perf.bytes_ledger): achieved GB/s
    # against these is the roofline-utilization column
    byt = perf.bytes_ledger(problem, pcg_iters=solver.max_iter)
    probes = [
        ("linearize", lin_body, None, None, (params,)),
        ("chi2_only", chi2_body, None, None, (params,)),
        ("hessian_values", hess_body, led.get("hessian_values"), None,
         (lin0,)),
        ("apply_damping", damping_body, None, None, (hv0, lin0.diag)),
        ("schur_values", schur_body, schur_flops, byt.get("schur_values"),
         (hv0,)),
    ]
    probes.append(("solve_full", solve_body, None, None,
                   (lin0, hv0, params)))
    if solve_probes_ok:
        probes[3:3] = [  # after schur_values, before any solve_full
            ("b_schur", bschur_body, led.get("b_schur"),
             byt.get("b_schur"), (hv0, sv0, lin0.b)),
            ("s_matvec_block", smatvec_body, None, byt.get("s_matvec"),
             (hv0, sv0, b_s0)),
            ("precond_apply", precond_body, led.get("precond"), None,
             (pstate0, b_s0)),
            ("backsub", backsub_body, led.get("backsub"),
             byt.get("backsub"), (hv0, sv0, lin0.b, b_s0)),
        ]
        probes.append(("s_matvec_dense_incl_build", dense_matvec_body,
                       None, None, (sv0, b_s0)))
    for name, body, flops, bytes_floor, args in probes:
        try:
            ms, xla_bytes = stage_ms(jax, jnp, problem, body, *args)
        except Exception as e:  # noqa: BLE001 - stage probes are best-effort
            log(f"stage {name:<16} FAILED: {type(e).__name__}")
            stages[name] = dict(ms=None)
            continue
        stages[name] = dict(ms=round(ms, 3))
        extra = ""
        if flops and ms > 1e-3:  # below a microsecond the rate is noise
            stages[name]["gflops"] = round(flops / (ms * 1e6), 1)
            extra += f"  {stages[name]['gflops']:7.1f} GFLOP/s"
        if ms > 1e-3:
            if bytes_floor:
                # GB/s against the logical byte floor: how far the stage
                # sits from pure-bandwidth speed-of-light
                stages[name]["gbps_floor"] = round(
                    bytes_floor / (ms * 1e6), 1)
                extra += f"  {stages[name]['gbps_floor']:6.1f} GB/s(floor)"
            if xla_bytes:
                # XLA's own bytes-accessed for the compiled program: the
                # traffic the implementation actually schedules
                stages[name]["gbps_xla"] = round(xla_bytes / (ms * 1e6), 1)
                stages[name]["xla_mb"] = round(xla_bytes / 1e6, 1)
                extra += f"  {stages[name]['gbps_xla']:6.1f} GB/s(xla)"
        log(f"stage {name:<16} {ms:7.3f} ms" + extra)

    # useful FLOPs per LM iteration: solve stages every iteration, linearize
    # + Hessian reassembly only on accepted steps
    per_iter_flops = (
        sum(led.get(k, 0.0) for k in
            ("hll_inverse", "hpl_w", "triple_products", "b_schur",
             "pcg_matvec", "precond", "backsub"))
        + accept_rate * led.get("hessian_values", 0.0)
    )
    # MFU only against a published peak for this device kind
    peak = perf.device_peak()
    mfu = {"mfu_pct": round(
        100 * per_iter_flops * iters_per_sec / peak["bf16"], 4)} if peak \
        else {}

    # North-star metric (BASELINE.md): wall-clock from
    # optimization start until chi2 is within 1e-6 RELATIVE of the run's
    # converged (final) value. Derived from the jit_loop on-device trace:
    # iterations are uniform device work inside one while_loop, so
    # time(i) = (i+1) * best_wall / iters_run.
    time_to_1e6 = None
    if res.history:
        final = res.chi2
        per_it = best / max(res.iterations, 1)
        for h in res.history:
            if h["chi2"] - final <= 1e-6 * abs(final):
                time_to_1e6 = round((h["iteration"] + 1) * per_it, 4)
                break

    metric_size = "ladybug49" if SIZE == "ladybug" else SIZE
    payload = {
        "metric": f"bal_{metric_size}_lm_pcg_schur_iters_per_sec",
        "value": round(iters_per_sec, 3),
        "unit": "iter/s",
        "per_iter_ms": round(1e3 / iters_per_sec, 2),
        "time_to_1e6_rel_final_cost_s": time_to_1e6,
        "useful_mflop_per_iter": round(per_iter_flops / 1e6, 1),
        **mfu,
        "accept_rate": round(accept_rate, 2),
        "ledger_mflop": {k: round(v / 1e6, 1) for k, v in led.items()},
        "stages": stages,
        "chi2_final": float(f"{res.chi2:.6g}"),
        **where,
    }
    if extras:
        payload["scale_regimes"] = {
            k: {f: v.get(f) for f in
                ("metric", "value", "unit", "per_iter_ms",
                 "time_to_1e6_rel_final_cost_s", "accept_rate",
                 "chi2_final")}
            for k, v in extras.items()
        }
    print(json.dumps(payload))


if __name__ == "__main__":
    if SIZE == "pose":
        pose_main()
    elif len(sys.argv) > 1:
        main()
    else:
        # default driver run: quick scale regimes first (subprocesses),
        # then the fully-probed ladybug headline with the extras nested
        main(extras=run_extra_regimes())
