"""Smoke check of the main path on an NVIDIA GPU.

Drives the system through the entry points a user calls (``Graph.freeze``
-> ``levenberg_marquardt(jit_loop=True)`` -> PCG-Schur / matrix-free PCG
/ direct solvers) at published BAL and pose-graph sizes, on seeded
synthetic data, and compares what comes out with host float64
references. The last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases, one card (solver settings: the reference's BAL defaults,
examples/bal.cu:284-309; lambda0 = 1e-4):

  ladybug  49 cameras / 7,776 points / 31,843 observations, FP32_FP32,
           PCGSchurSolver(10, 1.0, 5.0), 50 LM iterations (the reference
           app's default; the longer run narrows how far atomic-add
           order moves the final chi2). Checks S,
           b_Schur and the landmark update at the first linearisation
           against the block-sparse float64 reference, and the final
           chi2 against the same LM run at FP64_FP64 on the CPU device.
  pose     sphere2500 SE3, PCGSolver(50, 1e-10, 1e6, block-Jacobi), 30 LM
           iterations. Checks one matrix-free H x against a host float64
           J^T (P J x), and the final chi2 against FP64_FP64 on the CPU.
  venice   1,778 cameras / 993,923 points / 5,001,946 observations,
           PCG-Schur, 3 LM iterations. Checks 1,000 random S blocks
           recomputed on the host in float64, one S matvec against a host
           BSR product of the card's own S, and that chi2 is finite and
           not above its initial value; prints a profiler breakdown of the
           warm run.
  direct   Ladybug size: dense-Schur and full-H direct solves on the
           device and through the host callback, against SciPy, timed.

Tolerances and why:
  S, b_Schur,  1e-6 x the largest summed term (|Hpp| + |Hpl||Hll^-1||Hpl|^T
  landmark dx  and its analogs): these stages are float32 sums whose terms
               cancel (S = Hpp - Hpl Hll^-1 Hpl^T), so float32 rounding
               (eps 6e-8) scales with the terms, not with the result;
               1e-6 leaves room for atomic adds whose order changes from
               run to run. The error relative to max|ref| is printed too:
               there the cancellation alone costs up to ~1e-4.
  H x, S x     1e-4 x max|ref|: float32 products and atomic-add order.
  final chi2   2e-3 relative to the float64 run of the same length. PCG
               with a loose tolerance solves each step inexactly, so
               rounding (and atomic-add order) moves the LM path: after 10
               Ladybug iterations the card and the float64 run differed by
               2.1e-4 and 1.7e-3 in two runs, after 50 (the app default,
               used here) by 6.5e-6 and 1.7e-4. A wrong stage moves chi2
               by orders of magnitude; the stage checks above bound
               subtle errors.
  4-card chi2  1e-2 relative to one card after the first accepted LM
               step (one inexact PCG solve summed in another order);
               later steps compound it, so the final chi2 is only held to
               be finite and below its initial value.
  direct dx    backward error |H dx - b| / (|H| |dx| + |b|) <= 1e-5: a
               float32 factorization of the damped system is backward
               stable to a small multiple of eps; the forward difference
               from SciPy's float64 solve (printed) grows with cond(H).

    python chip_smoke.py            # the four phases on one card, in order
    python chip_smoke.py --cards 4  # sharded LM on four cards against one
                                    # card, and no other phase

Exits non-zero, printing no result, when JAX finds no GPU. No phase
failure is caught.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import tempfile
import time

import numpy as np

LAMBDA0 = 1e-4
BA_SOLVER = dict(max_iter=10, tol=1.0, rejection_ratio=5.0)


def log(*a):
    print(*a, flush=True)


def check(name: str, err: float, tol: float, reason: str) -> None:
    log(f"  check {name}: {err:.3e} <= {tol:.1e} ({reason})")
    if not err <= tol:  # NaN fails too
        raise AssertionError(f"{name}: {err:.3e} exceeds {tol:.1e}")


def check_terms(name, got, ref, terms, reason="f32 rounding of the "
                "summed terms, atomic-add order"):
    """Cancellation-aware check: error against the size of the terms."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    log(f"  {name}: max error {err.max():.3e} = {rel_max(got, ref):.3e} "
        f"of max|ref|")
    check(f"{name} (of the largest summed term)",
          float(err.max() / np.asarray(terms).max()), 1e-6, reason)


def rel_max(a, ref) -> float:
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


def peak_gb(device) -> float:
    return device.memory_stats()["peak_bytes_in_use"] / 1e9


# ---------------------------------------------------------------------------
# shared runners
# ---------------------------------------------------------------------------

def bal_problem(name, precision):
    from graphite_tpu.io import bal as bal_io
    from graphite_tpu.io import synthetic

    ds = synthetic.make_bal(name, seed=0)
    g, *_ = bal_io.build_graph(ds, precision=precision)
    return g.freeze()


def pose_problem(precision):
    from graphite_tpu.io import g2o, synthetic

    ds = synthetic.make_sphere_se3(2500, seed=0)
    g, *_ = g2o.build_graph(ds, precision=precision)
    return g.freeze()


def lm_options(iters):
    from graphite_tpu.optimizers import LevenbergMarquardtOptions

    return LevenbergMarquardtOptions(iterations=iters,
                                     initial_damping=LAMBDA0, jit_loop=True)


def run_lm(problem, solver, iters, label):
    """Cold (compile + run) and warm runs of the jit-loop LM."""
    from graphite_tpu.optimizers import levenberg_marquardt

    opts = lm_options(iters)
    t0 = time.perf_counter()
    levenberg_marquardt(problem, solver, options=opts)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = levenberg_marquardt(problem, solver, options=opts)
    warm = time.perf_counter() - t0
    log(f"  {label}: cold {cold:.2f} s (compile + run; compile ~"
        f"{cold - warm:.2f} s), warm {warm:.4f} s "
        f"= {1e3 * warm / max(res.iterations, 1):.3f} ms per LM iteration "
        f"({res.iterations} iterations, {res.accepted_steps} accepted), "
        f"chi2 {res.initial_chi2:.9g} -> {res.chi2:.9g}")
    return res


def fp64_cpu_lm(build, solver, iters):
    """The same LM run at FP64_FP64 on the CPU device (the float64
    reference; it never touches the card)."""
    import jax

    import graphite_tpu as gt
    from graphite_tpu.optimizers import levenberg_marquardt

    t0 = time.perf_counter()
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        res = levenberg_marquardt(build(gt.FP64_FP64), solver,
                                  options=lm_options(iters))
    log(f"  fp64 reference on the CPU device: chi2 {res.initial_chi2:.9g} "
        f"-> {res.chi2:.9g} ({res.iterations} iterations, "
        f"{res.accepted_steps} accepted, {time.perf_counter() - t0:.1f} s)")
    return res


def check_chi2(res, ref):
    check("final chi2 vs fp64 CPU run", abs(res.chi2 - ref.chi2)
          / abs(ref.chi2), 2e-3, "rounding moves the inexact-PCG LM path")


def first_linearisation(problem):
    """Damped Hessian and Schur values at params0 (lambda0), on device."""
    from graphite_tpu.hessian import (
        apply_damping,
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu.linearize import linearize
    from graphite_tpu.schur import build_schur_structure, schur_values

    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)

    def f(params):
        lin = linearize(problem, params)
        hv = apply_damping(problem, hs,
                           compute_hessian_values(problem, hs, lin),
                           lin.diag, LAMBDA0, False)
        return lin, hv, schur_values(problem, ss, hv)

    lin, hv, sv = problem.jit_with_consts(f)(problem.params0)
    return hs, ss, lin, hv, sv


# ---------------------------------------------------------------------------
# profiler trace -> per-op device time
# ---------------------------------------------------------------------------

STAGES = ("schur_values", "b_schur", "s_matvec", "landmark_update",
          "hessian_matvec", "compute_hessian_values", "apply_damping",
          "linearize", "compute_chi2", "pcg")


def _stage_of(op_name: str) -> str:
    """The innermost stage scope on a kernel's op_name path."""
    parts = op_name.split("/")
    for part in reversed(parts):
        if part in STAGES:
            return part
    return "other"


def _op_names(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata (the jax.named_scope path),
    from a compiled module's text; a fusion without metadata of its own
    takes that of the first instruction of the computation it calls."""
    names, calls, comp_first = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%([\w.\-]+) .*\{$", line)
        if head:
            comp = head.group(1)
            continue
        inst = re.match(r"^\s*(?:ROOT )?%([\w.\-]+) = ", line)
        if not inst:
            continue
        name = inst.group(1)
        op_name = re.search(r'op_name="([^"]*)"', line)
        callee = re.search(r"calls=%([\w.\-]+)", line)
        if op_name:
            names[name] = op_name.group(1)
            comp_first.setdefault(comp, op_name.group(1))
        if callee:
            calls[name] = callee.group(1)
    for name, callee in calls.items():
        if name not in names and callee in comp_first:
            names[name] = comp_first[callee]
    return names


def profile(run, iters, label, hlo_text=""):
    """Trace ``run()`` and print the device time of its five largest
    operations (summed over the run, per LM iteration), each with the
    stage its named scope says it belongs to (the op_name metadata of the
    kernel's HLO instruction in ``hlo_text``), plus the device busy share.
    Returns {stage: device ms per iteration}."""
    import jax
    from jax.profiler import ProfileData

    op_names = _op_names(hlo_text)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with jax.profiler.trace(tmp):
            run()
        wall = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"),
                            recursive=True)
        data = ProfileData.from_file(path)
        ops = {}
        spans = []
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            # kernels of the one compute stream (the others only copy)
            for line in plane.lines:
                if "Compute" not in line.name:
                    continue
                for ev in line.events:
                    stats = dict(ev.stats)
                    name = str(stats.get("hlo_op", ev.name))
                    op_name = op_names.get(name, "")
                    rec = ops.setdefault(name, [0.0, _stage_of(op_name),
                                                op_name])
                    rec[0] += ev.duration_ns
                    spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise AssertionError("no device operation in the trace")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    log(f"  {label} trace: {len(spans)} device ops, busy "
        f"{busy / 1e6:.2f} ms of a {window / 1e6:.2f} ms device window "
        f"(idle share {1 - busy / window:.3f}), traced wall {wall:.3f} s")
    log(f"  five largest operations (device ms per LM iteration, "
        f"{iters} iterations traced):")
    for name, (ns, stage, op_name) in sorted(ops.items(),
                                              key=lambda kv: -kv[1][0])[:5]:
        log(f"    {ns / 1e6 / iters:10.3f} ms  {stage:<22} {name}  "
            f"[{op_name[-100:]}]")
    per_stage = {}
    for ns, stage, _ in ops.values():
        per_stage[stage] = per_stage.get(stage, 0.0) + ns / 1e6 / iters
    log("  device ms per LM iteration by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(per_stage.items(),
                                           key=lambda kv: -kv[1])))
    return per_stage


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_ladybug(device):
    import graphite_tpu as gt
    from graphite_tpu.schur import SchurOps
    from graphite_tpu.schur_reference import schur_reference
    from graphite_tpu.solvers import PCGSchurSolver
    from graphite_tpu.solvers.dense_cholesky_schur import schur_to_dense

    log("phase ladybug")
    t0 = time.perf_counter()
    problem = bal_problem("ladybug", gt.FP32_FP32)
    log(f"  set-up (data + freeze): {time.perf_counter() - t0:.2f} s, "
        f"dim_h {problem.dim_h}")

    hs, ss, lin, hv, sv = first_linearisation(problem)
    ref = schur_reference(problem, hs, hv, lin.b)
    S_ref = ref.s_matrix().toarray()
    b_s_ref = ref.b_schur()
    dx_p = np.linalg.solve(S_ref, b_s_ref)
    dx_l_ref = ref.landmark_update(dx_p)

    def card(hv, sv, b, dx_p):
        ops = SchurOps(problem, ss, hv, sv)
        dx = ops.compose_delta(dx_p, ops.landmark_update(b, dx_p))
        return schur_to_dense(problem, ss, sv), ops.b_schur(b), dx

    S, b_s, dx = problem.jit_with_consts(card)(
        hv, sv, lin.b, np.asarray(dx_p, np.float32))
    check_terms("S vs block-sparse f64 reference", S, S_ref,
                ref.s_terms().toarray())
    check_terms("b_Schur vs reference", b_s, b_s_ref, ref.b_schur_terms())
    check_terms("landmark update vs reference",
                np.asarray(dx)[ss.dim_p:problem.dim_h], dx_l_ref,
                ref.landmark_update_terms(dx_p))

    solver = PCGSchurSolver(**BA_SOLVER)
    res = run_lm(problem, solver, 50, "LM 50 iterations")
    log(f"  peak_bytes_in_use after phase: {peak_gb(device):.3f} GB")
    profile_lm(problem, solver, 50, "ladybug")
    check_chi2(res, fp64_cpu_lm(lambda p: bal_problem("ladybug", p),
                                solver, 50))


def run_lm_once(problem, solver, iters):
    from graphite_tpu.optimizers import levenberg_marquardt

    return levenberg_marquardt(problem, solver, options=lm_options(iters))


def profile_lm(problem, solver, iters, label):
    """Two traces of the warm jit-loop LM program: as run (XLA's default
    groups kernels into command buffers, which the trace shows as one
    op; this one gives the idle share), and the same program compiled
    with command buffers off, which shows each kernel and its stage."""
    import jax

    run_lm_once(problem, solver, iters)  # the cached program exists
    profile(lambda: run_lm_once(problem, solver, iters), iters,
            f"{label}, as run")
    (wrapper,) = [v for k, v in problem._cache.items()
                  if isinstance(k, tuple) and k[:2] == ("lm", id(solver))]
    args = (problem.consts(), problem.data, problem.params0)
    exe = wrapper._cell["f"].lower(*args).compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    jax.block_until_ready(exe(*args))
    return profile(lambda: jax.block_until_ready(exe(*args)), iters,
                   f"{label}, command buffers off", exe.as_text())


def phase_pose(device):
    import jax

    import graphite_tpu as gt
    from graphite_tpu.linearize import hessian_matvec, linearize
    from graphite_tpu.preconditioners import BlockJacobiPreconditioner
    from graphite_tpu.solvers import PCGSolver

    log("phase pose")
    t0 = time.perf_counter()
    problem = pose_problem(gt.FP32_FP32)
    log(f"  set-up (data + freeze): {time.perf_counter() - t0:.2f} s, "
        f"dim_h {problem.dim_h}")

    lin = problem.jit_with_consts(lambda p: linearize(problem, p))(
        problem.params0)
    x = np.random.default_rng(0).normal(size=problem.dim_x).astype(
        np.float32)
    y = problem.jit_with_consts(
        lambda lin, x: hessian_matvec(problem, lin, x))(lin, x)
    lin_h, y_h = jax.device_get((lin, y))
    err = 0.0
    scale = 0.0
    ref_rows = {}
    for name in problem.vertex_meta:
        n = problem.seg_rows[name]
        d = problem.vertex_meta[name].vtype.dim
        ref_rows[name] = np.zeros((n + 1, d))
    for name, fm in problem.factor_meta.items():
        fa = problem.data.factors[name]
        E = fm.ftype.residual_dim
        v = 0.0
        for s, vt in enumerate(fm.ftype.vertex_types):
            J = np.asarray(lin_h.jacobians[name][s], np.float64).reshape(
                -1, E, vt.dim)
            xr = np.asarray(problem.rows_view_padded(x, vt.name), np.float64)
            v = v + np.einsum("fec,fc->fe", J, xr[np.asarray(fa.rows[s])])
        if fa.precision is not None:
            P = np.asarray(fa.precision, np.float64).reshape(-1, E, E)
            v = np.einsum("fij,fj->fi", P, v)
        v = v * np.asarray(lin_h.chi2_deriv[name], np.float64)[:, None]
        for s, vt in enumerate(fm.ftype.vertex_types):
            J = np.asarray(lin_h.jacobians[name][s], np.float64).reshape(
                -1, E, vt.dim)
            np.add.at(ref_rows[vt.name], np.asarray(fa.rows[s]),
                      np.einsum("fec,fe->fc", J, v))
    for name, rows in ref_rows.items():
        got = np.asarray(problem.rows_view(y_h, name), np.float64)
        err = max(err, float(np.abs(got - rows[:-1]).max()))
        scale = max(scale, float(np.abs(rows[:-1]).max()))
    check("matrix-free H x vs host f64 J^T(P J x)", err / scale, 1e-4,
          "f32 products, atomic-add order")

    solver = PCGSolver(max_iter=50, tol=1e-10, rejection_ratio=1e6,
                       preconditioner=BlockJacobiPreconditioner())
    res = run_lm(problem, solver, 30, "LM 30 iterations")
    log(f"  peak_bytes_in_use after phase: {peak_gb(device):.3f} GB")
    check_chi2(res, fp64_cpu_lm(pose_problem, solver, 30))


def phase_direct(device):
    import scipy.sparse.linalg as spla

    import graphite_tpu as gt
    from graphite_tpu.schur_reference import hessian_csr
    from graphite_tpu.solvers import SparseDirectSolver
    from graphite_tpu.solvers.dense_cholesky_schur import (
        DenseCholeskySchurSolver,
    )
    from graphite_tpu.solvers.sparse_direct_schur import (
        SparseDirectSchurSolver,
    )

    log("phase direct (Ladybug size)")
    problem = bal_problem("ladybug", gt.FP32_FP32)
    hs, ss, lin, hv, sv = first_linearisation(problem)
    t0 = time.perf_counter()
    H = hessian_csr(problem, hs, hv)
    H_norm = float(abs(H).sum(axis=1).max())
    b = np.asarray(lin.b, np.float64)[:problem.dim_h]
    dx_ref = spla.spsolve(H.tocsc(), b)
    log(f"  SciPy f64 spsolve of the damped full H (dim_h {problem.dim_h}):"
        f" {time.perf_counter() - t0:.3f} s")
    solvers = (
        ("dense Schur, device", DenseCholeskySchurSolver()),
        ("sparse Schur, host callback",
         SparseDirectSchurSolver(on_device_dim_p=0)),
        ("full H dense Cholesky, device", SparseDirectSolver(on_device=True)),
        ("full H SciPy splu, host callback",
         SparseDirectSolver(on_device=False)),
    )
    for label, solver in solvers:
        st = problem.jit_with_consts(
            lambda lin, solver=solver: solver.prepare(problem, lin))(lin)
        solve = problem.jit_with_consts(
            lambda lin, st, solver=solver: solver.solve(
                problem, lin, st, LAMBDA0, False))
        t0 = time.perf_counter()
        dx, ok = solve(lin, st)
        dx.block_until_ready()
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            dx, ok = solve(lin, st)
            dx.block_until_ready()
            warm.append(time.perf_counter() - t0)
        log(f"  {label}: cold {cold:.2f} s, warm {min(warm) * 1e3:.2f} ms "
            f"(best of 3: {', '.join(f'{w * 1e3:.2f}' for w in warm)} ms)")
        if not bool(ok):
            raise AssertionError(f"{label}: solver reported failure")
        x = np.asarray(dx, np.float64)[:problem.dim_h]
        log(f"  {label}: dx differs from SciPy's by "
            f"{rel_max(x, dx_ref):.3e} of max|dx|")
        check(f"{label} backward error |H dx - b| / (|H||dx| + |b|)",
              float(np.abs(H @ x - b).max()
                    / (H_norm * np.abs(x).max() + np.abs(b).max())),
              1e-5, "f32 factorization of the damped system")
    log(f"  peak_bytes_in_use after phase: {peak_gb(device):.3f} GB")


def phase_venice(device):
    import jax

    import graphite_tpu as gt
    from graphite_tpu import perf
    from graphite_tpu.schur import SchurOps
    from graphite_tpu.schur_reference import s_bsr, schur_reference
    from graphite_tpu.solvers import PCGSchurSolver

    log("phase venice")
    t0 = time.perf_counter()
    problem = bal_problem("venice-big", gt.FP32_FP32)
    log(f"  set-up (data + freeze): {time.perf_counter() - t0:.2f} s, "
        f"dim_h {problem.dim_h}")

    t0 = time.perf_counter()
    hs, ss, lin, hv, sv = first_linearisation(problem)
    jax.block_until_ready(sv)
    log(f"  first linearisation + Schur (compile + run): "
        f"{time.perf_counter() - t0:.2f} s")
    (key,) = ss.s_keys
    s_card = np.asarray(sv.s_vals[key], np.float64)
    t0 = time.perf_counter()
    ref = schur_reference(problem, hs, hv, lin.b)
    rng = np.random.default_rng(0)
    pick = rng.choice(s_card.shape[0], size=min(1000, s_card.shape[0]),
                      replace=False)
    offs = ss.pose_offsets
    dr, dc = key
    got, want, terms = [], [], []
    for i in pick:
        r, c = int(ss.s_rows[key][i]), int(ss.s_cols[key][i])
        got.append(s_card[i].reshape(dr, dc))
        want.append(ref.s_block(int(offs[r]), dr, int(offs[c]), dc))
        terms.append(ref.s_block_terms(int(offs[r]), dr, int(offs[c]), dc))
    log(f"  host f64 reference for 1000 S blocks: "
        f"{time.perf_counter() - t0:.1f} s")
    check_terms("1000 sampled S blocks vs host f64", got, want, terms)

    x = rng.normal(size=ss.dim_p).astype(np.float32)
    y = problem.jit_with_consts(
        lambda hv, sv, x: SchurOps(problem, ss, hv, sv).s_matvec(x))(
            hv, sv, x)
    y_ref = s_bsr(ss, sv.s_vals) @ x.astype(np.float64)
    check("S matvec vs host BSR product of the card's S",
          rel_max(y, y_ref), 1e-4, "f32 products, atomic-add order")
    del ref, s_card, hv, sv, lin

    solver = PCGSchurSolver(**BA_SOLVER)
    res = run_lm(problem, solver, 3, "LM 3 iterations")
    log(f"  peak_bytes_in_use after phase: {peak_gb(device):.3f} GB")
    if not (np.isfinite(res.chi2) and res.chi2 <= res.initial_chi2):
        raise AssertionError(
            f"chi2 {res.chi2} is not finite or above {res.initial_chi2}")
    log(f"  check chi2 finite and not above initial: {res.chi2:.9g} <= "
        f"{res.initial_chi2:.9g}")
    per_stage = profile_lm(problem, solver, 3, "venice")
    ms = per_stage.get("schur_values")
    gb = perf.bytes_ledger(problem)["schur_values"] / 1e9
    if ms:
        peak = perf.device_peak(device)
        share = (f", {gb / (ms / 1e3) / peak['hbm_gbps']:.3f} of "
                 f"{peak['hbm_gbps']:.0f} GB/s" if peak else "")
        log(f"  schur_values stage: {gb:.3f} GB logical bytes in "
            f"{ms:.3f} ms = {gb / (ms / 1e3):.1f} GB/s{share} (per LM "
            f"iteration; every iteration rebuilds S)")


def phase_cards4(devices):
    """Sharded LM on a 4-card mesh against the same problem on one card."""
    import graphite_tpu as gt
    from graphite_tpu.io import bal as bal_io
    from graphite_tpu.io import synthetic
    from graphite_tpu.parallel import make_mesh, sharded_lm
    from graphite_tpu.solvers import PCGSchurSolver

    n = len(devices)
    log(f"phase cards{n}: Venice-1778 size, 3 LM iterations")
    t0 = time.perf_counter()
    ds = synthetic.make_bal("venice-big", seed=0)
    g, *_ = bal_io.build_graph(ds, precision=gt.FP32_FP32)
    problem = g.freeze()
    sharded = g.freeze(pad_factors_to=n)
    log(f"  set-up (data + two freezes): {time.perf_counter() - t0:.2f} s")
    solver = PCGSchurSolver(**BA_SOLVER)
    res = run_lm(problem, solver, 3, "one card")

    mesh = make_mesh(n)
    opts = lm_options(3)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        _, chi2, iters, accepted, trace = sharded_lm(
            sharded, mesh, solver, opts, with_trace=True)
        chi2 = float(chi2)
        times.append(time.perf_counter() - t0)
    log(f"  {n} cards: cold {times[0]:.2f} s (compile + run), warm "
        f"{times[1]:.4f} s = {1e3 * times[1] / max(int(iters), 1):.3f} ms "
        f"per LM iteration ({int(iters)} iterations, {int(accepted)} "
        f"accepted), chi2 {chi2:.9g}")
    tr = np.asarray(trace)[:int(iters)]
    log(f"  chi2 per iteration, one card: "
        f"{[float(f'{h['chi2']:.9g}') for h in res.history]}; {n} cards: "
        f"{[float(f'{c:.9g}') for c in tr[:, 0]]}")
    if not (np.isfinite(chi2) and chi2 <= res.initial_chi2):
        raise AssertionError(f"{n}-card chi2 {chi2} not finite or above "
                             f"{res.initial_chi2}")
    # the first accepted step: later steps compound rounding differences
    # (final chi2 of one-card runs of this phase ranged 7.7M-9.1M)
    k = next(i for i, h in enumerate(res.history) if h["accepted"])
    if not tr[k, 3]:
        raise AssertionError(f"{n}-card run rejected iteration {k + 1}")
    check(f"{n}-card chi2 after the first accepted step vs one card",
          abs(tr[k, 0] - res.history[k]["chi2"]) / res.history[k]["chi2"],
          1e-2, "one inexact PCG solve of f32 sums taken in another order")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded four-card phase")
    args = ap.parse_args()

    import jax

    from graphite_tpu.runtime import (
        card_info,
        device_record,
        enable_compile_cache,
        require_gpu,
    )

    devices = require_gpu(args.cards)
    log(f"card (name, power limit): {card_info()}")
    log(f"jax {jax.__version__}, devices {devices}")
    log(f"compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    if args.cards == 4:
        phase_cards4(devices)
    else:
        # venice before direct: peak_bytes_in_use is the process's peak,
        # and the direct phase's dense full H (4.2 GB) would mask venice's
        for phase in (phase_ladybug, phase_pose, phase_venice,
                      phase_direct):
            t0 = time.perf_counter()
            phase(devices[0])
            log(f"  phase wall {time.perf_counter() - t0:.1f} s")
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": device_record(devices)}))


if __name__ == "__main__":
    main()
