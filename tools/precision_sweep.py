"""On-card precision sweep + direct-Schur timing.

Runs the bench workload (synthetic Ladybug-49, LM + PCG-Schur, jit_loop)
on the GPU for each Jacobian-storage precision policy and reports measured
iters/sec and final cost against FP32_FP32 — the on-hardware version of
the reference's T x S precision matrix (examples/bal.cu:311-314).

Also times the direct-Schur solver both ways — on-device blocked Cholesky
vs host-callback SciPy (cudss_schur.hpp:190-233 vs eigen.hpp:41-44
analogs).

    PYTHONPATH=. python tools/precision_sweep.py [size] [iterations]

Exits non-zero without a GPU.
"""

import sys
import time


def log(*a):
    print(*a, flush=True)


def main():
    from graphite_tpu.runtime import (
        card_info,
        enable_compile_cache,
        require_gpu,
    )

    devices = require_gpu()
    enable_compile_cache()

    import graphite_tpu as gt
    from graphite_tpu.io import bal as bal_io
    from graphite_tpu.io import synthetic
    from graphite_tpu.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )
    from graphite_tpu.solvers import PCGSchurSolver
    from graphite_tpu.solvers.sparse_direct_schur import (
        SparseDirectSchurSolver,
    )

    size = sys.argv[1] if len(sys.argv) > 1 else "ladybug"
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    log(f"devices: {devices}  card (name, power limit): {card_info()}  "
        f"size={size}  iterations={iters}")
    ds = synthetic.make_bal(size, seed=0)

    def run(precision, solver):
        g, *_ = bal_io.build_graph(ds, precision=precision)
        problem = g.freeze()
        opts = LevenbergMarquardtOptions(iterations=iters,
                                         initial_damping=1e-4, jit_loop=True)
        t0 = time.perf_counter()
        res = levenberg_marquardt(problem, solver, options=opts)
        compile_s = time.perf_counter() - t0
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            res = levenberg_marquardt(problem, solver, options=opts)
            best = min(best, time.perf_counter() - t0)
        return res, res.iterations / best, compile_s

    log("\n== precision sweep (LM + PCG-Schur) ==")
    log(f"{'policy':<12} {'iters/s':>8} {'final chi2':>14} "
        f"{'MSE px^2':>9} {'compile s':>9}")
    base_chi2 = None
    for name, prec in (("FP32_FP32", gt.FP32_FP32),
                       ("FP32_BF16", gt.FP32_BF16),
                       ("FP32_FP16", gt.FP32_FP16)):
        res, ips, compile_s = run(
            prec, PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0))
        if base_chi2 is None:
            base_chi2 = res.chi2
        log(f"{name:<12} {ips:8.1f} {res.chi2:14.6g} "
            f"{res.chi2 / ds.num_observations:9.3f} {compile_s:9.1f}"
            + (f"   (chi2 vs fp32: {res.chi2 / base_chi2:.4f}x)"
               if base_chi2 else ""))

    log("\n== direct-Schur: on-device blocked Cholesky vs host callback ==")
    for name, solver in (
        ("on-device", SparseDirectSchurSolver()),
        ("host-callback", SparseDirectSchurSolver(on_device_dim_p=0)),
    ):
        try:
            res, ips, compile_s = run(gt.FP32_FP32, solver)
            log(f"{name:<14} {ips:8.2f} iters/s  chi2 {res.chi2:.6g}  "
                f"compile {compile_s:.1f}s")
        except Exception as e:  # noqa: BLE001 - report-all CLI
            log(f"{name:<14} FAILED: {type(e).__name__}: {e}")


if __name__ == "__main__":
    main()
