"""Bundle adjustment on BAL datasets (or synthetic BAL-style problems).

Port of the reference BAL CLI (reference: examples/bal.cu:42-353):
6 solver choices x precision combos, LM with configurable damping,
reports final chi2 / MSE / half-MSE (bal.cu:271-273).

Run:
  python examples/bal.py <problem.txt> --solver pcg-schur
  python examples/bal.py --synthetic ladybug --solver pcg-schur \
      --precision fp32 fp32 --iterations 50
"""

import argparse
import time

import numpy as np

import graphite_tpu as gt
from graphite_tpu.runtime import enable_compile_cache
from graphite_tpu.io import bal as bal_io
from graphite_tpu.io import synthetic
from graphite_tpu.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
    levenberg_marquardt2,
)
from graphite_tpu.preconditioners import (
    BlockJacobiPreconditioner,
    IdentityPreconditioner,
)
from graphite_tpu.solvers import DenseCholeskySolver, PCGSolver


def make_solver(args):
    if args.solver == "pcg":
        pre = (IdentityPreconditioner() if args.pcg_preconditioner == "identity"
               else BlockJacobiPreconditioner())
        return PCGSolver(max_iter=args.pcg_max_iterations, tol=args.pcg_tolerance,
                         rejection_ratio=args.pcg_rejection_ratio,
                         preconditioner=pre)
    if args.solver == "pcg-schur":
        from graphite_tpu.solvers import PCGSchurSolver

        return PCGSchurSolver(max_iter=args.pcg_max_iterations,
                              tol=args.pcg_tolerance,
                              rejection_ratio=args.pcg_rejection_ratio)
    if args.solver == "dense":
        return DenseCholeskySolver()
    if args.solver == "dense-schur":
        from graphite_tpu.solvers import DenseCholeskySchurSolver

        return DenseCholeskySchurSolver()
    if args.solver == "sparse":
        from graphite_tpu.solvers import SparseDirectSolver

        return SparseDirectSolver()
    if args.solver == "sparse-schur":
        from graphite_tpu.solvers import SparseDirectSchurSolver

        return SparseDirectSchurSolver()
    raise ValueError(f"unknown solver {args.solver}")


def main():
    ap = argparse.ArgumentParser(description="BAL bundle adjustment")
    ap.add_argument("file", nargs="?", help="BAL problem file")
    ap.add_argument("--synthetic", help="synthetic problem name "
                    f"({', '.join(synthetic.BAL_SIZES)}) or C,P,O counts")
    ap.add_argument("--solver", default="pcg-schur",
                    choices=["pcg", "pcg-schur", "dense", "dense-schur",
                             "sparse", "sparse-schur"])
    ap.add_argument("--precision", nargs=2, default=["fp32", "fp32"],
                    metavar=("GRAPH", "SOLVER"))
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--lambda", dest="lmbda", type=float, default=1e-4)
    ap.add_argument("--pcg_max_iterations", type=int, default=10)
    ap.add_argument("--pcg_tolerance", type=float, default=1.0)
    ap.add_argument("--pcg_rejection_ratio", type=float, default=5.0)
    ap.add_argument("--pcg_preconditioner", default="block-jacobi",
                    choices=["identity", "block-jacobi"])
    ap.add_argument("--identity_damping", action="store_true")
    ap.add_argument("--no-eliminate", action="store_true",
                    help="do not Schur-eliminate points")
    ap.add_argument("--lm2", action="store_true",
                    help="ORB-SLAM-style early-stopping LM variant")
    ap.add_argument("--jit-loop", action="store_true",
                    help="run the whole LM loop as one XLA program")
    ap.add_argument("--huber", type=float, default=None,
                    help="Huber loss delta")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    enable_compile_cache()

    precision = gt.Precision.from_names(*args.precision)
    if precision.graph_dtype == np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)

    t0 = time.perf_counter()
    if args.file:
        ds = bal_io.load(args.file)
    else:
        name = args.synthetic or "mini"
        if "," in name:
            name = tuple(int(x) for x in name.split(","))
        ds = synthetic.make_bal(name, seed=args.seed)
    print(f"Loaded problem: {ds.num_cameras} cameras, {ds.num_points} points, "
          f"{ds.num_observations} observations "
          f"({time.perf_counter() - t0:.2f}s)")

    t0 = time.perf_counter()
    loss = gt.HuberLoss() if args.huber is not None else None
    eliminate = not args.no_eliminate and "schur" in args.solver
    g, cams, pts, fs = bal_io.build_graph(
        ds, precision=precision, eliminate_points=eliminate,
        loss=loss, loss_param=args.huber,
    )
    print(f"Graph built ({time.perf_counter() - t0:.2f}s)")

    t0 = time.perf_counter()
    problem = g.freeze()
    print(f"Structure frozen: dim_h={problem.dim_h} "
          f"({time.perf_counter() - t0:.2f}s)")

    solver = make_solver(args)
    options = LevenbergMarquardtOptions(
        iterations=args.iterations, initial_damping=args.lmbda,
        verbose=True, use_identity=args.identity_damping,
        jit_loop=args.jit_loop,
    )
    opt = levenberg_marquardt2 if args.lm2 else levenberg_marquardt
    t0 = time.perf_counter()
    result = opt(problem, solver, options=options)
    dt = time.perf_counter() - t0
    n_obs = ds.num_observations
    print(f"Optimization took {dt:.4f} seconds "
          f"({result.iterations / max(dt, 1e-9):.3f} iters/sec)")
    print(f"Final chi2: {result.chi2:.10g}")
    print(f"MSE: {result.chi2 / n_obs:.10g}")
    print(f"Half MSE: {0.5 * result.chi2 / n_obs:.10g}")
    return result


if __name__ == "__main__":
    main()
