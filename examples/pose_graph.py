"""Pose-graph optimization (SE2 / SE3) from g2o files or synthetic problems.

Covers the reference framework's SLAM use case: binary relative-pose
factors, block-Jacobi PCG or sparse direct solvers, gauge fixed by fixing
the first pose.

Run:
  python examples/pose_graph.py --synthetic sphere --poses 2500
  python examples/pose_graph.py sphere2500.g2o --solver sparse
"""

import argparse
import time

import numpy as np

import graphite_tpu as gt
from graphite_tpu.runtime import enable_compile_cache
from graphite_tpu.io import g2o, synthetic
from graphite_tpu.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu.preconditioners import BlockJacobiPreconditioner
from graphite_tpu.solvers import PCGSolver


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("file", nargs="?", help="g2o file")
    ap.add_argument("--synthetic", choices=["circle2d", "sphere"],
                    default="sphere")
    ap.add_argument("--poses", type=int, default=500)
    ap.add_argument("--solver", default="pcg", choices=["pcg", "sparse",
                                                        "dense"])
    ap.add_argument("--precision", nargs=2, default=["fp32", "fp32"])
    ap.add_argument("--iterations", type=int, default=30)
    ap.add_argument("--lambda", dest="lmbda", type=float, default=1e-4)
    ap.add_argument("--pcg_max_iterations", type=int, default=50)
    ap.add_argument("--jit-loop", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    enable_compile_cache()

    precision = gt.Precision.from_names(*args.precision)
    if precision.graph_dtype == np.float64:
        import jax

        jax.config.update("jax_enable_x64", True)

    if args.file:
        ds = g2o.load(args.file)
    elif args.synthetic == "circle2d":
        ds = synthetic.make_pose_graph_2d(args.poses, seed=args.seed)
    else:
        ds = synthetic.make_sphere_se3(args.poses, seed=args.seed)
    print(f"Pose graph ({ds.kind}): {ds.num_vertices} poses, "
          f"{ds.num_edges} edges")

    g, *_ = g2o.build_graph(ds, precision=precision)
    problem = g.freeze()
    if args.solver == "pcg":
        solver = PCGSolver(max_iter=args.pcg_max_iterations, tol=1e-10,
                           rejection_ratio=1e6,
                           preconditioner=BlockJacobiPreconditioner())
    elif args.solver == "sparse":
        from graphite_tpu.solvers import SparseDirectSolver

        solver = SparseDirectSolver()
    else:
        from graphite_tpu.solvers import DenseCholeskySolver

        solver = DenseCholeskySolver()

    opts = LevenbergMarquardtOptions(iterations=args.iterations,
                                     initial_damping=args.lmbda,
                                     verbose=True, jit_loop=args.jit_loop)
    t0 = time.perf_counter()
    res = levenberg_marquardt(problem, solver, options=opts)
    dt = time.perf_counter() - t0
    print(f"Optimization took {dt:.3f}s "
          f"({res.iterations / max(dt, 1e-9):.2f} iters/sec)")
    print(f"chi2: {res.initial_chi2:.6g} -> {res.chi2:.6g}")
    return res


if __name__ == "__main__":
    main()
