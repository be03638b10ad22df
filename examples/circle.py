"""Circle-fit example: fit noisy 2D points to a circle of known radius.

Port of the reference example (reference: examples/circle.cu:75-179):
5 points, unary 1-residual circle factors with manual Jacobians, one fixed
vertex, one deactivated factor, identity-preconditioned PCG, LM 100
iterations. Points 2 (deactivated factor) and 4 (fixed) must remain
unchanged.

Run:  python examples/circle.py [--auto-diff] [--precision fp32 fp32]
"""

import argparse
import time

import numpy as np

import jax.numpy as jnp

import graphite_tpu as gt
from graphite_tpu.runtime import enable_compile_cache
from graphite_tpu.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu.preconditioners import IdentityPreconditioner
from graphite_tpu.solvers import PCGSolver


POINT2 = gt.vertex_type("point2", 2)


def circle_error(p, radius):
    x, y = p[0], p[1]
    return jnp.array([x * x + y * y - radius * radius])


def circle_jacobian(p, radius):
    return (jnp.array([[2.0 * p[0], 2.0 * p[1]]]),)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--auto-diff", action="store_true",
                    help="use jacfwd instead of the analytic Jacobian")
    ap.add_argument("--precision", nargs=2, default=["fp32", "fp32"],
                    metavar=("GRAPH", "SOLVER"))
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    enable_compile_cache()

    precision = gt.Precision.from_names(*args.precision)
    rng = np.random.default_rng(args.seed)
    num_vertices = 5
    radius, sigma = 4.0, 0.3
    angles = rng.uniform(0.0, 2 * np.pi, num_vertices)
    pts = np.stack(
        [radius * np.cos(angles) + rng.normal(0, sigma, num_vertices),
         radius * np.sin(angles) + rng.normal(0, sigma, num_vertices)],
        axis=1,
    )

    circle_factor = gt.factor_type(
        "circle", 1, [POINT2], circle_error,
        jacobian_fn=None if args.auto_diff else circle_jacobian,
        obs_shape=(),
    )

    g = gt.Graph(precision=precision)
    vs = g.add_vertex_set(POINT2)
    id_offset = 10  # user provides arbitrary ids (circle.cu:107)
    for i, p in enumerate(pts):
        print(f"Adding point {i}=({p[0]:.4f}, {p[1]:.4f}) "
              f"with radius={np.hypot(*p):.4f}")
        vs.add(i + id_offset, p)

    fs = g.add_factor_set(circle_factor)
    handles = [fs.add([i + id_offset], obs=radius) for i in range(num_vertices)]

    # Fix the last vertex; disable the third constraint (circle.cu:133-136).
    vs.set_fixed(num_vertices - 1 + id_offset, True)
    fs.set_active(handles[2], 0x1)

    problem = g.freeze(opt_level=0)
    solver = PCGSolver(max_iter=50, tol=1e-20, rejection_ratio=10.0,
                       preconditioner=IdentityPreconditioner())
    options = LevenbergMarquardtOptions(
        iterations=args.iterations, initial_damping=1e-6, verbose=True
    )

    print(f"Graph built with {num_vertices} vertices and {fs.count} factors.")
    print("Optimizing!")
    t0 = time.perf_counter()
    result = levenberg_marquardt(problem, solver, options=options)
    print(f"Optimization took {time.perf_counter() - t0:.4f} seconds.")

    final = np.asarray(result.params["point2"])
    for i, p in enumerate(final):
        print(f"Optimized point {i}=({p[0]:.6f}, {p[1]:.6f}) "
              f"with radius={np.hypot(*p):.6f}")
    print("points 2 and 4 should remain unchanged.")
    return result


if __name__ == "__main__":
    main()
