"""Custom-factor tutorial example: 2D range-bearing SLAM.

Shows everything a user defines for a new problem class (the reference's
docs/markdown/main.md tutorial):

- a manifold vertex type (SE2 robot pose with a custom retract);
- a Euclidean vertex type (2D landmark);
- custom factors: SE2 odometry (between), range-bearing landmark
  observations, and a prior for gauge;
- Schur elimination of the landmarks + PCG on the pose system.

Run: python examples/range_bearing_slam.py [--poses 100 --landmarks 40]
"""

import argparse
import time

import numpy as np

import jax.numpy as jnp

import graphite_tpu as gt
from graphite_tpu.runtime import enable_compile_cache
from graphite_tpu.models import lie, pose_graph as pg
from graphite_tpu.optimizers import (
    LevenbergMarquardtOptions,
    levenberg_marquardt,
)
from graphite_tpu.solvers import PCGSchurSolver

LANDMARK = gt.vertex_type("rb_landmark", 2)


def range_bearing_residual(pose, lm, obs):
    """obs = (range, bearing) of the landmark in the robot frame."""
    c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
    d = lm - pose[:2]
    local = jnp.stack([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
    rng = jnp.sqrt(jnp.dot(local, local) + 1e-12)
    bearing = jnp.arctan2(local[1], local[0])
    return jnp.stack([rng - obs[0], lie.angle_wrap(bearing - obs[1])])


RANGE_BEARING = gt.factor_type(
    "range_bearing", 2, [pg.SE2, LANDMARK], range_bearing_residual,
    obs_shape=(2,),
)


def simulate(n_poses, n_lms, seed=0):
    rng = np.random.default_rng(seed)
    R = 8.0
    angles = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
    poses_true = np.stack(
        [R * np.cos(angles), R * np.sin(angles), angles + np.pi / 2], axis=1
    )
    lms_true = rng.uniform(-10, 10, (n_lms, 2))

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi])

    odo = [rel(poses_true[i], poses_true[i + 1])
           + rng.normal(0, [0.05, 0.05, 0.01])
           for i in range(n_poses - 1)]

    obs = []
    for i, p in enumerate(poses_true):
        d = lms_true - p[:2]
        dist = np.linalg.norm(d, axis=1)
        visible = np.nonzero(dist < 6.0)[0]
        for j in visible:
            bearing = np.arctan2(d[j, 1], d[j, 0]) - p[2]
            bearing = (bearing + np.pi) % (2 * np.pi) - np.pi
            obs.append((i, j, dist[j] + rng.normal(0, 0.05),
                        bearing + rng.normal(0, 0.01)))

    # initial estimates: integrate noisy odometry; landmarks from first
    # sighting
    poses0 = np.zeros_like(poses_true)
    poses0[0] = poses_true[0]
    for i, m in enumerate(odo):
        c, s = np.cos(poses0[i, 2]), np.sin(poses0[i, 2])
        poses0[i + 1] = [poses0[i, 0] + c * m[0] - s * m[1],
                         poses0[i, 1] + s * m[0] + c * m[1],
                         poses0[i, 2] + m[2]]
    lms0 = np.zeros_like(lms_true)
    seen = np.zeros(n_lms, dtype=bool)
    for (i, j, r, b) in obs:
        if not seen[j]:
            th = poses0[i, 2] + b
            lms0[j] = poses0[i, :2] + r * np.array([np.cos(th), np.sin(th)])
            seen[j] = True
    return poses_true, lms_true, poses0, lms0, odo, obs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=100)
    ap.add_argument("--landmarks", type=int, default=40)
    ap.add_argument("--iterations", type=int, default=25)
    args = ap.parse_args()
    enable_compile_cache()

    poses_true, lms_true, poses0, lms0, odo, obs = simulate(
        args.poses, args.landmarks
    )
    print(f"{args.poses} poses, {args.landmarks} landmarks, "
          f"{len(obs)} range-bearing observations, {len(odo)} odometry edges")

    g = gt.Graph(precision=gt.FP32_FP32)
    pose_set = g.add_vertex_set(pg.SE2)
    lm_set = g.add_vertex_set(LANDMARK)
    for i in range(args.poses):
        pose_set.add(i, poses0[i])
    for j in range(args.landmarks):
        lm_set.add(10000 + j, lms0[j])
    lm_set.set_eliminate(True)
    pose_set.set_fixed(0, True)  # gauge

    odo_set = g.add_factor_set(pg.SE2_BETWEEN)
    info = np.diag([1 / 0.05**2, 1 / 0.05**2, 1 / 0.01**2])
    for i, m in enumerate(odo):
        odo_set.add([i, i + 1], obs=m, precision=info)

    rb_set = g.add_factor_set(RANGE_BEARING)
    rb_info = np.diag([1 / 0.05**2, 1 / 0.01**2])
    for (i, j, r, b) in obs:
        rb_set.add([i, 10000 + j], obs=[r, b], precision=rb_info)

    problem = g.freeze()
    solver = PCGSchurSolver(max_iter=30, tol=1e-8, rejection_ratio=1e6)
    t0 = time.perf_counter()
    res = levenberg_marquardt(
        problem, solver,
        options=LevenbergMarquardtOptions(iterations=args.iterations,
                                          initial_damping=1e-4, verbose=True),
    )
    print(f"optimized in {time.perf_counter() - t0:.2f}s; "
          f"chi2 {res.initial_chi2:.4g} -> {res.chi2:.4g}")

    est_poses = np.asarray(res.params["se2_pose"])
    est_lms = np.asarray(res.params["rb_landmark"])
    print(f"pose position RMSE: "
          f"{np.sqrt(((est_poses[:, :2] - poses_true[:, :2])**2).mean()):.4f} "
          f"(odometry-only: "
          f"{np.sqrt(((poses0[:, :2] - poses_true[:, :2])**2).mean()):.4f})")
    print(f"landmark RMSE: "
          f"{np.sqrt(((est_lms - lms_true)**2).mean()):.4f}")
    return res


if __name__ == "__main__":
    main()
