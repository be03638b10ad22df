"""graphite_tpu: a nonlinear least-squares factor-graph optimizer in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of sfu-rsl/graphite
(a GPU CUDA C++ factor-graph optimization framework for SLAM / bundle
adjustment), running on NVIDIA GPUs through XLA:

- vertices and factors are value-semantics pytrees, not pointer tables;
- Jacobians come from ``jax.jacfwd`` through manifold retractions (or
  user-supplied analytic functions), replacing Dual-number CUDA kernels;
- all scatter-reductions are ``segment_sum``s (which XLA lowers to the
  reference's atomic adds on the GPU);
- the sparse structure (Hessian blocks, Schur products) is discovered once
  per topology on the host and baked into static index arrays so
  relinearization never retraces;
- solvers (matrix-free PCG, explicit-Schur PCG, dense Cholesky, CPU sparse
  direct) and optimizers (LM, LM2, GD, Adam) are functional and fully
  jittable — an entire LM optimization can run as one XLA program.
"""

from .precision import (
    FP32_BF16,
    FP32_FP16,
    FP32_FP32,
    FP64_BF16,
    FP64_FP32,
    FP64_FP64,
    Precision,
)
from .loss import CauchyLoss, DefaultLoss, HuberLoss, Loss
from .vertices import VertexSet, VertexType, vertex_type
from .factors import Differentiation, FactorSet, FactorType, factor_type
from .graph import Graph, GraphData, Problem
from .linearize import (
    Linearization,
    apply_update,
    compute_chi2,
    hessian_matvec,
    linearize,
)
from .covariance import joint_covariance, marginal_covariances

__version__ = "0.1.0"

__all__ = [
    "Precision",
    "FP64_FP64", "FP64_FP32", "FP64_BF16", "FP32_FP32", "FP32_BF16",
    "FP32_FP16",
    "Loss", "DefaultLoss", "HuberLoss", "CauchyLoss",
    "VertexType", "VertexSet", "vertex_type",
    "FactorType", "FactorSet", "factor_type", "Differentiation",
    "Graph", "Problem", "GraphData",
    "Linearization", "linearize", "compute_chi2", "apply_update",
    "hessian_matvec",
    "joint_covariance", "marginal_covariances",
]
