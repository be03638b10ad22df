"""Precision policies.

JAX analog of the reference's two template precisions ``T``/``S``
(reference: include/graphite/graph.hpp:24-29, include/graphite/types.hpp:10-48):

- ``graph_dtype`` (reference ``T``): vertex state, residuals, ``b``, ``delta_x``.
- ``solver_dtype`` (reference ``S``): Jacobian / Hessian-block storage.
- ``inv_dtype`` (reference ``InvP<T,S>``, types.hpp:18-19): precision used for
  small block inversions and diagonal accumulation — never a low-precision
  type; equals ``graph_dtype`` whenever ``solver_dtype`` is low precision.

All contractions accumulate in ``acc_dtype`` via ``preferred_element_type``
(always >= fp32).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

_LOW_PRECISION = (jnp.bfloat16, jnp.float16)


def is_low_precision(dtype: Any) -> bool:
    """Reference parity: ``is_low_precision`` (types.hpp:10-16)."""
    return jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))


# fp16 values must be clamped to the finite range when Jacobians are stored in
# half precision (reference: ops/error.hpp:167-173).
FP16_MAX = 65504.0


def clamp_to_storage(x, dtype):
    """Cast ``x`` to a (possibly low-precision) storage dtype.

    For fp16 the value is clamped to +-65504 first, matching the reference's
    autodiff kernel (ops/error.hpp:167-173). bf16 has fp32-like range and
    needs no clamp.
    """
    if jnp.dtype(dtype) == jnp.dtype(jnp.float16):
        x = jnp.clip(x, -FP16_MAX, FP16_MAX)
    return x.astype(dtype)


@dataclasses.dataclass(frozen=True)
class Precision:
    """A (graph, solver) precision pair.

    Mirrors the reference's supported CLI combos (examples/bal.cu:311-314):
    FP64-FP64, FP64-FP32, FP64-BF16, FP32-FP32, FP32-BF16 — plus FP32-FP16.
    """

    graph_dtype: Any = jnp.float32
    solver_dtype: Any = jnp.float32

    @property
    def inv_dtype(self):
        """Precision for block inversions (``InvP``, types.hpp:18-19)."""
        if is_low_precision(self.solver_dtype):
            return self.graph_dtype
        return self.solver_dtype

    @property
    def matmul_precision(self) -> str:
        """Element-multiplication precision for matrix contractions.

        Always 'highest': on the GPU an f32 matmul may otherwise run in
        TF32 (about three decimal digits), which destroys the Schur
        complement's cancellation (S = Hpp - correction). Inputs that are
        already bf16 (stored Jacobians) multiply exactly either way.
        """
        return "highest"

    @property
    def acc_dtype(self):
        """Accumulation dtype for contractions (>= fp32)."""
        g = jnp.dtype(self.graph_dtype)
        if g == jnp.dtype(jnp.float64):
            return jnp.float64
        return jnp.float32

    def __post_init__(self):
        if is_low_precision(self.graph_dtype):
            raise ValueError("graph_dtype must be fp32 or fp64 (reference T)")

    @staticmethod
    def from_names(graph: str, solver: str) -> "Precision":
        m = {
            "fp64": jnp.float64,
            "fp32": jnp.float32,
            "bf16": jnp.bfloat16,
            "fp16": jnp.float16,
            "float64": jnp.float64,
            "float32": jnp.float32,
            "bfloat16": jnp.bfloat16,
            "float16": jnp.float16,
        }
        for name in (graph, solver):
            if name.lower() not in m:
                raise ValueError(
                    f"unknown precision '{name}'; expected one of "
                    f"{sorted(set(m))}"
                )
        return Precision(m[graph.lower()], m[solver.lower()])


FP64_FP64 = Precision(jnp.float64, jnp.float64)
FP64_FP32 = Precision(jnp.float64, jnp.float32)
FP64_BF16 = Precision(jnp.float64, jnp.bfloat16)
FP32_FP32 = Precision(jnp.float32, jnp.float32)
FP32_BF16 = Precision(jnp.float32, jnp.bfloat16)
FP32_FP16 = Precision(jnp.float32, jnp.float16)
