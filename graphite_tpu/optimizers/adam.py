"""Adam on the factor graph.

JAX analog of ``optimizer::adam`` (reference: optimizer/adam.hpp:104-135
and the fused step kernel ops/vector.hpp:89-121): gradient ``g = -b``,
bias-corrected first/second moments, ``step = -lr * m_hat / (sqrt(v_hat)+eps)``
applied through the graph update; relinearizes every iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..linearize import apply_update, linearize


@dataclasses.dataclass
class AdamOptions:
    iterations: int = 10
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    verbose: bool = False


def adam(problem, params=None, options: Optional[AdamOptions] = None):
    options = options or AdamOptions()
    params = params if params is not None else problem.params0
    gdt = problem.precision.graph_dtype
    lr, b1, b2, eps = (options.learning_rate, options.beta1, options.beta2,
                       options.epsilon)

    key = ("adam", lr, b1, b2, eps, options.iterations)
    if key not in problem._cache:
        def run(p):
            # step defined per trace: loop bodies reused across traces would
            # bake problem.data as jaxpr constants (see lm.py run_all)
            def step(carry, t):
                pp, m, v = carry
                lin = linearize(problem, pp)
                g = -lin.b
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                t1 = (t + 1).astype(gdt)
                m_hat = m / (1 - b1**t1)
                v_hat = v / (1 - b2**t1)
                delta = -lr * m_hat / (jnp.sqrt(v_hat) + eps)
                new_p = apply_update(problem, pp, lin, delta)
                return (new_p, m, v), lin.chi2

            zeros = jnp.zeros(problem.dim_x, dtype=gdt)
            (pf, _, _), hist = jax.lax.scan(
                step, (p, zeros, zeros),
                jnp.arange(options.iterations),
            )
            return pf, hist

        problem._cache[key] = problem.jit_with_consts(run)

    pf, hist = problem._cache[key](params)
    if options.verbose:
        for i, c in enumerate(hist):
            print(f"adam iter {i:>6d} chi2 {float(c):.10g}")
    return pf, hist
