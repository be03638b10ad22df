"""Gradient descent on the factor graph.

JAX analog of ``optimizer::gradient_descent``
(reference: optimizer/gradient_descent.hpp:94-123): each iteration
relinearizes and steps ``delta_x = alpha * b`` (``b = -grad(1/2 chi2)`` of the
scaled system); no line search, no accept/reject.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from ..linearize import apply_update, linearize


@dataclasses.dataclass
class GradientDescentOptions:
    iterations: int = 10
    learning_rate: float = 1e-3
    verbose: bool = False
    jit_loop: bool = True


def gradient_descent(problem, params=None,
                     options: Optional[GradientDescentOptions] = None):
    options = options or GradientDescentOptions()
    params = params if params is not None else problem.params0
    lr = options.learning_rate

    key = ("gd", lr, options.iterations)
    if key not in problem._cache:
        def run(p):
            # step defined per trace: loop bodies reused across traces would
            # bake problem.data as jaxpr constants (see lm.py run_all)
            def step(carry, _):
                pp, _ = carry
                lin = linearize(problem, pp)
                new_p = apply_update(problem, pp, lin, lr * lin.b)
                return (new_p, lin.chi2), lin.chi2

            (pf, chi2), hist = jax.lax.scan(
                step, (p, jnp.asarray(0.0, problem.precision.graph_dtype)),
                length=options.iterations,
            )
            return pf, chi2, hist

        problem._cache[key] = problem.jit_with_consts(run)

    pf, chi2, hist = problem._cache[key](params)
    if options.verbose:
        for i, c in enumerate(hist):
            print(f"gd iter {i:>6d} chi2 {float(c):.10g}")
    return pf, hist
