"""Robust loss kernels.

JAX analog of the reference's ``Loss<T,E>`` virtual hierarchy
(reference: include/graphite/loss.hpp:6-51). Instead of per-factor virtual
objects stored in unified memory, a loss here is a *static* type per factor
block plus an optional per-factor parameter array — so the whole batch
evaluates as one vectorized ``where``.

Semantics (loss.hpp): the loss is applied to the squared error
``x = r^T P r`` of each factor; its derivative ``dL = loss'(x)`` re-weights
every downstream H / b / J^T v contribution of that factor
(ops/chi2.hpp:32-44, ops/linearize.hpp:283, ops/product.hpp:283).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Loss:
    """Base loss: identity (reference ``DefaultLoss``, loss.hpp:15-25)."""

    name: str = "default"

    def value(self, x, params):
        return x

    def derivative(self, x, params):
        return jnp.ones_like(x)

    def default_param(self) -> float:
        return 0.0


@dataclasses.dataclass(frozen=True)
class DefaultLoss(Loss):
    name: str = "default"


@dataclasses.dataclass(frozen=True)
class HuberLoss(Loss):
    """Huber on the squared error (reference loss.hpp:27-51).

    ``loss(x)  = x                        if x <= delta^2
                 2*delta*sqrt(x)-delta^2  otherwise``
    ``loss'(x) = 1                        if x <= delta^2
                 delta/sqrt(x)            otherwise``

    ``params`` is the per-factor ``delta`` (reference default 100.0).
    """

    name: str = "huber"

    def value(self, x, params):
        d = params
        d2 = d * d
        # Guard sqrt at x==0 / delta==0 (only reachable on unused branches).
        safe = jnp.sqrt(jnp.maximum(x, jnp.maximum(d2, 1e-30)))
        return jnp.where(x <= d2, x, 2.0 * safe * d - d2)

    def derivative(self, x, params):
        d = params
        d2 = d * d
        safe = jnp.sqrt(jnp.maximum(x, jnp.maximum(d2, 1e-30)))
        return jnp.where(x <= d2, jnp.ones_like(x), d / safe)

    def default_param(self) -> float:
        return 100.0


@dataclasses.dataclass(frozen=True)
class CauchyLoss(Loss):
    """Cauchy robust loss, ``loss(x) = c^2 * log(1 + x / c^2)``.

    Not in the reference; provided as a natural extension with the same
    squared-error convention.
    """

    name: str = "cauchy"

    def value(self, x, params):
        c2 = params * params
        return c2 * jnp.log1p(x / c2)

    def derivative(self, x, params):
        c2 = params * params
        return 1.0 / (1.0 + x / c2)

    def default_param(self) -> float:
        return 1.0


DEFAULT_LOSS = DefaultLoss()
