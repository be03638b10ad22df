"""Shared preconditioned-CG iteration.

The functional core of both ``PCGSolver`` (implicit J^T dL P J products,
reference pcg.hpp:61-232) and ``PCGSchurSolver`` (explicit Schur block
matvec, reference pcg_schur.hpp:79-168). Reference semantics preserved —
residual normalization before each preconditioner application, divergence
rejection with x restore, running-minimum rz_0 tracking (see pcg.py for the
line-by-line citations).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def run_pcg(b: jax.Array, matvec: Callable, precond: Callable,
            max_iter: int, tol: float, rejection_ratio: float) -> jax.Array:
    """Solve ``A x = b`` with PCG; returns x.

    ``precond`` receives the *normalized* residual (pcg.hpp:109-121).
    """

    def precondition(r):
        rnorm = jnp.sqrt(jnp.dot(r, r))
        y = r / jnp.where(rnorm == 0, 1.0, rnorm)
        return precond(y)

    gdt = b.dtype
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precondition(r0)
    p0 = z0
    rz0 = jnp.dot(r0, z0)
    inf = jnp.asarray(jnp.inf, dtype=gdt)

    def cond(c):
        k, x, r, p, z, rz, rz_min, done = c
        return (k < max_iter) & (~done) & (rz != 0)

    def body(c):
        k, x, r, p, z, rz, rz_min, done = c
        v2 = matvec(p)
        alpha = rz / jnp.dot(p, v2)
        x_new = x + alpha * p
        r_new = r - alpha * v2
        z_new = precondition(r_new)
        rz_new = jnp.dot(r_new, z_new)

        reject = (jnp.abs(rz_new) > rejection_ratio * rz_min) | jnp.isnan(rz_new)
        x_out = jnp.where(reject, x, x_new)
        rz_min_new = jnp.minimum(rz_min, jnp.abs(rz_new))
        beta = rz_new / rz
        p_new = z_new + beta * p
        converged = jnp.abs(rz_new) < tol
        return (
            k + 1,
            x_out,
            jnp.where(reject, r, r_new),
            jnp.where(reject, p, p_new),
            jnp.where(reject, z, z_new),
            jnp.where(reject, rz, rz_new),
            rz_min_new,
            reject | converged,
        )

    init = (jnp.asarray(0), x0, r0, p0, z0, rz0, inf, jnp.asarray(False))
    with jax.named_scope("pcg"):
        _, x, *_ = jax.lax.while_loop(cond, body, init)
    return x
