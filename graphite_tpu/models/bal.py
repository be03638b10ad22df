"""BAL (Bundle Adjustment in the Large) camera model.

JAX analog of the reference's BAL example traits
(reference: examples/bal.cuh:11-89, examples/reprojection_error.cuh:61-126):

- camera vertex: 9 parameters [angle-axis rvec(3), translation t(3), focal f,
  distortion k1, k2] with full-state backup (bal.cuh:31-53);
- point vertex: 3 parameters, additive;
- reprojection factor (E=2): Rodrigues rotation, perspective division with
  the BAL -P/P.z convention, radial distortion, minus the observed pixel
  (https://grail.cs.washington.edu/projects/bal/ model).

Jacobians: analytic 2x9/2x3 blocks (``reprojection_jacobian``) — the
closed-form chain-rule derivative matching the reference's
wrenfold-generated kernels (examples/projection_jacobians.cuh,
examples/reprojection_error.py). ``jax.jacfwd`` of the residual remains
the oracle (``REPROJECTION_AUTO``; tests/test_bal_jacobian.py) and the
``GRAPHITE_TPU_BAL_AUTODIFF=1`` kill switch restores it as the default:
the analytic form computes the shared projection chain once instead of
pushing 12 forward tangents through it (~2.5x fewer FLOPs per factor).
"""

from __future__ import annotations

import os

import jax.numpy as jnp

from ..factors import factor_type
from ..vertices import vertex_type

CAMERA = vertex_type("bal_camera", 9)
POINT = vertex_type("bal_point", 3)


def rodrigues_rotate(rvec, X):
    """R(rvec) @ X via the Rodrigues formula, safe to differentiate at
    theta -> 0 (the reference's Taylor branch, reprojection_error.cuh:17-35).
    """
    theta2 = jnp.dot(rvec, rvec)
    # Guard the sqrt so jacfwd at theta == 0 stays finite; the small-angle
    # branch is selected by the where below.
    theta2_safe = jnp.where(theta2 < 1e-24, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    axis = rvec / theta
    cth = jnp.cos(theta)
    sth = jnp.sin(theta)
    axx = jnp.cross(axis, X)
    adx = jnp.dot(axis, X)
    rotated = X * cth + axx * sth + axis * adx * (1.0 - cth)
    small = X + jnp.cross(rvec, X)  # first-order expansion
    return jnp.where(theta2 < 1e-24, small, rotated)


def project(camera, X):
    """BAL projection: pixel = f * distortion * (-P.xy / P.z)."""
    rvec = camera[:3]
    t = camera[3:6]
    f, k1, k2 = camera[6], camera[7], camera[8]
    P = rodrigues_rotate(rvec, X) + t
    p = -P[:2] / P[2]
    r2 = jnp.dot(p, p)
    distortion = 1.0 + k1 * r2 + k2 * r2 * r2
    return f * distortion * p


def reprojection_residual(camera, point, obs):
    return project(camera, point) - obs


def _cross_mat(v):
    """[v]x such that [v]x @ y == cross(v, y)."""
    z = jnp.zeros((), dtype=v.dtype)
    return jnp.array([
        [z, -v[2], v[1]],
        [v[2], z, -v[0]],
        [-v[1], v[0], z],
    ])


def reprojection_jacobian(camera, point, obs):
    """Analytic (2, 9) / (2, 3) reprojection Jacobian blocks.

    Chain rule through v = R(w) X, P = v + t, p = -P.xy / P.z,
    res = f * (1 + k1 r2 + k2 r2^2) * p — the closed form of the
    reference's generated kernels (examples/projection_jacobians.cuh).

    The Rodrigues derivative uses the sinc-form coefficients
    c = cos(th), a = sinc(th), b = (1-c)/th^2 with

        dv/dw = -a [X]x + b ((w.X) I + w X^T)
                + ((c - a)/th^2 (w x X) - a X + (a - 2b)/th^2 (w.X) w) w^T

    whose cancelling ratios switch to Taylor series below th < 0.1
    (truncation ~th^6: below f32 eps at the cutoff; the closed form above
    it has >= 3e-3 magnitude against ~1e-7 rounding). Consistent at w = 0
    with the residual's first-order branch (dv/dw -> -[X]x = d(X + w x X)).
    """
    w = camera[:3]
    t = camera[3:6]
    f, k1, k2 = camera[6], camera[7], camera[8]
    X = point

    th2 = jnp.dot(w, w)
    small = th2 < 0.01  # th < 0.1
    # guard the exact-form denominators/sqrt so the unselected branch is
    # finite; every small-branch coefficient (including cos) is a Taylor
    # series in th2, so th never enters it
    th2_g = jnp.where(small, 1.0, th2)
    th = jnp.sqrt(th2_g)
    c = jnp.where(small,
                  1.0 - th2 / 2.0 + th2 * th2 / 24.0
                  - th2 * th2 * th2 / 720.0,
                  jnp.cos(th))
    alpha = jnp.where(small,
                      1.0 - th2 / 6.0 + th2 * th2 / 120.0,
                      jnp.sin(th) / th)
    beta = jnp.where(small,
                     0.5 - th2 / 24.0 + th2 * th2 / 720.0,
                     (1.0 - c) / th2_g)
    gamma = jnp.where(small,
                      -1.0 / 3.0 + th2 / 30.0 - th2 * th2 / 840.0,
                      (c - alpha) / th2_g)
    delta = jnp.where(small,
                      -1.0 / 12.0 + th2 / 180.0 - th2 * th2 / 6720.0,
                      (alpha - 2.0 * beta) / th2_g)

    # --- everything below is SCALAR elementwise math: under the batched
    # vmap, tiny per-factor matrix products ((2,3)@(3,3) dot_generals,
    # eye/outer constructions) would lower to batched matmuls of tiny
    # blocks; expanded entries stay elementwise and fuse.
    w0, w1, w2 = w[0], w[1], w[2]
    X0, X1, X2 = X[0], X[1], X[2]
    wxX0 = w1 * X2 - w2 * X1
    wxX1 = w2 * X0 - w0 * X2
    wxX2 = w0 * X1 - w1 * X0
    wdX = w0 * X0 + w1 * X1 + w2 * X2

    tiny = th2 < 1e-24
    v0 = c * X0 + alpha * wxX0 + beta * wdX * w0
    v1 = c * X1 + alpha * wxX1 + beta * wdX * w1
    v2 = c * X2 + alpha * wxX2 + beta * wdX * w2
    # exact consistency with the residual's th -> 0 guard
    v0 = jnp.where(tiny, X0 + wxX0, v0)
    v1 = jnp.where(tiny, X1 + wxX1, v1)
    v2 = jnp.where(tiny, X2 + wxX2, v2)

    P0, P1, P2 = v0 + t[0], v1 + t[1], v2 + t[2]
    iz = 1.0 / P2
    px = -P0 * iz
    py = -P1 * iz
    r2 = px * px + py * py
    dist = 1.0 + k1 * r2 + k2 * r2 * r2

    # A = dres/dp (2,2); G = A @ (dp/dP) = dres/dP (2,3), expanded
    dd = 2.0 * (k1 + 2.0 * k2 * r2)
    A00 = f * (dist + dd * px * px)
    A01 = f * dd * px * py
    A11 = f * (dist + dd * py * py)
    G00 = -iz * A00
    G01 = -iz * A01
    G02 = -iz * (A00 * px + A01 * py)
    G10 = -iz * A01
    G11 = -iz * A11
    G12 = -iz * (A01 * px + A11 * py)

    # dv/dw (3,3) entries: -alpha [X]x + beta (wdX I + w X^T) + col w^T
    c0 = gamma * wxX0 - alpha * X0 + delta * wdX * w0
    c1 = gamma * wxX1 - alpha * X1 + delta * wdX * w1
    c2 = gamma * wxX2 - alpha * X2 + delta * wdX * w2
    bw = beta * wdX
    ag = jnp.where(tiny, jnp.ones_like(alpha), alpha)
    bg = jnp.where(tiny, jnp.zeros_like(beta), beta)
    zg = jnp.where(tiny, jnp.zeros_like(beta), 1.0)
    D00 = bg * wdX + bg * w0 * X0 + zg * c0 * w0
    D01 = ag * X2 + bg * w0 * X1 + zg * c0 * w1
    D02 = -ag * X1 + bg * w0 * X2 + zg * c0 * w2
    D10 = -ag * X2 + bg * w1 * X0 + zg * c1 * w0
    D11 = bg * wdX + bg * w1 * X1 + zg * c1 * w1
    D12 = ag * X0 + bg * w1 * X2 + zg * c1 * w2
    D20 = ag * X1 + bg * w2 * X0 + zg * c2 * w0
    D21 = -ag * X0 + bg * w2 * X1 + zg * c2 * w1
    D22 = bg * wdX + bg * w2 * X2 + zg * c2 * w2

    # R (3,3) entries: c I + alpha [w]x + beta w w^T
    R00 = c + beta * w0 * w0
    R01 = -alpha * w2 + beta * w0 * w1
    R02 = alpha * w1 + beta * w0 * w2
    R10 = alpha * w2 + beta * w1 * w0
    R11 = c + beta * w1 * w1
    R12 = -alpha * w0 + beta * w1 * w2
    R20 = -alpha * w1 + beta * w2 * w0
    R21 = alpha * w0 + beta * w2 * w1
    R22 = c + beta * w2 * w2

    J_cam = jnp.stack([
        jnp.stack([
            G00 * D00 + G01 * D10 + G02 * D20,
            G00 * D01 + G01 * D11 + G02 * D21,
            G00 * D02 + G01 * D12 + G02 * D22,
            G00, G01, G02,
            dist * px, f * r2 * px, f * r2 * r2 * px,
        ]),
        jnp.stack([
            G10 * D00 + G11 * D10 + G12 * D20,
            G10 * D01 + G11 * D11 + G12 * D21,
            G10 * D02 + G11 * D12 + G12 * D22,
            G10, G11, G12,
            dist * py, f * r2 * py, f * r2 * r2 * py,
        ]),
    ])
    J_pt = jnp.stack([
        jnp.stack([
            G00 * R00 + G01 * R10 + G02 * R20,
            G00 * R01 + G01 * R11 + G02 * R21,
            G00 * R02 + G01 * R12 + G02 * R22,
        ]),
        jnp.stack([
            G10 * R00 + G11 * R10 + G12 * R20,
            G10 * R01 + G11 * R11 + G12 * R21,
            G10 * R02 + G11 * R12 + G12 * R22,
        ]),
    ])
    return J_cam, J_pt


REPROJECTION = factor_type(
    "bal_reprojection", 2, [CAMERA, POINT], reprojection_residual,
    obs_shape=(2,),
    jacobian_fn=(None if os.environ.get("GRAPHITE_TPU_BAL_AUTODIFF")
                 else reprojection_jacobian),
)

#: jacfwd-differentiated variant — the oracle the analytic blocks are
#: tested against (and the pre-round-5 default).
REPROJECTION_AUTO = factor_type(
    "bal_reprojection_auto", 2, [CAMERA, POINT], reprojection_residual,
    obs_shape=(2,),
)
