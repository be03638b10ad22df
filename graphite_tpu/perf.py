"""FLOP ledger and MFU accounting.

The reference ships no FLOP counting at all (BASELINE.md: wall-clock tables
only, levenberg_marquardt.hpp:153-163), so the rebuild grounds its perf
claims here:

- `flop_ledger(problem, ...)` counts the *useful* (algorithmic) FLOPs of each
  LM-iteration stage analytically from the static freeze-time structure —
  the same structure the kernels consume, so the counts are exact for the
  algebraic stages (Hessian assembly, Hll inversion, Schur triple products,
  PCG matvecs, back-substitution).
- `xla_flops(fn, *args)` returns XLA's own cost analysis of a compiled
  program (executed FLOPs, including padding/waste) — used for the stages
  whose cost depends on user residual functions (linearize).
- `device_peak()` returns the card's published peak bf16 matmul FLOP/s and
  memory bandwidth so measured times convert to MFU and roofline shares.

Conventions: one fused multiply-add = 2 FLOPs; `jnp.linalg.inv`/Cholesky of
a d x d block = 2*d^3 (the constant hardly matters at d <= 9).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

# Published peaks per device kind: dense bf16 matmul FLOP/s (no sparsity)
# and device-memory GB/s. A kind matches when its ``device_kind`` contains
# every tag. Source: NVIDIA H100 SXM data sheet; the rates assume the full
# 700 W power limit, so report a card's power limit beside any share of them.
_PEAKS = (
    (("h100", "hbm3"), dict(bf16=989e12, hbm_gbps=3350.0)),
)


def device_peak(device=None) -> Optional[Dict[str, float]]:
    """Peak bf16 matmul FLOP/s + memory GB/s of ``device`` (default: the
    first local device), or None for a device kind not in the table — the
    caller then omits MFU and roofline shares instead of dividing by a
    guess."""
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", "").lower()
    for tags, peak in _PEAKS:
        if all(t in kind for t in tags):
            return dict(peak)
    return None


def xla_flops(compiled) -> float:
    """XLA's executed-FLOP estimate for a compiled (lowered) function."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return float(ca.get("flops", 0.0)) if ca else 0.0


def compile_and_count(fn, *args) -> tuple:
    """jit-compile ``fn`` and return (compiled, xla_flops, bytes_accessed)."""
    compiled = jax.jit(fn).lower(*args).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    ca = ca or {}
    return compiled, float(ca.get("flops", 0.0)), float(
        ca.get("bytes accessed", 0.0))


# --------------------------------------------------------------------------
# Analytic ledger from the static structure
# --------------------------------------------------------------------------


def flop_ledger(problem, pcg_iters: int = 10,
                dense_s_matvec: Optional[bool] = None) -> Dict[str, float]:
    """Useful FLOPs of each LM-iteration stage (one PCG-Schur iteration).

    Counts only the algorithmic work the math requires — gathers, scatters
    and masked/padded lanes are excluded, so measured GFLOP/s against these
    numbers is a *utilization* figure (how close the stage runs to pure
    matmul speed-of-light), not an activity counter.

    Stages (mirrors the reference's per-iteration pipeline,
    pcg_schur.hpp:79-168):
      hessian_values   J^T dL P J for every factor slot-pair (ops/hessian.hpp:9-78)
      hll_inverse      batched SPD inverses of landmark diagonal blocks
                       (schur.hpp:1067-1114)
      hpl_w            W = Hpl * Hll^{-1} per Hpl block (precompute)
      triple_products  S -= W * Hpl^T per product tuple (schur.hpp:649-734)
      b_schur          b_p - Hpl Hll^{-1} b_l (schur.hpp:886-920)
      pcg_matvec       (pcg_iters+1) S matvecs (dense or block-sparse)
      precond          block-Jacobi-Schur build + per-iteration applies
      backsub          dx_l = Hll^{-1}(b_l - Hpl^T dx_p) (schur.hpp:279-302)
    """
    from .hessian import build_hessian_structure
    from .schur import build_schur_structure

    hs = build_hessian_structure(problem)
    ledger: Dict[str, float] = {}

    # Hessian assembly: per contribution map, F * (J_s^T (P J_t)) + dL scale.
    hv = 0.0
    pj_done = set()
    for cm in hs.contribs:
        if cm.direct_idx is None and cm.trans_idx is None:
            continue
        fm = problem.factor_meta[cm.fname]
        F = fm.count
        E = fm.ftype.residual_dim
        ds = fm.ftype.vertex_types[cm.s].dim
        dt = fm.ftype.vertex_types[cm.t].dim
        fa = problem.data.factors[cm.fname]
        if fa.precision is not None and (cm.fname, cm.t) not in pj_done:
            pj_done.add((cm.fname, cm.t))
            hv += F * 2.0 * E * E * dt  # P J_t
        hv += F * (2.0 * E * ds * dt + ds * dt)  # J_s^T (PJ_t), * dL
    ledger["hessian_values"] = hv

    if problem.elimination_block >= problem.n_blocks:
        return ledger  # no Schur system

    ss = build_schur_structure(problem)

    ledger["hll_inverse"] = sum(
        ss.lm_h_idx[d].shape[0] * 2.0 * d**3 for d in ss.lm_dims
    )
    ledger["hpl_w"] = sum(
        ss.hpl_h_idx[key].shape[0] * 2.0 * key[0] * key[1] * key[1]
        for key in ss.hpl_keys
    )
    ledger["triple_products"] = sum(
        pg["dst"].shape[0] * (2.0 * pg["dims"][0] * pg["dims"][1]
                              * pg["dims"][2] + pg["dims"][0] * pg["dims"][2])
        for pg in ss.products
    )
    # b_schur: Hll^{-1} b_l (2 d^2 per landmark) + Hpl w (2 dp dl per block)
    ledger["b_schur"] = (
        sum(ss.lm_h_idx[d].shape[0] * 2.0 * d * d for d in ss.lm_dims)
        + sum(ss.hpl_h_idx[key].shape[0] * 2.0 * key[0] * key[1]
              for key in ss.hpl_keys)
    )

    # PCG: (iters+1) matvecs (one computes the initial residual).
    if dense_s_matvec is None:
        dense_s_matvec = ss.dim_p <= 8192
    if dense_s_matvec:
        per_mv = 2.0 * ss.dim_p * ss.dim_p
    else:
        per_mv = sum(
            (2.0 * key[0] * key[1]) * ss.s_sizes[key] * 2  # + transpose side
            for key in ss.s_keys
        )
    ledger["pcg_matvec"] = (pcg_iters + 1) * per_mv

    # preconditioner: invert n_pose diagonal S blocks + apply per iteration
    ledger["precond"] = sum(
        2.0 * float(d) ** 3 + (pcg_iters + 1) * 2.0 * float(d) * float(d)
        for d in ss.pose_dims
    )

    # backsub: Hpl^T dx_p per Hpl block + Hll^{-1} (...) per landmark
    ledger["backsub"] = (
        sum(ss.hpl_h_idx[key].shape[0] * 2.0 * key[0] * key[1]
            for key in ss.hpl_keys)
        + sum(ss.lm_h_idx[d].shape[0] * 2.0 * d * d for d in ss.lm_dims)
    )
    return ledger


def bytes_ledger(problem, pcg_iters: int = 10) -> Dict[str, float]:
    """Logical HBM byte floor per stage (read every operand once, write
    every output once, at the algorithm's own granularity — no gather-row
    padding, no materialized gather buffers, no scan-carry re-reads).

    This workload is bandwidth-bound (3x3..9x9 block gather/scatter), so
    the meaningful roofline is achieved GB/s against these bytes, not
    GFLOP/s. bench.py reports ``gbps_floor = bytes_floor / measured_ms`` per stage
    alongside XLA's own bytes-accessed figure for the compiled program.

    Granularity choices (documented so the ratios mean something):
    - ``schur_values``: per-PAIR streams — every triple product reads one
      W row (dpa*dl) and one Hpl row (dpb*dl); plus the W build (read Hpl
      + Hll^{-1}, write W) and the S output written once.
    - ``pcg_matvec``: S blocks read twice per matvec (forward + transposed
      directions of the streaming/folded matvec) + x gathers + y.
    - ``b_schur``/``backsub``: Hpl read once + the landmark solve tables.
    """
    from .hessian import build_hessian_structure
    from .schur import build_schur_structure

    build_hessian_structure(problem)
    B: Dict[str, float] = {}
    if problem.elimination_block >= problem.n_blocks:
        return B
    ss = build_schur_structure(problem)
    f = 4.0  # f32 storage on the hot path

    attach = {k: float(ss.hpl_h_idx[k].shape[0]) for k in ss.hpl_keys}
    n_lm_bytes = sum(
        float(ss.lm_h_idx[d].shape[0]) * d * d * f for d in ss.lm_dims)
    s_bytes = sum(
        float(ss.s_sizes[k]) * k[0] * k[1] * f for k in ss.s_keys)

    # W build: read Hpl + expanded Hll^{-1}, write W
    w_build = sum(
        a * (2.0 * k[0] * k[1] + k[1] * k[1]) * f
        for k, a in attach.items())
    # pair streams: each product reads a W row and an Hpl row
    pair_stream = sum(
        float(pg["dst"].shape[0])
        * (pg["dims"][0] + pg["dims"][2]) * pg["dims"][1] * f
        for pg in ss.products)
    B["schur_values"] = w_build + n_lm_bytes + pair_stream + 2.0 * s_bytes

    B["b_schur"] = (
        sum(a * k[0] * k[1] * f for k, a in attach.items())
        + 2.0 * n_lm_bytes + ss.dim_p * f)

    x_bytes = sum(
        float(ss.s_sizes[k]) * (k[0] + k[1]) * f for k in ss.s_keys)
    B["pcg_matvec"] = (pcg_iters + 1) * (2.0 * s_bytes + x_bytes
                                         + 2.0 * ss.dim_p * f)
    B["s_matvec"] = 2.0 * s_bytes + x_bytes + 2.0 * ss.dim_p * f

    B["backsub"] = (
        sum(a * k[0] * k[1] * f for k, a in attach.items())
        + 2.0 * n_lm_bytes)
    return B


# ---------------------------------------------------------------------------
# Freeze-time section tracing
# ---------------------------------------------------------------------------

class SectionTimer:
    """Per-section wall-clock tracer for host-side setup phases.

    Enabled by ``GRAPHITE_TPU_TRACE_FREEZE=1``; a disabled timer is a
    no-op. Used by ``Graph.freeze`` / ``build_hessian_structure`` /
    ``build_schur_structure`` to attribute Venice-Final-scale setup cost
    (the analog of the reference's timed setup phases, bal.cu:93-147).
    """

    def __init__(self, name: str):
        import os
        import sys
        import time

        self.enabled = bool(os.environ.get("GRAPHITE_TPU_TRACE_FREEZE"))
        self._name = name
        self._time = time.perf_counter
        self._err = sys.stderr
        self._t0 = self._time()
        self._start = self._t0

    def lap(self, label: str) -> None:
        if not self.enabled:
            return
        t = self._time()
        print(f"[freeze-trace] {self._name}.{label}: {t - self._t0:.2f}s",
              file=self._err, flush=True)
        self._t0 = t

    def done(self) -> None:
        if not self.enabled:
            return
        t = self._time()
        print(f"[freeze-trace] {self._name} TOTAL: {t - self._start:.2f}s",
              file=self._err, flush=True)
