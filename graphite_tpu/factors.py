"""Factor (constraint) traits and batched storage.

JAX analog of the reference's factor traits + ``FactorDescriptor``
(reference: include/graphite/factor.hpp:36-876, docs/markdown/main.md:179-322).

A factor type is: a residual function over N vertex parameter blocks (any
arity — unary/binary/n-ary), an observation/data layout, a robust loss, and a
differentiation mode. A factor batch is struct-of-arrays NumPy on host; the
frozen problem turns it into dense device arrays plus static index metadata.

Differentiation (reference: include/graphite/differentiation.hpp:6-22,
include/graphite/dual.hpp:8-128): the reference offers forward-mode
``Dual``-number autodiff or hand-written ``jacobian<I>()``. Here AUTO means
``jax.jacfwd`` of the residual through each vertex type's ``retract`` (one
fused trace, batched by ``vmap``); MANUAL means a user-supplied
``jacobian_fn`` returning all N blocks at once.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from .loss import DEFAULT_LOSS, Loss
from .vertices import VertexType


class Differentiation(enum.Enum):
    """Reference ``DifferentiationMode`` (differentiation.hpp:6-22)."""

    AUTO = "auto"
    MANUAL = "manual"


@dataclasses.dataclass(frozen=True)
class FactorType:
    """Static trait describing one type of factor.

    Attributes:
      name: unique name for this factor family.
      residual_dim: E, the residual dimension (``Traits::dimension``).
      vertex_types: the N vertex types this factor connects, in slot order
        (``Traits::VertexDescriptors``).
      residual_fn: ``(params_0(d0a,), ..., params_{N-1}, obs, data) -> (E,)``
        pure residual for ONE factor; batching is vmapped. ``obs``/``data``
        may be arbitrary pytrees (or None when unused), mirroring the
        reference's flexible error-fn signatures (ops/error.hpp:33-96).
      jacobian_fn: optional analytic Jacobians
        ``(params..., obs, data) -> tuple[(E, dim_i)]`` w.r.t. each slot's
        *tangent*. When None (AUTO), ``jax.jacfwd`` through ``retract`` is
        used instead — the replacement for the reference's Dual-seeded
        kernels (ops/error.hpp:100-180).
      loss: robust loss type applied to r^T P r (static per factor type;
        the per-factor parameter lives in the batch).
      obs_shape / data_shape: trailing shapes of per-factor observation and
        constraint data arrays; () means scalar; None means absent
        (reference ``Empty``).
    """

    name: str
    residual_dim: int
    vertex_types: Tuple[VertexType, ...]
    residual_fn: Callable
    jacobian_fn: Optional[Callable] = None
    loss: Loss = DEFAULT_LOSS
    obs_shape: Optional[Tuple[int, ...]] = None
    data_shape: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "vertex_types", tuple(self.vertex_types))

    @property
    def arity(self) -> int:
        return len(self.vertex_types)

    @property
    def differentiation(self) -> Differentiation:
        return Differentiation.MANUAL if self.jacobian_fn else Differentiation.AUTO

    def __hash__(self):
        return hash((self.name, self.residual_dim, self.vertex_types))

    def __eq__(self, other):
        return self is other or (
            isinstance(other, FactorType)
            and (self.name, self.residual_dim, self.vertex_types)
            == (other.name, other.residual_dim, other.vertex_types)
        )


def factor_type(
    name: str,
    residual_dim: int,
    vertex_types: Sequence[VertexType],
    residual_fn: Callable,
    **kw,
) -> FactorType:
    return FactorType(
        name=name,
        residual_dim=residual_dim,
        vertex_types=tuple(vertex_types),
        residual_fn=residual_fn,
        **kw,
    )


# A factor's "active byte" in the reference packs a 7-bit optimization level
# plus an MSB disable bit: is_factor_active(a, level) = (a & 0x7F) <= level
# && !(a & 0x80) (active.hpp:11-15). We keep the same public semantics with
# an explicit (level, enabled) pair.
MAX_LEVEL = 0x7F


@dataclasses.dataclass
class FactorSet:
    """Host-side batch of same-typed factors (graph-construction phase).

    Mirrors ``FactorDescriptor``'s mutable API (factor.hpp:120-876):
    ``add_factor`` (:373), ``remove_factor`` swap-delete (:308),
    ``set_active`` / levels (:419, active.hpp:11-15), default identity
    precision (:864-875). Handles are recycled like the reference's
    ``HandleManager`` (utils.hpp:79-103).
    """

    ftype: FactorType
    ids: list = dataclasses.field(default_factory=list)  # per factor: (N,) global ids
    obs: list = dataclasses.field(default_factory=list)
    data: list = dataclasses.field(default_factory=list)
    precision: list = dataclasses.field(default_factory=list)  # (E,E) or None
    loss_params: list = dataclasses.field(default_factory=list)
    level: list = dataclasses.field(default_factory=list)
    handles: list = dataclasses.field(default_factory=list)
    _handle_to_index: dict = dataclasses.field(default_factory=dict)
    _next_handle: int = 0
    _free_handles: list = dataclasses.field(default_factory=list)
    _bulk: list = dataclasses.field(default_factory=list)  # columnar chunks
    store_jacobians: bool = True

    @property
    def count(self) -> int:
        return len(self.ids) + sum(c["ids"].shape[0] for c in self._bulk)

    def add(
        self,
        vertex_ids: Sequence[int],
        obs=None,
        precision=None,
        data=None,
        loss_param: Optional[float] = None,
        level: int = 0,
    ) -> int:
        if len(vertex_ids) != self.ftype.arity:
            raise ValueError(
                f"factor '{self.ftype.name}' expects {self.ftype.arity} vertex "
                f"ids, got {len(vertex_ids)}"
            )
        if not (0 <= level <= MAX_LEVEL):
            raise ValueError(f"level must be in [0, {MAX_LEVEL}]")
        self._materialize_bulk()  # keep insertion order coherent
        idx = len(self.ids)
        self.ids.append(tuple(int(i) for i in vertex_ids))
        self.obs.append(None if obs is None else np.asarray(obs, dtype=np.float64))
        self.data.append(None if data is None else np.asarray(data, dtype=np.float64))
        self.precision.append(
            None if precision is None else np.asarray(precision, dtype=np.float64)
        )
        self.loss_params.append(
            self.ftype.loss.default_param() if loss_param is None else float(loss_param)
        )
        self.level.append(int(level))
        if self._free_handles:
            handle = self._free_handles.pop()
        else:
            handle = self._next_handle
            self._next_handle += 1
        self.handles.append(handle)
        self._handle_to_index[handle] = idx
        return handle

    def add_batch(self, vertex_ids, obs=None, precision=None, data=None,
                  loss_params=None, levels=None) -> np.ndarray:
        """Columnar bulk add: O(1) in Python, arrays stored as one chunk.

        Returns the handles (a contiguous range). Bulk chunks are
        materialized into the per-item lists lazily on the first mutating
        per-item operation (remove/set_active), so pure build-then-freeze
        workflows (e.g. 5M-observation BAL ingestion) never pay per-item
        Python cost.
        """
        vertex_ids = np.asarray(vertex_ids, dtype=np.int64)
        if vertex_ids.ndim != 2 or vertex_ids.shape[1] != self.ftype.arity:
            raise ValueError(
                f"vertex_ids must be (n, {self.ftype.arity}); got "
                f"{vertex_ids.shape}"
            )
        n = vertex_ids.shape[0]
        chunk = dict(
            ids=vertex_ids,
            obs=None if obs is None else np.asarray(obs, dtype=np.float64),
            data=None if data is None else np.asarray(data, dtype=np.float64),
            precision=(None if precision is None
                       else np.asarray(precision, dtype=np.float64)),
            loss_params=(
                np.full(n, self.ftype.loss.default_param())
                if loss_params is None
                else np.asarray(loss_params, dtype=np.float64)
            ),
            levels=(np.zeros(n, dtype=np.int64) if levels is None
                    else np.asarray(levels, dtype=np.int64)),
        )
        for field in ("obs", "data", "precision", "loss_params", "levels"):
            arr = chunk[field]
            if arr is not None and arr.shape[0] != n:
                raise ValueError(f"{field} first dim must be {n}")
        handles = np.arange(self._next_handle, self._next_handle + n)
        chunk["handles"] = handles
        self._next_handle += n
        self._bulk.append(chunk)
        return handles

    def _materialize_bulk(self) -> None:
        """Flush columnar chunks into the per-item lists (for mutation)."""
        if not self._bulk:
            return
        for chunk in self._bulk:
            n = chunk["ids"].shape[0]
            start = len(self.ids)
            self.ids.extend(map(tuple, chunk["ids"].tolist()))
            obs, data, prec = chunk["obs"], chunk["data"], chunk["precision"]
            self.obs.extend([None] * n if obs is None else list(obs))
            self.data.extend([None] * n if data is None else list(data))
            self.precision.extend([None] * n if prec is None else list(prec))
            self.loss_params.extend(chunk["loss_params"].tolist())
            self.level.extend(chunk["levels"].tolist())
            self.handles.extend(chunk["handles"].tolist())
            for i, h in enumerate(chunk["handles"].tolist()):
                self._handle_to_index[h] = start + i
        self._bulk.clear()

    def remove(self, handle: int) -> None:
        """Swap-with-last removal (factor.hpp:308-371)."""
        self._materialize_bulk()
        idx = self._handle_to_index.pop(handle)
        last = len(self.ids) - 1
        if idx != last:
            for lst in (self.ids, self.obs, self.data, self.precision,
                        self.loss_params, self.level, self.handles):
                lst[idx] = lst[last]
            self._handle_to_index[self.handles[idx]] = idx
        for lst in (self.ids, self.obs, self.data, self.precision,
                    self.loss_params, self.level, self.handles):
            lst.pop()
        self._free_handles.append(handle)

    def set_active(self, handle: int, level_byte: int) -> None:
        """Set the reference-style active byte: bits 0-6 = level, MSB =
        disabled (active.hpp:11-15)."""
        self._materialize_bulk()
        idx = self._handle_to_index[handle]
        self.level[idx] = int(level_byte)

    def set_level(self, handle: int, level: int, enabled: bool = True) -> None:
        byte = (int(level) & MAX_LEVEL) | (0 if enabled else 0x80)
        self.set_active(handle, byte)

    def set_jacobian_storage(self, store: bool) -> None:
        """Dynamic (storage-free) Jacobian mode toggle (factor.hpp:632-650).

        With ``store=False`` the PCG matvec recomputes J on the fly via
        jvp/vjp of the residual (the reference's "dynamic" kernels,
        ops/product.hpp:101-142) — a rematerialization trade analogous to
        activation checkpointing. Requires MANUAL-mode parity only in the
        reference; here both modes support it.
        """
        self.store_jacobians = bool(store)

    def clear(self) -> None:
        """Drop all factors (factor clear test, tests/factor.cu:803)."""
        for lst in (self.ids, self.obs, self.data, self.precision,
                    self.loss_params, self.level, self.handles):
            lst.clear()
        self._bulk.clear()
        self._handle_to_index.clear()
        self._free_handles.clear()
        self._next_handle = 0

    # ---- freeze-time array exports -------------------------------------
    def _concat(self, items, bulk_field, default_shape=None):
        parts = []
        if items:
            parts.append(np.stack([np.asarray(o) for o in items], axis=0))
        for c in self._bulk:
            if c[bulk_field] is not None:
                parts.append(np.asarray(c[bulk_field]))
        if not parts:
            return None
        return np.concatenate(parts, axis=0)

    def ids_array(self) -> np.ndarray:
        out = self._concat(self.ids, "ids")
        if out is None:
            return np.zeros((0, self.ftype.arity), dtype=np.int64)
        return out.astype(np.int64)

    def level_array(self) -> np.ndarray:
        parts = [np.asarray(self.level, dtype=np.int64)]
        parts += [c["levels"] for c in self._bulk]
        return np.concatenate(parts).astype(np.int64)

    def handle_array(self) -> np.ndarray:
        """Handle of each factor in storage order (parallel to ids)."""
        parts = [np.asarray(self.handles, dtype=np.int64)]
        parts += [np.asarray(c["handles"], dtype=np.int64) for c in self._bulk]
        return np.concatenate(parts).astype(np.int64)

    def obs_array(self) -> Optional[np.ndarray]:
        if self.obs and self.obs[0] is None:
            return None
        if not self.obs and all(c["obs"] is None for c in self._bulk):
            return None
        return self._concat(self.obs, "obs")

    def data_array(self) -> Optional[np.ndarray]:
        if self.data and self.data[0] is None:
            return None
        if not self.data and all(c["data"] is None for c in self._bulk):
            return None
        return self._concat(self.data, "data")

    def has_precision(self) -> bool:
        return any(p is not None for p in self.precision) or any(
            c["precision"] is not None for c in self._bulk
        )

    def precision_array(self) -> np.ndarray:
        """Per-factor E x E precision; identity when unset (factor.hpp:864)."""
        e = self.ftype.residual_dim
        out = np.zeros((self.count, e, e))
        eye = np.eye(e)
        for i, p in enumerate(self.precision):
            out[i] = eye if p is None else np.asarray(p).reshape(e, e)
        cursor = len(self.precision)
        for c in self._bulk:
            n = c["ids"].shape[0]
            if c["precision"] is None:
                out[cursor:cursor + n] = eye
            else:
                out[cursor:cursor + n] = np.asarray(c["precision"]).reshape(
                    n, e, e
                )
            cursor += n
        return out

    def loss_params_array(self) -> np.ndarray:
        parts = [np.asarray(self.loss_params, dtype=np.float64)]
        parts += [c["loss_params"] for c in self._bulk]
        return np.concatenate(parts)
