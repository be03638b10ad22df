"""Vertex (optimizable-variable) traits and batched storage.

JAX analog of the reference's vertex traits + ``VertexDescriptor``
(reference: include/graphite/vertex.hpp:14-384, docs/markdown/main.md:71-177).

Differences by design (value semantics instead of pointer soup):

- The reference stores a device array of *pointers* to user-owned
  unified-memory vertex objects (vertex.hpp:54-76). Here a vertex type is a
  pure-function trait and a batch of vertices is one dense ``(count,
  ambient_dim)`` array — a pytree leaf that ``jit``/``vmap``/``shard_map``
  understand.
- ``Traits::update`` (mutating) becomes ``retract(x, delta) -> x_new``.
  Autodiff Jacobians are taken w.r.t. the tangent ``delta`` at ``delta = 0``
  through ``retract`` (lift-solve-retract), which reduces to d(residual)/dx
  for the additive retract used by every reference example.
- The optional partial backup ``State`` (vertex.hpp:129-180,
  bal.cuh:33-53) becomes a ``save_state``/``load_state`` pure-function pair;
  trust-region backup/restore itself is free in the functional optimizer
  (keep the previous pytree).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np


def _additive_retract(x, delta):
    return x + delta


def _full_save(x):
    return x


def _full_load(x, state):
    return state


@dataclasses.dataclass(frozen=True)
class VertexType:
    """Static trait describing one type of optimizable variable.

    Attributes:
      name: unique name used as the pytree key for this variable family.
      dim: tangent (update / Hessian block) dimension — reference
        ``Traits::dimension``.
      ambient_dim: stored parameter dimension (== dim for Euclidean types;
        e.g. 7 for a quaternion SE3 with dim 6).
      retract: ``(x(ambient,), delta(dim,)) -> x(ambient,)`` applying a local
        update — reference ``Traits::update`` (docs/markdown/main.md:130).
      save_state / load_state: optional partial-state backup semantics —
        reference ``Traits::State``/``get_state``/``set_state``
        (ops/state.hpp:7-26). ``load_state(x, state)`` must return the vertex
        with only the backed-up portion restored.
    """

    name: str
    dim: int
    ambient_dim: Optional[int] = None
    retract: Callable = _additive_retract
    save_state: Callable = _full_save
    load_state: Callable = _full_load

    def __post_init__(self):
        if self.ambient_dim is None:
            object.__setattr__(self, "ambient_dim", self.dim)

    def __hash__(self):
        return hash((self.name, self.dim, self.ambient_dim))

    def __eq__(self, other):
        return self is other or (
            isinstance(other, VertexType)
            and (self.name, self.dim, self.ambient_dim)
            == (other.name, other.dim, other.ambient_dim)
        )


def vertex_type(name: str, dim: int, **kw) -> VertexType:
    return VertexType(name=name, dim=dim, **kw)


@dataclasses.dataclass
class VertexSet:
    """Host-side batch of same-typed vertices (graph-construction phase).

    Mirrors ``VertexDescriptor``'s mutable API (vertex.hpp:54-384):
    ``add`` (:244), ``remove`` (swap-with-last, :182), ``replace`` (:227),
    ``set_fixed`` (:262), ``set_eliminate`` (:293). All bookkeeping is
    NumPy on host; ``Graph.freeze`` turns it into static structure + a
    device array.
    """

    vtype: VertexType
    values: list = dataclasses.field(default_factory=list)
    global_ids: list = dataclasses.field(default_factory=list)
    id_to_local: dict = dataclasses.field(default_factory=dict)
    fixed: list = dataclasses.field(default_factory=list)
    eliminate: bool = False

    @property
    def count(self) -> int:
        return len(self.values)

    def add(self, global_id: int, value) -> int:
        if global_id in self.id_to_local:
            raise KeyError(f"vertex id {global_id} already present")
        value = np.asarray(value, dtype=np.float64).reshape(-1)
        if value.shape[0] != self.vtype.ambient_dim:
            raise ValueError(
                f"vertex '{self.vtype.name}' expects {self.vtype.ambient_dim} "
                f"parameters, got {value.shape[0]}"
            )
        local = len(self.values)
        self.values.append(value)
        self.global_ids.append(global_id)
        self.id_to_local[global_id] = local
        self.fixed.append(False)
        return local

    def add_batch(self, global_ids, values) -> np.ndarray:
        """Bulk add (vectorized bookkeeping for million-vertex ingestion)."""
        values = np.asarray(values, dtype=np.float64)
        global_ids = np.asarray(global_ids, dtype=np.int64)
        n = global_ids.shape[0]
        if values.shape != (n, self.vtype.ambient_dim):
            raise ValueError(
                f"values must be ({n}, {self.vtype.ambient_dim}); got "
                f"{values.shape}"
            )
        if len(np.unique(global_ids)) != n:
            raise KeyError("duplicate vertex ids in batch")
        if self.id_to_local:
            clash = set(self.id_to_local).intersection(global_ids.tolist())
            if clash:
                raise KeyError(f"vertex id {next(iter(clash))} already present")
        start = len(self.values)
        self.values.extend(list(values))
        self.global_ids.extend(global_ids.tolist())
        self.id_to_local.update(
            zip(global_ids.tolist(), range(start, start + n))
        )
        self.fixed.extend([False] * n)
        return np.arange(start, start + n)

    def remove(self, global_id: int) -> None:
        """Swap-with-last removal (vertex.hpp:182-225)."""
        local = self.id_to_local.pop(global_id)
        last = len(self.values) - 1
        if local != last:
            self.values[local] = self.values[last]
            self.fixed[local] = self.fixed[last]
            moved = self.global_ids[last]
            self.global_ids[local] = moved
            self.id_to_local[moved] = local
        self.values.pop()
        self.fixed.pop()
        self.global_ids.pop()

    def replace(self, global_id: int, value) -> None:
        """Replace a vertex's parameters in place (vertex.hpp:227-242)."""
        local = self.id_to_local[global_id]
        value = np.asarray(value, dtype=np.float64).reshape(-1)
        self.values[local] = value

    def set_fixed(self, global_id: int, fixed: bool = True) -> None:
        self.fixed[self.id_to_local[global_id]] = bool(fixed)

    def set_eliminate(self, eliminate: bool = True) -> None:
        """Mark the whole set for Schur elimination (vertex.hpp:293)."""
        self.eliminate = bool(eliminate)

    def get(self, global_id: int) -> np.ndarray:
        return self.values[self.id_to_local[global_id]]

    def clear(self) -> None:
        """Drop all vertices (vertex.hpp clear test, tests/vertex.cu:343)."""
        self.values.clear()
        self.global_ids.clear()
        self.id_to_local.clear()
        self.fixed.clear()

    def values_array(self) -> np.ndarray:
        if not self.values:
            return np.zeros((0, self.vtype.ambient_dim))
        return np.stack(self.values, axis=0)

    def fixed_array(self) -> np.ndarray:
        return np.asarray(self.fixed, dtype=bool)
