"""BAL dataset text format: parser, writer, and graph builder.

The BAL text format (https://grail.cs.washington.edu/projects/bal/, parsed
by the reference at examples/bal.cu:42-131):

    num_cameras num_points num_observations
    cam_idx point_idx x y            (x num_observations)
    <9 camera params, one per line>   (x num_cameras)
    <3 point params, one per line>    (x num_points)

A fast C++ parser (graphite_tpu/native) is used when built; NumPy fallback
otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class BALDataset:
    cameras: np.ndarray  # (C, 9)
    points: np.ndarray  # (P, 3)
    cam_idx: np.ndarray  # (O,)
    point_idx: np.ndarray  # (O,)
    observations: np.ndarray  # (O, 2)

    @property
    def num_cameras(self):
        return self.cameras.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def num_observations(self):
        return self.observations.shape[0]


def load(path: str) -> BALDataset:
    """Parse a BAL problem file (optionally .gz / .bz2)."""
    try:
        from ..native import bal_loader

        parsed = bal_loader.load(path)
        if parsed is not None:
            return BALDataset(*parsed)
    except ImportError:
        pass
    return _load_numpy(path)


def _open(path: str):
    if path.endswith(".gz"):
        import gzip

        return gzip.open(path, "rt")
    if path.endswith(".bz2"):
        import bz2

        return bz2.open(path, "rt")
    return open(path, "r")


def _load_numpy(path: str) -> BALDataset:
    with _open(path) as f:
        header = f.readline().split()
        n_cam, n_pt, n_obs = int(header[0]), int(header[1]), int(header[2])
        obs_rows = np.loadtxt(f, max_rows=n_obs).reshape(n_obs, 4)
        rest = np.loadtxt(f)
    cam_idx = obs_rows[:, 0].astype(np.int64)
    point_idx = obs_rows[:, 1].astype(np.int64)
    observations = obs_rows[:, 2:4].astype(np.float64)
    rest = rest.reshape(-1)
    cameras = rest[: n_cam * 9].reshape(n_cam, 9)
    points = rest[n_cam * 9: n_cam * 9 + n_pt * 3].reshape(n_pt, 3)
    return BALDataset(cameras, points, cam_idx, point_idx, observations)


def save(path: str, ds: BALDataset) -> None:
    with open(path, "w") as f:
        f.write(f"{ds.num_cameras} {ds.num_points} {ds.num_observations}\n")
        for c, p, (x, y) in zip(ds.cam_idx, ds.point_idx, ds.observations):
            f.write(f"{c} {p} {x:.16e} {y:.16e}\n")
        for cam in ds.cameras:
            for v in cam:
                f.write(f"{v:.16e}\n")
        for pt in ds.points:
            for v in pt:
                f.write(f"{v:.16e}\n")


def build_graph(ds: BALDataset, precision=None, eliminate_points: bool = True,
                loss=None, loss_param: Optional[float] = None,
                factor=None):
    """Build a Graph for a BAL dataset (examples/bal.cu:134-167).

    Camera ids: [0, C); point ids: [C, C+P) — disjoint global id ranges.
    ``eliminate_points=True`` marks the point set for Schur elimination
    (bal.cu:155).

    Observations are added in CSC-aligned (point, camera) order, which
    sorts the hot reduction destinations, so factor handles do NOT follow
    dataset row order; use ``fs.handle_of_input[row]`` /
    ``fs.input_order[handle]`` to convert.
    """
    import graphite_tpu as gt
    from ..models import bal as bal_model

    precision = precision or gt.FP32_FP32
    g = gt.Graph(precision=precision)
    cams = g.add_vertex_set(bal_model.CAMERA)
    pts = g.add_vertex_set(bal_model.POINT)
    cams.add_batch(np.arange(ds.num_cameras), ds.cameras)
    pts.add_batch(ds.num_cameras + np.arange(ds.num_points), ds.points)
    if eliminate_points:
        pts.set_eliminate(True)

    ftype = factor if factor is not None else bal_model.REPROJECTION
    if loss is not None:
        ftype = dataclasses.replace(ftype, loss=loss)
    fs = g.add_factor_set(ftype)
    # CSC-aligned observation order: sorted by (point, camera), the hot
    # per-iteration reduction destinations come out sorted — the
    # point-diagonal Hessian blocks, the Hpl/point-camera blocks (CSC
    # order is exactly (col=point, row=camera)), and the Schur attach
    # lists — so those segment_sums run on sorted indices
    # (reduce_rows detects sortedness at plan time).
    # The problem is order-independent semantically; the reference keeps
    # file order and pays with atomicAdd scatters (bal.cu:134-167).
    order = np.lexsort((ds.cam_idx, ds.point_idx))
    ids = np.stack(
        [ds.cam_idx[order], ds.num_cameras + ds.point_idx[order]], axis=1
    )
    fs.add_batch(
        ids, obs=ds.observations[order],
        loss_params=(None if loss_param is None
                     else np.full(ds.num_observations, loss_param)),
    )
    # factor handles follow the SORTED order; expose both mappings so
    # callers can still address observations by dataset row:
    #   fs.input_order[h]     -> dataset row of handle h
    #   fs.handle_of_input[r] -> handle of dataset row r
    fs.input_order = order
    handle_of_input = np.empty_like(order)
    handle_of_input[order] = np.arange(order.shape[0], dtype=order.dtype)
    fs.handle_of_input = handle_of_input
    return g, cams, pts, fs
