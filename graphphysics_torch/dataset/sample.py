"""Host-side raw sample container and mesh -> sample conversion
(counterpart of ``graphphysics_tpu/dataset/sample.py``). ``RawSample`` is the
mutable numpy object the preprocessing pipeline transforms before padding to
a ``core.graph.Graph``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np

from graphphysics_torch.topology import tetra_to_faces


@dataclasses.dataclass
class RawSample:
    """A single dynamic-size frame graph under construction (host, numpy)."""

    x: np.ndarray  # [N, F] node features
    pos: np.ndarray  # [N, D]
    faces: Optional[np.ndarray] = None  # [F, 3] triangles
    tetra: Optional[np.ndarray] = None  # [T, 4]
    senders: Optional[np.ndarray] = None  # [E]
    receivers: Optional[np.ndarray] = None
    edge_attr: Optional[np.ndarray] = None  # [E, Fe]
    y: Optional[np.ndarray] = None  # [N, Fo]
    # the previous frame: its x ([N, F], h5) or its dynamic fields (XDMF)
    previous_data: Optional[Any] = None
    traj_index: int = 0  # the trajectory the frame comes from
    id: Optional[str] = None  # the mesh's name, where the format has one (XDMF)
    target_dt: Optional[float] = None  # time to the target frame (XDMF)
    previous_dt: Optional[float] = None  # time to the previous frame, negative (XDMF)

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return 0 if self.senders is None else self.senders.shape[0]


def _stack_point_data(
    point_data: Dict[str, np.ndarray], num_points: int, time: Union[int, float]
) -> np.ndarray:
    """hstack the point-data fields plus a trailing time column."""
    cols = [np.asarray(data).reshape(num_points, -1) for data in point_data.values()]
    cols.append(np.full((num_points, 1), time))
    return np.hstack(cols).astype(np.float32)


def meshdata_to_sample(
    points: np.ndarray,
    cells: np.ndarray,
    point_data: Optional[Dict[str, np.ndarray]],
    time: Union[int, float] = 1,
    target: Optional[Dict[str, np.ndarray]] = None,
    id: Optional[str] = None,
) -> RawSample:
    """Build a RawSample from mesh arrays; tetrahedral cells are kept as
    ``tetra`` and expanded to their triangle faces."""
    points = np.asarray(points)
    n = len(points)
    x = (
        _stack_point_data(point_data, n, time)
        if point_data is not None
        else np.zeros((n, 1), np.float32)
    )
    y = None
    if target is not None:
        y = np.hstack([np.asarray(v).reshape(n, -1) for v in target.values()]).astype(
            np.float32
        )
    cells = np.asarray(cells)
    if cells.ndim != 2 or cells.shape[-1] not in (3, 4):
        raise ValueError(f"cells must be [F, 3] triangles or [T, 4] tetrahedra, got {cells.shape}")
    tetra = cells if cells.shape[-1] == 4 else None
    faces = cells if tetra is None else tetra_to_faces(tetra)
    return RawSample(
        x=x,
        pos=points.astype(np.float32),
        faces=faces.astype(np.int64),
        tetra=None if tetra is None else tetra.astype(np.int64),
        y=y,
        id=id,
    )
