"""Host-side raw sample container and mesh -> sample conversion
(counterpart of ``graphphysics_tpu/dataset/sample.py``). ``RawSample`` is the
mutable numpy object the preprocessing pipeline transforms before padding to
a ``core.graph.Graph``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np


@dataclasses.dataclass
class RawSample:
    """A single dynamic-size frame graph under construction (host, numpy)."""

    x: np.ndarray  # [N, F] node features
    pos: np.ndarray  # [N, D]
    faces: Optional[np.ndarray] = None  # [F, 3] triangles
    senders: Optional[np.ndarray] = None  # [E]
    receivers: Optional[np.ndarray] = None
    edge_attr: Optional[np.ndarray] = None  # [E, Fe]
    y: Optional[np.ndarray] = None  # [N, Fo]

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
) -> RawSample:
    """Build a RawSample from triangle-mesh arrays (tetrahedral cells come
    with a later slice of the port)."""
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
    if cells.ndim != 2 or cells.shape[-1] != 3:
        raise ValueError(f"cells must be [F, 3] triangles, got {cells.shape}")
    return RawSample(
        x=x,
        pos=points.astype(np.float32),
        faces=cells.astype(np.int64),
        y=y,
    )
