"""Synthetic cylinder-flow trajectories with the CylinderFlow schema
(counterpart of part of ``graphphysics_tpu/utils/synthetic.py``), built in
memory: the dict ``load_meta_trajectory`` returns for a trajectory that
``write_cylinder_h5`` wrote, and its meta."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from graphphysics_torch.core.nodetype import NodeType


def triangulated_grid(nx: int, ny: int) -> Tuple[np.ndarray, np.ndarray]:
    """Structured triangle mesh on [0,1]^2: (points [N,2], tris [T,3])."""
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny), indexing="ij")
    points = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float32)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (i * ny + j).ravel()
    b = ((i + 1) * ny + j).ravel()
    c = (i * ny + j + 1).ravel()
    d = ((i + 1) * ny + j + 1).ravel()
    # per cell (i, j) in row-major order: triangles [a, b, c] then [b, d, c]
    tris = np.stack([np.stack([a, b, c], 1), np.stack([b, d, c], 1)], axis=1)
    return points, tris.reshape(-1, 3).astype(np.int32)


def cylinder_node_types(points: np.ndarray) -> np.ndarray:
    nt = np.full(len(points), int(NodeType.NORMAL), np.int32)
    nt[points[:, 0] == 0.0] = int(NodeType.INFLOW)
    nt[points[:, 0] == 1.0] = int(NodeType.OUTFLOW)
    nt[(points[:, 1] == 0.0) | (points[:, 1] == 1.0)] = int(NodeType.WALL_BOUNDARY)
    return nt


def synth_velocity(points: np.ndarray, t: float) -> np.ndarray:
    """A smooth, time-evolving 2D field (an advecting vortex)."""
    x, y = points[:, 0], points[:, 1]
    u = np.sin(2 * np.pi * (x - 0.3 * t)) * np.cos(np.pi * y)
    v = 0.5 * np.cos(2 * np.pi * (x - 0.3 * t)) * np.sin(np.pi * y)
    return np.stack([u, v], axis=1).astype(np.float32)


def cylinder_meta(steps: int) -> Dict[str, Any]:
    return {
        "dt": 0.01,
        "features": {
            "cells": {"type": "static", "shape": [steps, -1, 3], "dtype": "int32"},
            "mesh_pos": {"type": "static", "shape": [steps, -1, 2], "dtype": "float32"},
            "node_type": {"type": "static", "shape": [steps, -1, 1], "dtype": "int32"},
            "velocity": {"type": "dynamic", "shape": [steps, -1, 2], "dtype": "float32"},
        },
        "field_names": ["cells", "mesh_pos", "node_type", "velocity"],
        "trajectory_length": steps,
    }


def cylinder_trajectory(
    steps: int = 12, nx: int = 12, ny: int = 8, phase0: float = 0.0
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """One cylinder-flow trajectory in memory: ``(traj, meta)`` where
    ``traj`` holds ``cells [T,F,3]``, ``mesh_pos [T,N,2]``,
    ``node_type [T,N,1]`` and ``velocity [T,N,2]`` exactly as
    ``load_meta_trajectory`` reads trajectory ``k`` of a ``write_cylinder_h5``
    file (whose phase is ``0.15 * k`` without a seed)."""
    points, tris = triangulated_grid(nx, ny)
    traj = {
        "cells": np.repeat(tris[None], steps, axis=0),
        "mesh_pos": np.repeat(points[None], steps, axis=0),
        "node_type": np.repeat(cylinder_node_types(points)[None, :, None], steps, axis=0),
        "velocity": np.stack(
            [synth_velocity(points, 0.05 * t + phase0) for t in range(steps)]
        ),
    }
    return traj, cylinder_meta(steps)
