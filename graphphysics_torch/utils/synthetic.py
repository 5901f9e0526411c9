"""Synthetic trajectories with the CylinderFlow, panels, DeformingPlate
(plain and press) and aneurysm schemas (counterpart of
``graphphysics_tpu/utils/synthetic.py``). The array builders work in memory:
each gives the trajectory dict and meta that a reader of a
``write_cylinder_h5``, ``write_panels_xdmf``, ``write_plate_press_h5`` or
``write_aneurysm_xdmf`` file sees, and the ``*_conditions`` functions
give each trajectory's draws as those writers make them. The writers
(``write_cylinder_h5``, ``write_plate_h5``, ``write_plate_press_h5``: an
h5 and its ``meta.json``; ``write_panels_xdmf``, ``write_aneurysm_xdmf``:
XDMF with HDF5 heavy data) write those files exactly as the JAX package
does; they need ``h5py``, imported where a file opens."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def cylinder_conditions(num_traj: int, seed: Optional[int] = None) -> List[float]:
    """The ``phase0`` of each trajectory of ``write_cylinder_h5``:
    ``0.15 * k`` without a seed, else drawn from ``default_rng(seed)`` in
    [0, 3) in trajectory order."""
    if seed is None:
        return [0.15 * k for k in range(num_traj)]
    rng = np.random.default_rng(seed)
    return [float(rng.uniform(0.0, 3.0)) for _ in range(num_traj)]


def write_cylinder_h5(dirpath: str, num_traj: int = 2, steps: int = 12, nx: int = 12, ny: int = 8,
                      grids: Optional[Sequence[Tuple[int, int]]] = None,
                      seed: Optional[int] = None) -> Tuple[str, str]:
    """A CylinderFlow-schema ``train.h5``: group ``k`` holds trajectory
    ``k`` of ``cylinder_conditions`` on ``triangulated_grid(*grids[k])``
    where ``grids`` is given (mesh sizes that differ, the size-bucketing
    regime), else on ``triangulated_grid(nx, ny)``; and ``meta.json``.
    Returns ``(h5_path, meta_path)``."""
    import h5py

    os.makedirs(dirpath, exist_ok=True)
    grids = list(grids) if grids is not None else [(nx, ny)] * num_traj
    h5_path = os.path.join(dirpath, "train.h5")
    with h5py.File(h5_path, "w") as f:
        for k, ((gx, gy), phase0) in enumerate(zip(grids, cylinder_conditions(len(grids), seed))):
            traj, _ = cylinder_trajectory(steps, gx, gy, phase0=phase0)
            g = f.create_group(str(k))
            for name, array in traj.items():
                g[name] = array
    return h5_path, write_json(os.path.join(dirpath, "meta.json"), cylinder_meta(steps))


def panels_meta(steps: int) -> Dict[str, Any]:
    """The panels meta; its feature order fixes the x layout
    ``[Vitesse(3), NodeType(1), time(1)]`` (features 0:2, node_type_index 3
    in ``training_config/panels.json``)."""
    return {
        "dt": 0.05,
        "features": {
            "cells": {"type": "static", "shape": [steps, -1, 3], "dtype": "int32"},
            "mesh_pos": {"type": "static", "shape": [steps, -1, 2], "dtype": "float32"},
            "VitesseCoarse": {"type": "dynamic", "shape": [steps, -1, 3], "dtype": "float32"},
            "NodeTypeCoarse": {"type": "static", "shape": [steps, -1, 1], "dtype": "int32"},
        },
        "field_names": ["cells", "mesh_pos", "VitesseCoarse", "NodeTypeCoarse"],
        "trajectory_length": steps,
    }


def panels_trajectory(
    steps: int = 12, nx: int = 12, ny: int = 8, phase0: float = 0.0, amp: float = 1.0
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """One panels trajectory in memory: ``(traj, meta)`` with ``cells``,
    ``mesh_pos``, ``VitesseCoarse [T,N,3]`` (the third component zero) and a
    static ``NodeTypeCoarse [T,N,1]`` holding a square WALL panel inside the
    flow, where the velocity is zero. These are the arrays, in meta order,
    that ``write_panels_xdmf`` writes for a trajectory of phase ``phase0``
    and amplitude ``amp`` (its trajectory ``k`` without a seed has phase
    ``0.15 * k`` and amplitude 1)."""
    points, tris = triangulated_grid(nx, ny)
    nt = cylinder_node_types(points)
    panel = (np.abs(points[:, 0] - 0.4) < 0.12) & (np.abs(points[:, 1] - 0.5) < 0.15)
    nt[panel] = int(NodeType.WALL_BOUNDARY)
    damp = (1.0 - (nt == int(NodeType.WALL_BOUNDARY)))[:, None]
    zero = np.zeros((len(points), 1), np.float32)
    vit = [
        (np.concatenate([amp * synth_velocity(points, 0.05 * t + phase0), zero], axis=1) * damp)
        for t in range(steps)
    ]
    traj = {
        "cells": np.repeat(tris[None], steps, axis=0),
        "mesh_pos": np.repeat(points[None], steps, axis=0),
        "VitesseCoarse": np.stack(vit).astype(np.float32),
        "NodeTypeCoarse": np.repeat(nt[None, :, None], steps, axis=0),
    }
    return traj, panels_meta(steps)


def panels_conditions(num_traj: int, seed: Optional[int] = None) -> List[Tuple[float, float]]:
    """The ``(phase0, amp)`` of each trajectory of ``write_panels_xdmf``:
    ``(0.15 * k, 1)`` without a seed, else drawn from
    ``default_rng(seed)`` in trajectory order."""
    if seed is None:
        return [(0.15 * k, 1.0) for k in range(num_traj)]
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(0.0, 1.0)), float(rng.uniform(0.8, 1.2))) for _ in range(num_traj)]


def write_json(path: str, obj: Dict[str, Any]) -> str:
    with open(path, "w") as fp:
        json.dump(obj, fp)
    return path


def write_panels_xdmf(dirpath: str, num_traj: int = 2, steps: int = 12, nx: int = 12, ny: int = 8,
                      seed: Optional[int] = None) -> Tuple[str, str]:
    """A panels XDMF folder: ``panel_{k}.xdmf`` (and its ``.h5``) for each
    trajectory of ``panels_conditions``, the frame ``t`` at time
    ``0.05 * t``, and ``meta.json``; returns ``(dirpath, meta_path)``."""
    from graphphysics_torch.utils.xdmf import XdmfTimeSeriesWriter

    os.makedirs(dirpath, exist_ok=True)
    for k, (phase0, amp) in enumerate(panels_conditions(num_traj, seed)):
        traj, _ = panels_trajectory(steps, nx, ny, phase0=phase0, amp=amp)
        with XdmfTimeSeriesWriter(os.path.join(dirpath, f"panel_{k}.xdmf")) as w:
            w.write_points_cells(traj["mesh_pos"][0].astype(np.float64), traj["cells"][0],
                                 cell_type="triangle")
            for t in range(steps):
                w.write_data(0.05 * t, {"VitesseCoarse": traj["VitesseCoarse"][t],
                                        "NodeTypeCoarse": traj["NodeTypeCoarse"][t, :, 0]})
    return dirpath, write_json(os.path.join(dirpath, "meta.json"), panels_meta(steps))


def tet_box(
    nx: int, ny: int, nz: int, extent: Tuple[float, float, float] = (1.0, 1.0, 1.0)
) -> Tuple[np.ndarray, np.ndarray]:
    """Structured tetrahedral mesh on [0, ex] x [0, ey] x [0, ez] with
    ``nx * ny * nz`` nodes (x slowest, z fastest): ``(points [N, 3] float32,
    tets [6 (nx-1)(ny-1)(nz-1), 4] int32)``, each cube of the grid cut into
    6 tetrahedra around its diagonal, cubes in row-major order."""
    ex, ey, ez = extent
    xs, ys, zs = np.meshgrid(np.linspace(0, ex, nx), np.linspace(0, ey, ny),
                             np.linspace(0, ez, nz), indexing="ij")
    points = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1).astype(np.float32)
    i, j, k = (a.ravel() for a in np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                                              np.arange(nz - 1), indexing="ij"))
    # the cube's corners, (a, b, c) in {0, 1}^3 in row-major order
    corners = np.stack(
        [((i + a) * ny + j + b) * nz + k + c for a in (0, 1) for b in (0, 1) for c in (0, 1)], axis=1
    )
    split = np.array([[0, 1, 3, 7], [0, 1, 5, 7], [0, 4, 5, 7],
                      [0, 2, 3, 7], [0, 2, 6, 7], [0, 4, 6, 7]])
    return points, corners[:, split].reshape(-1, 4).astype(np.int32)


def tet_grid(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``tet_box(n, n, n)``: the unit cube with ``n^3`` nodes."""
    return tet_box(n, n, n)


PLATE_Z_TOP = 0.2  # the slab's thickness
PLATE_SIGMA = 0.18  # the width of the press's Gaussian indentation


def plate_press_meta(steps: int) -> Dict[str, Any]:
    """The DeformingPlate meta: world position the one input field and the
    target (``target_features``), so x is ``[world_pos(3), node_type(1),
    time(1)]`` before ``add_obstacles_next_pos``."""
    return {
        "dt": 0,
        "features": {
            "cells": {"type": "static", "shape": [steps, -1, 4], "dtype": "int32"},
            "node_type": {"type": "static", "shape": [steps, -1, 1], "dtype": "int32"},
            "mesh_pos": {"type": "static", "shape": [steps, -1, 3], "dtype": "float32"},
            "world_pos": {"type": "dynamic", "shape": [steps, -1, 3], "dtype": "float32"},
        },
        "target_features": ["world_pos"],
        "field_names": ["cells", "node_type", "mesh_pos", "world_pos"],
        "trajectory_length": steps,
    }


def write_plate_h5(dirpath: str, num_traj: int = 1, steps: int = 8, n: int = 5) -> Tuple[str, str]:
    """A DeformingPlate-schema ``train.h5`` on ``tet_grid(n)``: HANDLE
    nodes at z = 0, OBSTACLE nodes at z = 1, the world position the mesh
    lifted by ``0.02 * t`` in z at frame ``t``, the same in every
    trajectory; and ``meta.json`` (``plate_press_meta``). Returns
    ``(h5_path, meta_path)``."""
    import h5py

    os.makedirs(dirpath, exist_ok=True)
    points, tets = tet_grid(n)
    nt = np.full(len(points), int(NodeType.NORMAL), np.int32)
    nt[points[:, 2] == 0.0] = int(NodeType.HANDLE)
    nt[points[:, 2] == 1.0] = int(NodeType.OBSTACLE)
    lift = np.array([0, 0, 1], np.float32)
    world_pos = np.stack([points + 0.02 * t * lift for t in range(steps)]).astype(np.float32)
    h5_path = os.path.join(dirpath, "train.h5")
    with h5py.File(h5_path, "w") as f:
        for k in range(num_traj):
            g = f.create_group(str(k))
            g["cells"] = np.repeat(tets[None], steps, axis=0)
            g["mesh_pos"] = np.repeat(points[None], steps, axis=0)
            g["node_type"] = np.repeat(nt[None, :, None], steps, axis=0)
            g["world_pos"] = world_pos
    return h5_path, write_json(os.path.join(dirpath, "meta.json"), plate_press_meta(steps))


def plate_press_conditions(num_traj: int, seed: int = 0) -> List[Tuple[float, float, float]]:
    """The ``(cx, cy, speed)`` of each trajectory of
    ``write_plate_press_h5``: the punch's centre in [0.3, 0.7)^2 and its
    descent per frame in [0.0025, 0.004), drawn from ``default_rng(seed)``
    in trajectory order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_traj):
        cx, cy = rng.uniform(0.3, 0.7, size=2)
        out.append((cx, cy, rng.uniform(0.0025, 0.004)))
    return out


def plate_press_trajectory(
    steps: int = 40, nx: int = 10, nz: int = 3, cx: float = 0.5, cy: float = 0.5,
    speed: float = 0.003,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """One press trajectory in memory: a rigid punch (``tet_box(3, 3, 2)``,
    OBSTACLE nodes, centred at ``(cx, cy)``) descends by ``speed`` a frame
    into a slab (``tet_box(nx, nx, nz)`` of thickness ``PLATE_Z_TOP``,
    HANDLE nodes on its fixed bottom face), which deforms by a Gaussian
    indentation growing with the contact depth; contact begins a quarter
    into the trajectory. ``(traj, meta)`` with the static ``cells [C, 4]``,
    ``mesh_pos [N, 3]`` and ``node_type [N, 1]`` untiled and
    ``world_pos [T, N, 3]``: the arrays of a ``write_plate_press_h5``
    trajectory drawn with ``(cx, cy, speed)``, without the time axis on the
    static fields."""
    plate_pts, plate_tets = tet_box(nx, nx, nz, extent=(1.0, 1.0, PLATE_Z_TOP))
    punch_pts0, punch_tets = tet_box(3, 3, 2, extent=(0.16, 0.16, 0.05))
    n_plate = len(plate_pts)
    points = np.concatenate([plate_pts, punch_pts0], axis=0)
    tets = np.concatenate([plate_tets, punch_tets + n_plate], axis=0)
    nt = np.full(len(points), int(NodeType.NORMAL), np.int32)
    nt[:n_plate][plate_pts[:, 2] == 0.0] = int(NodeType.HANDLE)
    nt[n_plate:] = int(NodeType.OBSTACLE)

    z0 = PLATE_Z_TOP + 0.25 * speed * steps
    punch = punch_pts0 + np.array([cx - 0.08, cy - 0.08, z0], np.float32)
    r2 = (plate_pts[:, 0] - cx) ** 2 + (plate_pts[:, 1] - cy) ** 2
    bump = np.exp(-r2 / (2 * PLATE_SIGMA**2)) * (plate_pts[:, 2] / PLATE_Z_TOP)
    frames = []
    for t in range(steps):
        descent = speed * t
        depth = max(0.0, descent - (z0 - PLATE_Z_TOP))  # contact depth
        frames.append(np.concatenate(
            [plate_pts - np.outer(depth * bump, np.array([0, 0, 1.0])),
             punch - np.array([0, 0, descent])],
            axis=0,
        ).astype(np.float32))
    traj = {"cells": tets, "node_type": nt[:, None], "mesh_pos": points,
            "world_pos": np.stack(frames)}
    return traj, plate_press_meta(steps)


def write_plate_press_h5(dirpath: str, num_traj: int = 4, steps: int = 40, nx: int = 10, nz: int = 3,
                         seed: int = 0) -> Tuple[str, str]:
    """A press ``train.h5``: group ``k`` holds ``plate_press_trajectory``
    drawn with trajectory ``k`` of ``plate_press_conditions(num_traj,
    seed)``, its static fields tiled over the frames; and ``meta.json``.
    Returns ``(h5_path, meta_path)``; use a world-edge radius >= 0.08."""
    import h5py

    os.makedirs(dirpath, exist_ok=True)
    h5_path = os.path.join(dirpath, "train.h5")
    with h5py.File(h5_path, "w") as f:
        for k, (cx, cy, speed) in enumerate(plate_press_conditions(num_traj, seed)):
            traj, _ = plate_press_trajectory(steps, nx, nz, cx=cx, cy=cy, speed=speed)
            g = f.create_group(str(k))
            for name in ("cells", "mesh_pos", "node_type"):
                g[name] = np.repeat(traj[name][None], steps, axis=0)
            g["world_pos"] = traj["world_pos"]
    return h5_path, write_json(os.path.join(dirpath, "meta.json"), plate_press_meta(steps))


def aneurysm_meta(steps: int) -> Dict[str, Any]:
    """The aneurysm meta; its feature order fixes the x layout
    ``[Vitesse(3), wall_mask(1), time(1)]`` before the features of
    ``external.aneurysm.build_features``."""
    return {
        "dt": 0.01,
        "features": {
            "cells": {"type": "static", "shape": [steps, -1, 3], "dtype": "int32"},
            "mesh_pos": {"type": "static", "shape": [steps, -1, 3], "dtype": "float32"},
            "Vitesse": {"type": "dynamic", "shape": [steps, -1, 3], "dtype": "float32"},
            "wall_mask": {"type": "static", "shape": [steps, -1, 1], "dtype": "float32"},
        },
        "field_names": ["cells", "mesh_pos", "Vitesse", "wall_mask"],
        "trajectory_length": steps,
    }


DEFAULT_ANEURYSM_AMP = (1.0, 0.3, 0.1)


def aneurysm_conditions(num_traj: int, seed: Optional[int] = None) -> List[Tuple[float, np.ndarray]]:
    """The ``(phase0, amp [3])`` of each trajectory of
    ``write_aneurysm_xdmf``: ``(0.1 * k, (1, 0.3, 0.1))`` without a seed,
    else a phase and three amplitude factors in [0.8, 1.2) drawn from
    ``default_rng(seed)`` in trajectory order."""
    base = np.array(DEFAULT_ANEURYSM_AMP, np.float32)
    if seed is None:
        return [(0.1 * k, base) for k in range(num_traj)]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_traj):
        phase0 = float(rng.uniform(0.0, 1.0))
        out.append((phase0, base * rng.uniform(0.8, 1.2, size=3).astype(np.float32)))
    return out


def aneurysm_trajectory(
    steps: int = 9, n: int = 4, phase0: float = 0.0, amp: Optional[Sequence[float]] = None
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """One aneurysm trajectory in memory on ``tet_grid(n)`` shifted to
    x in [-0.5, 0.5] (so the inflow/outflow plane y == 0 exists):
    ``(traj, meta)`` with ``cells [C,4]``, ``mesh_pos [N,3]`` (float32),
    ``Vitesse [T,N,3]`` (a travelling wave of phase ``phase0`` and component
    amplitudes ``amp``, zero on the wall) and ``wall_mask [N]``, the
    x- and z-extreme faces. These are the arrays ``write_aneurysm_xdmf``
    writes for the trajectory."""
    amp = np.asarray(DEFAULT_ANEURYSM_AMP if amp is None else amp, np.float32)
    points, tets = tet_grid(n)
    points = points - np.array([0.5, 0.0, 0.0], np.float32)
    wall = (
        (points[:, 0] == points[:, 0].min())
        | (points[:, 0] == points[:, 0].max())
        | (points[:, 2] == points[:, 2].min())
        | (points[:, 2] == points[:, 2].max())
    ).astype(np.float32)
    vit = []
    for t in range(steps):
        phase = 0.05 * t + phase0
        vit.append(np.stack(
            [
                amp[0] * np.sin(2 * np.pi * (points[:, 0] - phase)),
                amp[1] * np.cos(2 * np.pi * (points[:, 1] - phase)),
                amp[2] * np.sin(2 * np.pi * (points[:, 2] + phase)),
            ],
            axis=1,
        ).astype(np.float32) * (1.0 - wall[:, None]))
    traj = {"cells": tets, "mesh_pos": points, "Vitesse": np.stack(vit), "wall_mask": wall}
    return traj, aneurysm_meta(steps)


def write_aneurysm_xdmf(dirpath: str, num_traj: int = 2, steps: int = 9, n: int = 4,
                        sizes: Optional[Sequence[int]] = None,
                        seed: Optional[int] = None) -> Tuple[str, str]:
    """An aneurysm XDMF folder: ``mesh_{k}.xdmf`` (and its ``.h5``) for each
    trajectory of ``aneurysm_conditions`` (on ``tet_grid(sizes[k])`` where
    ``sizes`` is given, else ``tet_grid(n)``), the frame ``t`` at time
    ``0.01 * t``, and ``meta.json``; returns ``(dirpath, meta_path)``."""
    from graphphysics_torch.utils.xdmf import XdmfTimeSeriesWriter

    os.makedirs(dirpath, exist_ok=True)
    sizes = list(sizes) if sizes is not None else [n] * num_traj
    for k, (nn, (phase0, amp)) in enumerate(zip(sizes, aneurysm_conditions(len(sizes), seed))):
        traj, _ = aneurysm_trajectory(steps, nn, phase0=phase0, amp=amp)
        with XdmfTimeSeriesWriter(os.path.join(dirpath, f"mesh_{k}.xdmf")) as w:
            w.write_points_cells(traj["mesh_pos"].astype(np.float64), traj["cells"],
                                 cell_type="tetra")
            for t in range(steps):
                w.write_data(0.01 * t, {"Vitesse": traj["Vitesse"][t], "wall_mask": traj["wall_mask"]})
    return dirpath, write_json(os.path.join(dirpath, "meta.json"), aneurysm_meta(steps))
