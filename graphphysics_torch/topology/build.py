"""Host-side mesh-topology construction (numpy), the counterpart of
``graphphysics_tpu/topology/build.py`` for triangle meshes:

- PyG ``T.FaceToEdge`` (undirected, deduplicated edges of each triangle);
- PyG ``T.Cartesian(norm=False) + T.Distance(norm=False)`` edge features.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def to_undirected(
    senders: np.ndarray, receivers: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Union of both edge directions, without self loops, deduplicated and
    sorted by (sender, receiver)."""
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    keep = s != r
    pairs = np.unique(np.stack([s[keep], r[keep]], axis=1), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


def face_to_edge(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Triangles ``[F, 3]`` -> undirected deduplicated edge list: each
    triangle contributes its three sides in both directions."""
    faces = np.asarray(faces)
    if faces.ndim != 2 or faces.shape[-1] != 3:
        raise ValueError(f"expected [F, 3] triangles, got {faces.shape}")
    s = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 0]])
    r = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 2]])
    return to_undirected(s, r)


def cells_to_edges(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Triangle cells -> undirected mesh edge list (tetrahedra come with a
    later slice of the port)."""
    cells = np.asarray(cells)
    if cells.shape[-1] != 3:
        raise ValueError(f"only triangle cells are supported, got {cells.shape}")
    return face_to_edge(cells)


def cartesian_distance_features(
    pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    existing: Optional[np.ndarray] = None,
) -> np.ndarray:
    """``[E, D+1]`` edge features: ``pos[senders] - pos[receivers]`` and its
    L2 norm, appended to ``existing`` when given."""
    rel = pos[senders] - pos[receivers]
    dist = np.linalg.norm(rel, axis=-1, keepdims=True)
    feats = np.concatenate([rel, dist], axis=-1).astype(np.float32)
    if existing is not None:
        feats = np.concatenate([existing, feats], axis=-1).astype(np.float32)
    return feats
