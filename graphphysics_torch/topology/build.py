"""Host-side mesh-topology construction (numpy), the counterpart of
``graphphysics_tpu/topology/build.py`` for triangle and tetrahedral meshes:

- PyG ``T.FaceToEdge`` (undirected, deduplicated edges of each triangle);
- the expansion of tetrahedra into their four triangle faces;
- PyG ``T.Cartesian(norm=False) + T.Distance(norm=False)`` edge features.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def to_undirected(
    senders: np.ndarray, receivers: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Union of both edge directions, without self loops, deduplicated and
    sorted by (sender, receiver). The pairs are deduplicated as one int64
    key ``sender * n + receiver`` each, whose ascending order is the
    lexicographic order of the pairs: the result of ``np.unique(pairs,
    axis=0)`` without its row sort."""
    s = np.concatenate([senders, receivers]).astype(np.int64)
    r = np.concatenate([receivers, senders]).astype(np.int64)
    keep = s != r
    s, r = s[keep], r[keep]
    if not len(s):
        return s.astype(np.int32), r.astype(np.int32)
    n = int(max(s.max(), r.max())) + 1
    key = np.unique(s * n + r)
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def face_to_edge(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Triangles ``[F, 3]`` -> undirected deduplicated edge list: each
    triangle contributes its three sides in both directions."""
    faces = np.asarray(faces)
    if faces.ndim != 2 or faces.shape[-1] != 3:
        raise ValueError(f"expected [F, 3] triangles, got {faces.shape}")
    s = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 0]])
    r = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 2]])
    return to_undirected(s, r)


def tetra_to_faces(tetra: np.ndarray) -> np.ndarray:
    """Tetrahedra ``[T, 4]`` -> their 4 triangle faces, ``[4T, 3]``: the
    faces (0,1,2) of every tetrahedron, then (1,2,3), (2,3,0) and (3,0,1)."""
    t = np.asarray(tetra)
    if t.ndim != 2 or t.shape[-1] != 4:
        raise ValueError(f"expected [T, 4] tetrahedra, got {t.shape}")
    return np.concatenate(
        [t[:, [0, 1, 2]], t[:, [1, 2, 3]], t[:, [2, 3, 0]], t[:, [3, 0, 1]]], axis=0
    )


def cells_to_edges(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Triangle or tetrahedron cells -> undirected mesh edge list."""
    cells = np.asarray(cells)
    if cells.shape[-1] == 4:
        cells = tetra_to_faces(cells)
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
