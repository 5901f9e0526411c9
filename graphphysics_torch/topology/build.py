"""Host-side mesh-topology construction (numpy / scipy, and the host C++ of
``graphphysics_torch.native``), the counterpart of
``graphphysics_tpu/topology/build.py``:

- PyG ``T.FaceToEdge`` (undirected, deduplicated edges of each triangle);
- the expansion of tetrahedra into their four triangle faces, and the
  boundary surface of a tetrahedral mesh;
- PyG ``T.Cartesian(norm=False) + T.Distance(norm=False)`` edge features,
  and their world-position twin;
- the k-hop adjacency, the cKDTree world edges
  between obstacle and deformable nodes, and random long-range edges
  (PyG ``add_random_edge(force_undirected=True)``);
- the distance of each node to the nearest node of a type.

``face_to_edge`` and ``k_hop_edges`` run the host C++
(``native.face_to_edge_native``, ``native.k_hop_native``);
``face_to_edge_reference`` and ``k_hop_edges_reference`` are their plain
numpy / scipy versions, which give the same arrays bit for bit and which
the tests hold them to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.spatial import cKDTree

from graphphysics_torch.native import face_to_edge_native, k_hop_native


def unique_pairs(
    senders: np.ndarray, receivers: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct ``(sender, receiver)`` pairs in lexicographic order, as
    int32: the result of ``np.unique(pairs, axis=0)``. Each pair is one
    int64 key ``sender * n + receiver``, whose ascending order is the
    lexicographic order of the pairs."""
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    if not len(s):
        return s.astype(np.int32), r.astype(np.int32)
    n = int(max(s.max(), r.max())) + 1
    key = np.unique(s * n + r)
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def to_undirected(
    senders: np.ndarray, receivers: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Union of both edge directions, without self loops, deduplicated and
    sorted by (sender, receiver)."""
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    keep = s != r
    return unique_pairs(s[keep], r[keep])


def _triangles(faces) -> np.ndarray:
    faces = np.asarray(faces)
    if faces.ndim != 2 or faces.shape[-1] != 3:
        raise ValueError(f"expected [F, 3] triangles, got {faces.shape}")
    return faces


def face_to_edge(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Triangles ``[F, 3]`` -> undirected deduplicated edge list: each
    triangle contributes its three sides in both directions, sorted by
    (sender, receiver), int32. The host C++ builds it (no faces: the plain
    version)."""
    faces = _triangles(faces)
    if not len(faces):
        return face_to_edge_reference(faces)
    return face_to_edge_native(faces, int(faces.max()) + 1)


def face_to_edge_reference(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plain numpy version of ``face_to_edge``."""
    faces = _triangles(faces)
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


def tetra_boundary_faces(tetra: np.ndarray) -> np.ndarray:
    """The boundary surface of a tetrahedral mesh: the triangle faces of
    exactly one tetrahedron, ``[B, 3]`` with the original node ids (an
    interior face belongs to two cells), in the order of their sorted node
    triples."""
    faces = tetra_to_faces(tetra)
    _, idx, counts = np.unique(np.sort(faces, axis=1), axis=0, return_index=True,
                               return_counts=True)
    return faces[idx[counts == 1]]


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


def world_pos_features(
    world_pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    existing: np.ndarray,
) -> np.ndarray:
    """``existing`` edge features with the relative world position
    ``world_pos[senders] - world_pos[receivers]`` and its L2 norm appended."""
    rel = world_pos[senders] - world_pos[receivers]
    nrm = np.linalg.norm(rel, axis=-1, keepdims=True)
    return np.concatenate([existing, rel, nrm], axis=-1).astype(np.float32)


def k_hop_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    num_hops: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The edges of the k-hop adjacency: every pair joined by a walk of at
    most ``num_hops`` edges, without self loops, sorted by (sender,
    receiver), int32; the edges as they are for ``num_hops <= 1``. The host
    C++ builds it: a breadth-first search from each node."""
    if num_hops <= 1:
        return senders.astype(np.int32), receivers.astype(np.int32)
    return k_hop_native(senders, receivers, num_nodes, num_hops)


def k_hop_edges_reference(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    num_hops: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The plain scipy version of ``k_hop_edges``: boolean sparse powers
    ``A_k = A_k + A_k @ A``, the diagonal dropped after each."""
    if num_hops <= 1:
        return senders.astype(np.int32), receivers.astype(np.int32)
    adj = sp.coo_matrix(
        (np.ones(len(senders), dtype=bool), (senders, receivers)), shape=(num_nodes, num_nodes)
    ).tocsr()
    acc = adj.copy()
    for _ in range(num_hops - 1):
        acc = (acc + acc @ adj).astype(bool)
        acc.setdiag(False)
        acc.eliminate_zeros()
    coo = acc.tocoo()
    return unique_pairs(coo.row, coo.col)


def world_edges(
    world_pos: np.ndarray,
    node_type: np.ndarray,
    radius: float,
    obstacle_type: int,
    normal_type: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The pairs ``i < j`` within ``radius`` of each other in world space
    (cKDTree ``query_pairs``) that join an ``obstacle_type`` node and a
    ``normal_type`` node, one direction each: the caller merges them with
    the mesh edges and symmetrizes."""
    pairs = cKDTree(np.asarray(world_pos)).query_pairs(radius, output_type="ndarray")
    if len(pairs) == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    t0, t1 = node_type[pairs[:, 0]], node_type[pairs[:, 1]]
    keep = ((t0 == obstacle_type) & (t1 == normal_type)) | (
        (t0 == normal_type) & (t1 == obstacle_type)
    )
    pairs = pairs[keep]
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


def add_random_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    ratio: float,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """The edges with ``round(ratio * E / 2)`` random node pairs added in
    both directions (pairs that are self loops dropped), deduplicated and
    sorted by (sender, receiver); unchanged unless ``0 < ratio <= 1``. The
    senders are drawn first, then the receivers, from ``rng``."""
    if ratio <= 0.0 or ratio > 1.0:
        return senders, receivers
    num_new = int(round(ratio * len(senders) / 2))
    if num_new == 0:
        return senders, receivers
    s_new = rng.integers(0, num_nodes, size=num_new)
    r_new = rng.integers(0, num_nodes, size=num_new)
    keep = s_new != r_new
    s = np.concatenate([senders, s_new[keep], r_new[keep]])
    r = np.concatenate([receivers, r_new[keep], s_new[keep]])
    return unique_pairs(s, r)


def min_distance_to_type(
    pos: np.ndarray, node_type: np.ndarray, target_type: int
) -> np.ndarray:
    """Each node's distance to the nearest node of ``target_type`` (a
    cKDTree query), float32; infinite where the mesh has no such node."""
    targets = pos[node_type == target_type]
    if len(targets) == 0:
        return np.full(len(pos), np.inf, np.float32)
    d, _ = cKDTree(targets).query(pos, k=1)
    return d.astype(np.float32)
