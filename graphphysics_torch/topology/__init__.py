from graphphysics_torch.topology.build import (
    add_random_edges,
    cartesian_distance_features,
    cells_to_edges,
    face_to_edge,
    k_hop_edges,
    min_distance_to_type,
    tetra_boundary_faces,
    tetra_to_faces,
    to_undirected,
    unique_pairs,
    world_edges,
    world_pos_features,
)
from graphphysics_torch.topology.ell import EllLayout, build_ell, max_in_degree

__all__ = [
    "EllLayout",
    "add_random_edges",
    "build_ell",
    "cartesian_distance_features",
    "cells_to_edges",
    "face_to_edge",
    "k_hop_edges",
    "max_in_degree",
    "min_distance_to_type",
    "tetra_boundary_faces",
    "tetra_to_faces",
    "to_undirected",
    "unique_pairs",
    "world_edges",
    "world_pos_features",
]
