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

__all__ = [
    "add_random_edges",
    "cartesian_distance_features",
    "cells_to_edges",
    "face_to_edge",
    "k_hop_edges",
    "min_distance_to_type",
    "tetra_boundary_faces",
    "tetra_to_faces",
    "to_undirected",
    "unique_pairs",
    "world_edges",
    "world_pos_features",
]
