from graphphysics_torch.topology.build import (
    cartesian_distance_features,
    cells_to_edges,
    face_to_edge,
    tetra_to_faces,
    to_undirected,
)

__all__ = [
    "cartesian_distance_features",
    "cells_to_edges",
    "face_to_edge",
    "tetra_to_faces",
    "to_undirected",
]
