"""Host-side preprocessing pipeline (counterpart of
``graphphysics_tpu/dataset/preprocessing.py``) for the steps that prediction
runs on a mesh dataset: FaceToEdge and the Cartesian + Distance edge
features. Prediction builds the pipeline without training noise; noise,
world-position features and the other transforms come with later slices."""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from graphphysics_torch.dataset.sample import RawSample
from graphphysics_torch.topology import cartesian_distance_features, face_to_edge

# A transform takes (sample, rng) and mutates/returns the sample.
Transform = Callable[[RawSample, np.random.Generator], RawSample]


def apply_face_to_edge(sample: RawSample, rng: np.random.Generator) -> RawSample:
    """PyG ``T.FaceToEdge(remove_faces=False)`` analog."""
    sample.senders, sample.receivers = face_to_edge(sample.faces)
    return sample


def add_edge_features(sample: RawSample, rng: np.random.Generator) -> RawSample:
    """``T.Cartesian(norm=False) + T.Distance(norm=False)``: relative mesh
    position + L2 norm."""
    sample.edge_attr = cartesian_distance_features(
        sample.pos, sample.senders, sample.receivers, existing=sample.edge_attr
    )
    return sample


def build_preprocessing(add_edges_features: bool = True) -> "Pipeline":
    """FaceToEdge, then the edge features unless ``add_edges_features`` is
    false (a model without edge inputs): the pipeline of a dataset without
    world-position parameters, with noise removed."""
    steps: List[Transform] = [apply_face_to_edge]
    if add_edges_features:
        steps.append(add_edge_features)
    return Pipeline(steps)


class Pipeline:
    """Composition of transforms applied in order."""

    def __init__(self, steps: List[Transform]):
        self.steps = steps

    def __call__(self, sample: RawSample, rng: np.random.Generator) -> RawSample:
        for step in self.steps:
            sample = step(sample, rng)
        return sample
