"""Host-side preprocessing pipeline (counterpart of
``graphphysics_tpu/dataset/preprocessing.py``) for the steps that training
and prediction run on a mesh dataset: FaceToEdge, the Cartesian + Distance
edge features, the training noise and the hooks of dataset-specific
features (``graphphysics_torch/external``). World-position features and the other
transforms come with later slices. Randomness comes from the
``numpy.random.Generator`` each step is handed, drawn in the JAX package's
order, so the same generator gives the same noise."""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from graphphysics_torch.core.nodetype import NodeType
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


def add_noise(
    sample: RawSample,
    rng: np.random.Generator,
    noise_index_start: Union[int, Sequence[int]],
    noise_index_end: Union[int, Sequence[int]],
    noise_scale: Union[float, Sequence[float]],
    node_type_index: int,
    t: Optional[float] = None,
) -> RawSample:
    """Gaussian training noise on the feature slices
    ``[noise_index_start, noise_index_end)``, zero on every node that is not
    NORMAL; ``t`` selects the cosine curriculum ``10*std*(1+cos(t*pi))``.
    One ``rng.normal`` draw per slice, in slice order."""
    starts = [noise_index_start] if isinstance(noise_index_start, int) else list(noise_index_start)
    ends = [noise_index_end] if isinstance(noise_index_end, int) else list(noise_index_end)
    scales = (
        [noise_scale] * len(starts)
        if isinstance(noise_scale, (int, float))
        else list(noise_scale)
    )
    if len(starts) != len(ends) or len(scales) != len(starts):
        raise ValueError("noise index/scale lists must have equal length")

    non_normal = sample.x[:, node_type_index] != NodeType.NORMAL
    for start, end, scale in zip(starts, ends, scales):
        scale_ = 10 * scale * (1 + math.cos(t * math.pi)) if t is not None else scale
        noise = rng.normal(size=sample.x[:, start:end].shape).astype(sample.x.dtype) * scale_
        noise[non_normal] = 0
        sample.x[:, start:end] += noise
    return sample


def build_preprocessing(
    noise_parameters: Optional[dict] = None,
    add_edges_features: bool = True,
    extra_node_features: Optional[Union[Transform, List[Transform]]] = None,
) -> "Pipeline":
    """The pipeline of a dataset without world-position parameters, in the
    JAX package's order: the ``extra_node_features`` hooks (one transform
    or a list), FaceToEdge, then the edge features unless
    ``add_edges_features`` is false (a model without edge inputs).
    ``noise_parameters`` (``noise_index_start``, ``noise_index_end``,
    ``noise_scale``, ``node_type_index``) inserts ``add_noise`` at position
    1, after the first step."""
    hooks = extra_node_features if extra_node_features is not None else []
    steps: List[Transform] = list(hooks) if isinstance(hooks, list) else [hooks]
    steps.append(apply_face_to_edge)
    if add_edges_features:
        steps.append(add_edge_features)
    if noise_parameters is not None:
        steps.insert(
            1,
            partial(
                add_noise,
                noise_index_start=noise_parameters["noise_index_start"],
                noise_index_end=noise_parameters["noise_index_end"],
                noise_scale=noise_parameters["noise_scale"],
                node_type_index=noise_parameters["node_type_index"],
            ),
        )
    return Pipeline(steps)


class Pipeline:
    """Composition of transforms applied in order."""

    def __init__(self, steps: List[Transform]):
        self.steps = steps

    def __call__(self, sample: RawSample, rng: np.random.Generator) -> RawSample:
        for step in self.steps:
            sample = step(sample, rng)
        return sample
