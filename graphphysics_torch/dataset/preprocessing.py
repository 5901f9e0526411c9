"""Host-side preprocessing pipeline (counterpart of
``graphphysics_tpu/dataset/preprocessing.py``): FaceToEdge, the Cartesian +
Distance edge features, the training noise, the hooks of dataset-specific
features (``graphphysics_torch/external``), the DeformingPlate steps (the
obstacles' next displacement as an input, world edges between obstacle and
plate, world-position edge features) and the random 3D rotation.
Randomness comes from the ``numpy.random.Generator`` each step is handed,
drawn in the JAX package's order, so the same generator gives the same
noise."""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.dataset.sample import RawSample
from graphphysics_torch.topology import (
    cartesian_distance_features,
    face_to_edge,
    to_undirected,
    world_edges,
    world_pos_features,
)

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


def add_obstacles_next_pos(
    sample: RawSample,
    rng: np.random.Generator,
    world_pos_index_start: int,
    world_pos_index_end: int,
    node_type_index: int,
) -> RawSample:
    """Insert the obstacles' displacement to the next frame (``y``'s world
    position minus ``x``'s) as input columns right after the world position;
    every other node gets the obstacles' mean displacement. ``node_type_index``
    is the node type's column after the insertion, so one past the world
    position reads ``width`` columns further left before it."""
    wps, wpe = world_pos_index_start, world_pos_index_end
    world_pos = sample.x[:, wps:wpe]
    displacement = sample.y[:, wps:wpe] - world_pos
    nt_pre = node_type_index if node_type_index < wpe else node_type_index - (wpe - wps)
    obstacle = sample.x[:, nt_pre] == NodeType.OBSTACLE
    mean_disp = displacement[obstacle].mean(axis=0) if obstacle.any() else 0.0
    displacement = np.where(obstacle[:, None], displacement, mean_disp)
    sample.x = np.concatenate(
        [sample.x[:, :wps], world_pos, displacement, sample.x[:, wpe:]], axis=1
    ).astype(np.float32)
    return sample


def add_world_edges(
    sample: RawSample,
    rng: np.random.Generator,
    world_pos_index_start: int,
    world_pos_index_end: int,
    node_type_index: int,
    radius: float = 0.03,
) -> RawSample:
    """Add the OBSTACLE<->NORMAL pairs within ``radius`` in world space to
    the mesh edges, then symmetrize and deduplicate."""
    ws, wr = world_edges(
        sample.x[:, world_pos_index_start:world_pos_index_end],
        sample.x[:, node_type_index],
        radius,
        obstacle_type=int(NodeType.OBSTACLE),
        normal_type=int(NodeType.NORMAL),
    )
    sample.senders, sample.receivers = to_undirected(
        np.concatenate([ws, sample.senders]), np.concatenate([wr, sample.receivers])
    )
    return sample


def add_world_pos_features(
    sample: RawSample,
    rng: np.random.Generator,
    world_pos_index_start: int,
    world_pos_index_end: int,
) -> RawSample:
    """Append the relative world position and its norm to ``edge_attr``."""
    sample.edge_attr = world_pos_features(
        sample.x[:, world_pos_index_start:world_pos_index_end],
        sample.senders,
        sample.receivers,
        sample.edge_attr,
    )
    return sample


def random_3d_rotate(
    sample: RawSample,
    rng: np.random.Generator,
    feature_indices: Optional[List[Tuple[int, int]]] = None,
    angles: Optional[Tuple[float, float, float]] = None,
) -> RawSample:
    """Rotate ``pos``, the 3-column feature slices ``feature_indices`` and
    the first 3 target columns by one random rotation (row vectors times
    the reference's matrix). ``angles`` (alpha, beta, gamma) pins it; else
    they are drawn from ``rng`` in [-pi, pi)."""
    feature_indices = feature_indices or []
    for s, e in feature_indices:
        if e - s != 3:
            raise ValueError("each rotated feature range must span 3 columns")
    alpha, beta, gamma = angles if angles is not None else rng.uniform(-math.pi, math.pi, size=3)
    ca, sa = math.cos(alpha), math.sin(alpha)
    cb, sb = math.cos(beta), math.sin(beta)
    cg, sg = math.cos(gamma), math.sin(gamma)
    m = np.array(
        [
            [ca * cb, ca * sb * sg + sa * cg, -ca * sb * cg + sa * sg],
            [-sa * cb, -sa * sb * sg + ca * cg, sa * sb * cg + ca * sg],
            [sb, -cb * sg, cb * cg],
        ],
        np.float32,
    )
    if sample.pos is not None:
        if sample.pos.shape[-1] != 3:
            raise ValueError("positions must be 3D for random_3d_rotate")
        sample.pos = sample.pos @ m
    for s, e in feature_indices:
        sample.x[:, s:e] = sample.x[:, s:e] @ m
    if sample.y is not None:
        if sample.y.shape[-1] < 3:
            raise ValueError(
                f"random_3d_rotate rotates the first 3 target columns; y has only "
                f"{sample.y.shape[-1]}"
            )
        sample.y[:, 0:3] = sample.y[:, 0:3] @ m
    return sample


def _as_list(hooks: Optional[Union[Transform, List[Transform]]]) -> List[Transform]:
    if hooks is None:
        return []
    return list(hooks) if isinstance(hooks, list) else [hooks]


def build_preprocessing(
    noise_parameters: Optional[dict] = None,
    world_pos_parameters: Optional[dict] = None,
    add_edges_features: bool = True,
    extra_node_features: Optional[Union[Transform, List[Transform]]] = None,
    extra_edge_features: Optional[Union[Transform, List[Transform]]] = None,
) -> "Pipeline":
    """The pipeline in the JAX package's order: the ``extra_node_features``
    hooks (one transform or a list); then, with ``world_pos_parameters``
    (``world_pos_index_start``, ``world_pos_index_end``,
    ``node_type_index``, optional ``radius``, default 0.03), the obstacles'
    next displacement, FaceToEdge, the world edges, the edge features and
    the world-position edge features; without them FaceToEdge and the edge
    features unless ``add_edges_features`` is false (a model without edge
    inputs). ``noise_parameters`` (``noise_index_start``,
    ``noise_index_end``, ``noise_scale``, ``node_type_index``) inserts
    ``add_noise`` at position 1, after the first step; the
    ``extra_edge_features`` hooks come last."""
    steps: List[Transform] = _as_list(extra_node_features)
    if world_pos_parameters is not None:
        wps = world_pos_parameters["world_pos_index_start"]
        wpe = world_pos_parameters["world_pos_index_end"]
        nti = world_pos_parameters["node_type_index"]
        steps += [
            partial(add_obstacles_next_pos, world_pos_index_start=wps, world_pos_index_end=wpe,
                    node_type_index=nti),
            apply_face_to_edge,
            partial(add_world_edges, world_pos_index_start=wps, world_pos_index_end=wpe,
                    node_type_index=nti, radius=world_pos_parameters.get("radius", 0.03)),
            add_edge_features,
            partial(add_world_pos_features, world_pos_index_start=wps, world_pos_index_end=wpe),
        ]
    else:
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
    steps += _as_list(extra_edge_features)
    return Pipeline(steps)


class Pipeline:
    """Composition of transforms applied in order. It pickles (partials of
    module-level functions), so a dataset that holds one crosses into the
    loader's worker processes."""

    def __init__(self, steps: List[Transform]):
        self.steps = steps

    def __call__(self, sample: RawSample, rng: np.random.Generator) -> RawSample:
        for step in self.steps:
            sample = step(sample, rng)
        return sample
