"""Whole-trajectory autoregressive rollout (counterpart of
``graphphysics_tpu/training/rollout.py``). The JAX ``lax.scan`` becomes a
Python loop over frames that stay on the device:

- the first frame is fed its own input, every later frame the previous
  prediction in ``x[:, output_index_start:output_index_end]``;
- boundary clamping ``predicted[mask] = y[mask]`` with
  ``mask = NOT(NORMAL | OUTFLOW)``.

``stacked_trajectory`` builds the ``[T, ...]`` frames a trajectory reaches
``rollout`` as, like the JAX ``Trainer._stacked_trajectory``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from graphphysics_torch.core.device import DeviceLike, resolve_device
from graphphysics_torch.core.graph import Graph, pad_graph_sorted_np, stack_graphs
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.dataset.h5_dataset import frame_to_sample


def build_mask(node_type: torch.Tensor) -> torch.Tensor:
    """True for nodes whose prediction is clamped to ground truth
    (NOT NORMAL and NOT OUTFLOW)."""
    keep = (node_type == int(NodeType.NORMAL)) | (node_type == int(NodeType.OUTFLOW))
    return ~keep


def stacked_trajectory(
    traj: Dict[str, np.ndarray],
    meta: Dict[str, Any],
    n_pad: int,
    e_pad: int,
    node_type_index: int,
    preprocessing: Callable,
) -> Graph:
    """Every usable frame of ``traj`` (each with the next frame as target),
    preprocessed, padded receiver-sorted to ``(n_pad, e_pad)`` and stacked
    into one host Graph with a leading ``[T - 1]`` axis."""
    frames = []
    for frame in range(meta["trajectory_length"] - 1):
        sample = frame_to_sample(traj, frame, meta, frame_target=frame + 1)
        sample = preprocessing(sample, np.random.default_rng(frame))
        frames.append(
            pad_graph_sorted_np(
                sample.x,
                sample.pos,
                sample.senders,
                sample.receivers,
                n_pad,
                e_pad,
                edge_attr=sample.edge_attr,
                y=sample.y,
                node_type_index=node_type_index,
            )
        )
    return stack_graphs(frames)


def rollout(
    sim, frames: Graph, device: DeviceLike = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive rollout of ``sim`` over stacked trajectory frames
    (leaves ``[T, ...]``), on ``device`` (``cuda`` unless named).

    Returns ``(predictions [T, N, d], targets [T, N, d])`` on the device,
    with boundary-clamped predictions."""
    dev = resolve_device(device)
    param = next(sim.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"simulator is on {param.device}, rollout asked for {dev}")
    cfg = sim.config
    os_, oe = cfg.output_index_start, cfg.output_index_end
    frames = frames.to(dev)
    predictions, targets = [], []
    predicted = None
    with torch.inference_mode():
        for t in range(frames.x.shape[0]):
            g = frames[t]
            if predicted is not None:
                x = g.x.clone()
                x[:, os_:oe] = predicted
                g = g.replace(x=x)
            mask = build_mask(g.x[:, cfg.node_type_index].to(torch.int64))
            _, _, predicted = sim(g)
            predicted = torch.where(mask[:, None], g.y, predicted)
            predictions.append(predicted)
            targets.append(g.y)
    return torch.stack(predictions), torch.stack(targets)


def rollout_rmse(
    predictions: torch.Tensor, targets: torch.Tensor, node_mask: torch.Tensor
) -> torch.Tensor:
    """All-rollout RMSE over valid nodes."""
    w = node_mask.to(predictions.dtype)[None, :, None]
    se = (predictions - targets) ** 2 * w
    denom = torch.clamp(w.sum() * predictions.shape[0] * predictions.shape[-1], min=1.0)
    return torch.sqrt(se.sum() / denom)
