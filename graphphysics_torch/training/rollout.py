"""Whole-trajectory autoregressive rollout (counterpart of
``graphphysics_tpu/training/rollout.py``). The JAX ``lax.scan`` becomes a
Python loop over frames that stay on the device:

- the first frame is fed its own input, every later frame the previous
  prediction in ``x[:, output_index_start:output_index_end]``, and with
  previous data the difference ``predicted - current_output`` of the frame
  before in ``x[:, previous_data_start:previous_data_end]``;
- boundary clamping ``predicted[mask] = y[mask]`` with
  ``mask = NOT(NORMAL | OUTFLOW)``.

``stacked_trajectory`` builds the ``[T, ...]`` frames a trajectory reaches
``rollout`` as, like the JAX ``Trainer._stacked_trajectory``, in the edge
layout of the model's kernel: receiver-sorted for EncodeProcessDecode,
sender-sorted (CSR) for EncodeTransformDecode.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from graphphysics_torch.core.device import DeviceLike, resolve_device
from graphphysics_torch.core.graph import (
    Graph,
    pad_graph_csr_np,
    pad_graph_sorted_np,
    stack_graphs,
)
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.dataset.h5_dataset import frame_to_sample

# edge layouts of stacked_trajectory: each names its padding
LAYOUTS = {"sorted": pad_graph_sorted_np, "csr": pad_graph_csr_np}


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
    layout: str = "sorted",
) -> Graph:
    """Every usable frame of ``traj`` (each with the next frame as target),
    preprocessed, padded to ``(n_pad, e_pad)`` and stacked into one host
    Graph with a leading ``[T - 1]`` axis. ``layout`` "sorted" sorts edges
    by receiver (``pad_graph_sorted_np``, ``row_bounds``: EncodeProcessDecode),
    "csr" by sender (``pad_graph_csr_np``, ``sender_bounds``:
    EncodeTransformDecode)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {sorted(LAYOUTS)}")
    pad = LAYOUTS[layout]
    frames = []
    for frame in range(meta["trajectory_length"] - 1):
        sample = frame_to_sample(traj, frame, meta, frame_target=frame + 1)
        sample = preprocessing(sample, np.random.default_rng(frame))
        frames.append(
            pad(
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
    sim,
    frames: Graph,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
    use_previous_data: bool = False,
    previous_data_start: Optional[int] = None,
    previous_data_end: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autoregressive rollout of ``sim`` over stacked trajectory frames
    (leaves ``[T, ...]``), on ``device`` (``cuda`` unless named). Every
    output column ``output_index_start:output_index_end`` is fed back, also
    those the model does not read as features (panels: outputs 0:3,
    features 0:2). With ``use_previous_data`` the columns
    ``previous_data_start:previous_data_end`` (as wide as the output) are
    fed too: their own value on the first frame, then the last prediction
    minus the output columns it was predicted from. A GMM head samples each
    frame from ``generator``, in frame order (required for K > 0; its
    device may differ from ``device``).

    Returns ``(predictions [T, N, d], targets [T, N, d])`` on the device,
    with boundary-clamped predictions."""
    dev = resolve_device(device)
    param = next(sim.parameters())
    if param.device.type != dev.type:
        raise ValueError(f"simulator is on {param.device}, rollout asked for {dev}")
    cfg = sim.config
    os_, oe = cfg.output_index_start, cfg.output_index_end
    ps, pe = previous_data_start, previous_data_end
    if use_previous_data and (ps is None or pe is None or pe - ps != oe - os_):
        raise ValueError(
            f"previous_data_start:previous_data_end ({ps}:{pe}) must be as wide as the "
            f"output ({os_}:{oe})"
        )
    with torch.inference_mode():
        return rollout_frames(sim, frames.to(dev), generator=generator,
                              use_previous_data=use_previous_data,
                              previous_data_start=ps, previous_data_end=pe)


def rollout_frames(
    sim,
    frames: Graph,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_previous_data: bool = False,
    previous_data_start: Optional[int] = None,
    previous_data_end: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loop of ``rollout`` over frames already on the simulator's
    device, unchecked and under the caller's grad mode (what
    ``utils.export.export_rollout`` traces, unrolled). A GMM head samples
    frame ``t`` from ``generator`` or from ``draws`` (``(gumbel [T, N, K],
    z [T, N, d])``, frame ``t`` taking row ``t``)."""
    cfg = sim.config
    os_, oe = cfg.output_index_start, cfg.output_index_end
    ps, pe = previous_data_start, previous_data_end
    predictions, targets = [], []
    predicted = previous = None
    for t in range(frames.x.shape[0]):
        g = frames[t]
        if predicted is not None:
            x = g.x.clone()
            x[:, os_:oe] = predicted
            if use_previous_data:
                x[:, ps:pe] = previous
            g = g.replace(x=x)
        mask = build_mask(g.x[:, cfg.node_type_index].to(torch.int64))
        current_output = g.x[:, os_:oe]
        frame_draws = None if draws is None else (draws[0][t], draws[1][t])
        _, _, predicted = sim(g, generator=generator, draws=frame_draws)
        predicted = torch.where(mask[:, None], g.y, predicted)
        if use_previous_data:
            previous = predicted - current_output
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
