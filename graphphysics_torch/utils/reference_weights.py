"""Load reference-format checkpoints into the port's ``Simulator``.

The format is the reference ``Simulator.save_checkpoint`` dict:

    {"model": <state_dict, model.* keys>,
     "_output_normalizer": {"_acc_count", "_num_accumulations", "_acc_sum",
                            "_acc_sum_squared", ...},
     "_node_normalizer": {...},
     "_edge_normalizer": {...} or None}

with tensors or numpy arrays as values (the JAX package's
``export_reference_checkpoint`` writes numpy arrays), or a ``torch.save`` file
of it. The port's module tree carries the reference names, so the weights
load with ``load_state_dict(strict=True)``: EncodeProcessDecode's
``processor_list.{i}.edge_block|node_block`` keys as well as
EncodeTransformDecode's ``processor_list.{i}.attention|norm1|norm2|gated_mlp``
ones. A model without edge features has no edge normalizer, and its
checkpoint carries ``"_edge_normalizer": None``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from graphphysics_torch.models.simulator import Simulator

_NORMALIZERS = ("_output_normalizer", "_node_normalizer", "_edge_normalizer")
_STATS = ("_acc_count", "_num_accumulations", "_acc_sum", "_acc_sum_squared")


def _tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.tensor(np.asarray(value, dtype=np.float32))


def load_reference_checkpoint(
    sim: Simulator, checkpoint: Union[str, os.PathLike, Mapping[str, Any]]
) -> Simulator:
    """Load ``checkpoint`` (a dict or a path to a ``torch.save`` file of one)
    into ``sim`` in place and return it. Raises on any missing, unexpected or
    mis-shaped key; a normalizer that is None or absent in the checkpoint
    loads nothing, so strict loading then fails unless ``sim`` has none
    either."""
    if isinstance(checkpoint, (str, os.PathLike)):
        checkpoint = torch.load(checkpoint, map_location="cpu", weights_only=True)
    model_sd = checkpoint["model"]
    state: Dict[str, torch.Tensor] = {
        k: _tensor(v) for k, v in model_sd.items() if k.startswith("model.")
    }
    own = sim.state_dict()
    for name in _NORMALIZERS:
        stats = checkpoint.get(name)
        if not stats:
            # the reference also keeps the buffers inside the state_dict
            prefix = f"{name}."
            stats = {k[len(prefix):]: v for k, v in model_sd.items() if k.startswith(prefix)}
        if not stats:
            continue
        for stat in _STATS:
            key = f"{name}.{stat}"
            if key not in own:
                raise ValueError(f"checkpoint has {name} but the model has no {key}")
            value = _tensor(stats[stat])
            if value.numel() != own[key].numel():
                raise ValueError(
                    f"{key}: model {tuple(own[key].shape)} vs checkpoint {tuple(value.shape)}"
                )
            state[key] = value.reshape(own[key].shape)
    sim.load_state_dict(state, strict=True)
    return sim
