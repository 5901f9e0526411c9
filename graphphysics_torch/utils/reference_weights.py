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
checkpoint carries ``"_edge_normalizer": None``. Reference tensors in a
16-bit dtype load as float32: the port's parameters are float32 whatever
the model's compute precision.

The JAX package's ``scan_blocks`` models keep their blocks' parameters
stacked (``blocks/block/...`` with a leading ``[L]`` axis);
``unstack_scanned_blocks`` turns such a parameter tree into the unrolled
``block_{i}`` one, which the JAX ``export_reference_state_dict`` maps onto
``processor_list.{i}``.
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


def unstack_scanned_blocks(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A flax parameter tree with a scanned block stack (``blocks`` ->
    ``block`` -> leaves with a leading ``[L]`` axis), at its top or under
    ``model``, as the unrolled tree (``block_0`` ... ``block_{L-1}``, each
    leaf its slice as a numpy array); other entries pass through and a tree
    without ``blocks`` comes back as it is. Numpy only."""
    params = dict(params)
    if "model" in params and "blocks" not in params:
        params["model"] = unstack_scanned_blocks(params["model"])
        return params
    if "blocks" not in params:
        return params
    stacked = params.pop("blocks")["block"]

    def depth(tree):
        return depth(next(iter(tree.values()))) if isinstance(tree, Mapping) else np.shape(tree)[0]

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for i in range(depth(stacked)):
        params[f"block_{i}"] = take(stacked, i)
    return params


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
