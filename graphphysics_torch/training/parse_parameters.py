"""Config parsing and factories for the reference JSON training-config schema
(counterpart of ``graphphysics_tpu/training/parse_parameters.py``):
``get_preprocessing``, ``get_model``, ``get_simulator_config`` and
``get_simulator`` for the configurations the port serves today, float32
with the plain (K = 0) decoder. A key that asks for more raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from graphphysics_torch.core.device import DeviceLike
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.dataset.preprocessing import Pipeline, build_preprocessing
from graphphysics_torch.models.processors import EncodeProcessDecode, EncodeTransformDecode
from graphphysics_torch.models.simulator import Simulator, SimulatorConfig


def _waits(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md section 1, {item})")


def get_preprocessing(
    param: Dict[str, Any], use_edge_feature: bool = True, remove_noise: bool = False
) -> Pipeline:
    """The preprocessing pipeline of ``param``: FaceToEdge, plus the edge
    features when ``use_edge_feature``. Prediction passes
    ``remove_noise=True``; training noise and world-position edges wait."""
    pre = param.get("transformations", {}).get("preprocessing", {})
    if pre.get("noise", 0) != 0 and not remove_noise:
        raise _waits("training noise", "item 3, host data")
    if param.get("transformations", {}).get("world_pos_parameters", {}).get("use", False):
        raise _waits("world-position edges", "item 3, host data")
    return build_preprocessing(add_edges_features=use_edge_feature)


def get_model(param: Dict[str, Any]) -> nn.Module:
    """The processor of ``param["model"]``: ``"epd"`` or ``"transformer"``,
    with the NodeType one-hot width added to ``node_input_size``."""
    model = param["model"]
    if model.get("num_mixture_components", 0):
        raise _waits("the GMM heads (num_mixture_components > 0)", "item 9, GMM")
    if model.get("precision", "f32") not in ("f32", "float32"):
        raise _waits(f"precision {model['precision']!r}", "item 11, training features")
    for knob in ("remat", "scan_blocks"):
        if model.get(knob, False):
            raise _waits(f"{knob!r}", "item 11, training features")
    node_input_size = model["node_input_size"] + int(NodeType.SIZE)
    if model.get("type") == "epd":
        return EncodeProcessDecode(
            model["message_passing_num"],
            node_input_size,
            model["edge_input_size"],
            model["output_size"],
            model["hidden_size"],
        )
    if model.get("type") == "transformer":
        return EncodeTransformDecode(
            model["message_passing_num"],
            node_input_size,
            model["output_size"],
            model["hidden_size"],
            model["num_heads"],
        )
    raise ValueError(f"Model type {model.get('type')!r} not supported.")


def get_simulator_config(param: Dict[str, Any]) -> SimulatorConfig:
    index = param["index"]
    return SimulatorConfig(
        node_input_size=param["model"]["node_input_size"] + int(NodeType.SIZE),
        edge_input_size=param["model"]["edge_input_size"],
        output_size=param["model"]["output_size"],
        feature_index_start=index["feature_index_start"],
        feature_index_end=index["feature_index_end"],
        output_index_start=index["output_index_start"],
        output_index_end=index["output_index_end"],
        node_type_index=index["node_type_index"],
    )


def get_simulator(param: Dict[str, Any], device: DeviceLike = None) -> Simulator:
    """The Simulator of ``param`` on ``device`` (``cuda`` unless named)."""
    return Simulator(get_simulator_config(param), get_model(param), device=device)
