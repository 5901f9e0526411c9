"""Config parsing and factories for the reference JSON training-config schema
(counterpart of ``graphphysics_tpu/training/parse_parameters.py``):
``get_preprocessing``, ``get_model``, ``get_simulator_config``,
``get_simulator``, ``edge_layout`` and ``get_dataset`` for the
configurations the port trains and serves today: float32 or bfloat16
compute, rematerialized and scanned blocks, the plain (K = 0) decoder or a
GMM head, h5 and XDMF datasets, previous-frame data, the dataset-specific
feature hooks, world-position edges, k-hop and random edges, node
masking, size buckets (``num_buckets``, ``bucket_multiple``) and the
model's sorted, CSR or ELL edge layout.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch
from torch import nn

from graphphysics_torch.core.device import DeviceLike
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.dataset.dataset import BaseDataset
from graphphysics_torch.dataset.h5_dataset import H5Dataset
from graphphysics_torch.dataset.preprocessing import Pipeline, build_preprocessing
from graphphysics_torch.dataset.xdmf_dataset import XDMFDataset
from graphphysics_torch.models.processors import EncodeProcessDecode, EncodeTransformDecode
from graphphysics_torch.models.simulator import Simulator, SimulatorConfig


def get_preprocessing(
    param: Dict[str, Any],
    use_edge_feature: bool = True,
    remove_noise: bool = False,
    extra_node_features: Optional[Union[Callable, List[Callable]]] = None,
) -> Pipeline:
    """The preprocessing pipeline of ``param`` (``build_preprocessing``):
    the ``extra_node_features`` hooks (``graphphysics_torch.external``);
    with ``transformations.world_pos_parameters.use`` the world-position
    steps (its ``radius`` where the config gives one), else FaceToEdge and
    the edge features when ``use_edge_feature``; the training noise of
    ``transformations.preprocessing`` unless ``remove_noise`` (prediction
    and validation) or its scale is 0."""
    pre = param.get("transformations", {}).get("preprocessing", {})
    noise_scale = pre.get("noise", 0)
    noise_parameters = None
    if noise_scale != 0 and not remove_noise:
        noise_parameters = {
            "noise_index_start": pre.get("noise_index_start"),
            "noise_index_end": pre.get("noise_index_end"),
            "noise_scale": noise_scale,
            "node_type_index": param["index"]["node_type_index"],
        }
    world_pos = param.get("transformations", {}).get("world_pos_parameters", {})
    world_pos_parameters = None
    if world_pos.get("use", False):
        world_pos_parameters = {
            "world_pos_index_start": world_pos.get("world_pos_index_start"),
            "world_pos_index_end": world_pos.get("world_pos_index_end"),
            "node_type_index": param["index"]["node_type_index"],
        }
        if "radius" in world_pos:
            world_pos_parameters["radius"] = world_pos["radius"]
    return build_preprocessing(
        noise_parameters=noise_parameters,
        world_pos_parameters=world_pos_parameters,
        add_edges_features=use_edge_feature,
        extra_node_features=extra_node_features,
    )


def gmm_options(param: Dict[str, Any]) -> Dict[str, Any]:
    """The decoder's GMM keys of ``param["model"]``:
    ``num_mixture_components`` (0: the plain decoder), ``temperature`` (kept
    as given; None reads as 1.0 where it is used, and 0.0 is valid) and
    ``use_diagonal`` (default true; false takes the full-covariance head and
    NLL)."""
    model = param["model"]
    return {
        "num_mixture_components": int(model.get("num_mixture_components", 0)),
        "temperature": model.get("temperature"),
        "use_diagonal": bool(model.get("use_diagonal", True)),
    }


# the compute dtype of each "precision" (None: float32), as the JAX get_model
PRECISIONS = {"f32": None, "float32": None, "bf16": torch.bfloat16, "bfloat16": torch.bfloat16}


def model_options(param: Dict[str, Any]) -> Dict[str, Any]:
    """The model's precision and memory keys of ``param["model"]``:
    ``precision`` (default "f32") as the compute ``dtype``, an unknown one
    raising ``KeyError`` as the JAX dict lookup does; ``remat`` and
    ``scan_blocks`` (default false)."""
    model = param["model"]
    return {
        "dtype": PRECISIONS[model.get("precision", "f32")],
        "remat": bool(model.get("remat", False)),
        "scan_blocks": bool(model.get("scan_blocks", False)),
    }


def get_model(param: Dict[str, Any]) -> nn.Module:
    """The processor of ``param["model"]``: ``"epd"`` or ``"transformer"``,
    with the NodeType one-hot width added to ``node_input_size``, the
    decoder of ``gmm_options`` and the knobs of ``model_options``. Two keys
    reach layer knobs the JAX ``get_model`` leaves at their defaults:
    ``"project_before_gather"`` (EPD, default false) and
    ``"use_proj_bias"`` (transformer, default true)."""
    model = param["model"]
    knobs = model_options(param)
    node_input_size = model["node_input_size"] + int(NodeType.SIZE)
    if model.get("type") == "epd":
        return EncodeProcessDecode(
            model["message_passing_num"],
            node_input_size,
            model["edge_input_size"],
            model["output_size"],
            model["hidden_size"],
            **gmm_options(param),
            **knobs,
            project_before_gather=bool(model.get("project_before_gather", False)),
        )
    if model.get("type") == "transformer":
        return EncodeTransformDecode(
            model["message_passing_num"],
            node_input_size,
            model["output_size"],
            model["hidden_size"],
            model["num_heads"],
            **gmm_options(param),
            **knobs,
            use_proj_bias=bool(model.get("use_proj_bias", True)),
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


# the edge layout of each model family: the one its kernel reads
MODEL_EDGE_LAYOUTS = {"epd": "sorted", "transformer": "csr"}


def edge_layout(param: Dict[str, Any], wanted: Optional[str] = None) -> str:
    """The dataset edge layout for ``param``: receiver-sorted (``"sorted"``)
    for EncodeProcessDecode, sender-sorted (``"csr"``) for
    EncodeTransformDecode, as ``stacked_trajectory`` lays them out. The
    layout asked for (``wanted``, else the config's ``dataset.edge_layout``)
    "auto", "coo" (the JAX default, the same edges unsorted) or absent
    resolves to that; "csr" is taken by the transformer only, whose kernel it
    is; "ell" is taken by both families (the dense ELL ops)."""
    model_type = param["model"].get("type")
    if model_type not in MODEL_EDGE_LAYOUTS:
        raise ValueError(f"Model type {model_type!r} not supported.")
    if wanted is None:
        wanted = param.get("dataset", {}).get("edge_layout")
    wanted = wanted or "auto"
    layout = MODEL_EDGE_LAYOUTS[model_type]
    if wanted == "ell":
        return "ell"
    if wanted in ("auto", "coo") or wanted == layout:
        return layout
    raise ValueError(
        f"edge_layout {wanted!r} does not fit model type {model_type!r}: its kernel "
        f"reads the {layout!r} layout"
    )


# get_dataset's keyword of the same name shadows it there
_edge_layout = edge_layout


def get_dataset(
    param: Dict[str, Any],
    preprocessing,
    masking_ratio: Optional[float] = None,
    use_edge_feature: bool = True,
    use_previous_data: bool = False,
    switch_to_val: bool = False,
    edge_layout: Optional[str] = None,
    **budget_kwargs,
) -> BaseDataset:
    """The dataset of ``param["dataset"]``: an ``H5Dataset`` (``extension``
    "h5", ``h5_path``) or an ``XDMFDataset`` ("xdmf", ``xdmf_folder`` with
    the config's ``random_prev``, ``random_next`` and ``dt_features``), in
    the model's edge layout (``edge_layout``, which a layout asked for here
    must resolve to), with the config's ``num_buckets``, ``bucket_multiple``
    and ``edge_headroom`` (each passed on unless absent or null, so a 0
    reaches the dataset's check, as in the JAX package); ``budget_kwargs``
    override them and may give ``node_budget``, ``edge_budget``,
    ``ell_degree`` and ``seed``. ``use_previous_data``
    gives every item the frame before it; ``masking_ratio`` marks that share
    of each item's nodes ``exclude_mask``. The config's ``khop`` and
    ``new_edges_ratio`` reach the dataset, and its world-position
    parameters reach an h5 dataset with ``khop > 1`` (whose k-hop edge
    features include them); the XDMF dataset never takes them."""
    dataset_params = param.get("dataset", {})
    extension = dataset_params.get("extension", "")
    if extension not in ("h5", "xdmf"):
        raise ValueError(f"Dataset extension {extension!r} not supported.")
    for k in ("num_buckets", "bucket_multiple", "edge_headroom"):
        if k not in budget_kwargs and dataset_params.get(k) is not None:
            budget_kwargs[k] = dataset_params[k]
    khop = dataset_params.get("khop", 1)
    common = dict(
        meta_path=dataset_params["meta_path"],
        switch_to_val=switch_to_val,
        preprocessing=preprocessing,
        masking_ratio=masking_ratio,
        khop=khop,
        new_edges_ratio=dataset_params.get("new_edges_ratio", 0),
        add_edge_features=use_edge_feature,
        use_previous_data=use_previous_data,
        node_type_index=param["index"]["node_type_index"],
        edge_layout=_edge_layout(param, edge_layout),
        **budget_kwargs,
    )
    if extension == "h5":
        world_pos = param.get("transformations", {}).get("world_pos_parameters", {})
        world_pos_parameters = world_pos if khop > 1 and world_pos.get("use", False) else None
        return H5Dataset(h5_path=dataset_params["h5_path"],
                         world_pos_parameters=world_pos_parameters, **common)
    return XDMFDataset(
        xdmf_folder=dataset_params["xdmf_folder"],
        random_next=dataset_params.get("random_next", 1),
        random_prev=dataset_params.get("random_prev", 1),
        dt_features=dataset_params.get("dt_features", False),
        **common,
    )
