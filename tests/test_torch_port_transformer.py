"""Port parity, the sparse transformer: ``GatedMLP``, ``GatedMLPBlock``,
``Attention`` (shared and separate projection weights; CSR and COO branch)
and ``TransformerBlock`` against the flax modules, and
``Simulator(EncodeTransformDecode)`` against the JAX simulator, with the
flax weights and normalizer statistics carried across by
``export_reference_state_dict`` / ``export_reference_checkpoint``. Also the
ported ``parse_parameters`` against the JAX one on ``panels.json``."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core.graph import Graph as JaxGraph
from graphphysics_tpu.models import layers as jax_layers
from graphphysics_tpu.models.processors import EncodeTransformDecode as JaxETD
from graphphysics_tpu.models.simulator import Simulator as JaxSim
from graphphysics_tpu.models.simulator import SimulatorConfig as JaxCfg
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core import NodeType
from graphphysics_torch.core.graph import pad_graph_csr_np
from graphphysics_torch.models import (
    Attention,
    EncodeTransformDecode,
    GatedMLP,
    GatedMLPBlock,
    Simulator,
    SimulatorConfig,
    TransformerBlock,
)
from graphphysics_torch.training import get_model, get_preprocessing, get_simulator
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests._torch_port_common import state_dict_under

# f32 matmuls and exponentials in another order (XLA vs ATen): a few ulps
# per layer, 2 blocks deep at most
RTOL, ATOL = 1e-5, 1e-5
# the whole simulator, then the output normalizer's inverse
SIM_RTOL, SIM_ATOL = 1e-4, 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]
PANELS_INDEX = dict(
    feature_index_start=0, feature_index_end=2, output_index_start=0, output_index_end=3,
    node_type_index=3,
)


def _graph(seed=0, n=100, e=600, n_pad=128, e_pad=768, width=5):
    """A sender-sorted padded graph with the panels layout
    ``[vel(3), node_type, time]``."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, width)).astype(np.float32)
    x[:, 3] = r.integers(0, 7, n)
    return pad_graph_csr_np(
        x, r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
        n_pad, e_pad, y=r.normal(size=(n, 3)).astype(np.float32), node_type_index=3,
    )


def _flax_block(x, g, separate, seed=1):
    """flax TransformerBlock params, with nonzero k/v bias deltas when the
    projection weight is shared."""
    block = jax_layers.TransformerBlock(
        output_dim=x.shape[1], num_heads=4, use_separate_proj_weight=separate
    )
    params = block.init(
        jax.random.key(seed), jnp.asarray(x), jnp.asarray(g.senders),
        jnp.asarray(g.receivers), jnp.asarray(g.edge_mask),
    )["params"]
    if not separate:
        r = np.random.default_rng(seed)
        attn = dict(params["attention"])
        for k in ("k_bias_delta", "v_bias_delta"):
            attn[k] = jnp.asarray(r.normal(size=attn[k].shape).astype(np.float32))
        params = dict(params, attention=attn)
    return block, params


def _edges(g):
    return torch.from_numpy(g.senders), torch.from_numpy(g.receivers), torch.from_numpy(g.edge_mask)


@pytest.mark.parametrize("separate", [True, False])
@pytest.mark.parametrize("branch", ["csr", "coo"])
def test_attention_matches_flax(separate, branch):
    g = _graph()
    x = np.random.default_rng(2).normal(size=(g.num_nodes, 32)).astype(np.float32)
    _, params = _flax_block(x, g, separate)
    want = jax_layers.Attention(output_dim=32, num_heads=4, use_separate_proj_weight=separate).apply(
        {"params": params["attention"]}, jnp.asarray(x), jnp.asarray(g.senders),
        jnp.asarray(g.receivers), jnp.asarray(g.edge_mask),
    )
    attn = Attention(32, num_heads=4)
    attn.load_state_dict(
        state_dict_under("processor_list.0.attention", {"block_0": params}), strict=True
    )
    bounds = torch.from_numpy(g.sender_bounds) if branch == "csr" else None
    with torch.no_grad():
        got = attn(torch.from_numpy(x), *_edges(g), bounds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_transformer_block_and_gated_mlp_match_flax():
    g = _graph(seed=3)
    x = np.random.default_rng(4).normal(size=(g.num_nodes, 32)).astype(np.float32)
    block, params = _flax_block(x, g, separate=True, seed=5)
    tree = {"block_0": params}
    xt = torch.from_numpy(x)

    gated = GatedMLP(32, 32)
    gated.load_state_dict(state_dict_under("processor_list.0.gated_mlp.1", tree), strict=True)
    want = jax_layers.GatedMLP(hidden_size=32).apply(
        {"params": params["gated_mlp"]["gated"]}, jnp.asarray(x)
    )
    np.testing.assert_allclose(gated(xt).detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    gblock = GatedMLPBlock(32, 32, 32)
    gblock.load_state_dict(state_dict_under("processor_list.0.gated_mlp", tree), strict=True)
    want = jax_layers.GatedMLPBlock(hidden_size=32, out_size=32).apply(
        {"params": params["gated_mlp"]}, jnp.asarray(x)
    )
    np.testing.assert_allclose(gblock(xt).detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    ours = TransformerBlock(32, num_heads=4)
    ours.load_state_dict(state_dict_under("processor_list.0", tree), strict=True)
    want = block.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(g.senders), jnp.asarray(g.receivers),
        jnp.asarray(g.edge_mask),
    )
    with torch.no_grad():
        got = ours(xt, *_edges(g), torch.from_numpy(g.sender_bounds))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _jax_graph(g):
    return JaxGraph(
        x=jnp.asarray(g.x), pos=jnp.asarray(g.pos), senders=jnp.asarray(g.senders),
        receivers=jnp.asarray(g.receivers), edge_attr=None,
        node_mask=jnp.asarray(g.node_mask), edge_mask=jnp.asarray(g.edge_mask),
        y=jnp.asarray(g.y),
    )


def transformer_pair(blocks: int, hidden: int):
    """(jax Simulator, port Simulator on the CPU): EncodeTransformDecode with
    the panels layout and no edge features."""
    node_in = 2 + int(NodeType.SIZE)
    cfg = dict(node_input_size=node_in, edge_input_size=0, output_size=3, **PANELS_INDEX)
    jax_sim = JaxSim(
        config=JaxCfg(**cfg),
        model=JaxETD(message_passing_num=blocks, node_input_size=node_in, output_size=3,
                     hidden_size=hidden, num_heads=4),
    )
    port_sim = Simulator(
        SimulatorConfig(**cfg), EncodeTransformDecode(blocks, node_in, 3, hidden, 4), device="cpu"
    )
    return jax_sim, port_sim


def _jax_variables(jax_sim, jgraphs):
    variables = jax_sim.init({"params": jax.random.key(0)}, jgraphs[0])
    for jg in jgraphs:
        _, mut = jax_sim.apply(variables, jg, method=JaxSim.accumulate_stats, mutable=["normalizer"])
        variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    return variables


def test_transformer_simulator_eval_matches_jax():
    jax_sim, sim = transformer_pair(blocks=3, hidden=32)
    graphs = [_graph(seed=s) for s in (6, 7)]
    jgraphs = [_jax_graph(g) for g in graphs]
    variables = _jax_variables(jax_sim, jgraphs)
    ckpt = export_reference_checkpoint(variables)
    assert ckpt["_edge_normalizer"] is None
    load_reference_checkpoint(sim, ckpt)
    assert sim._edge_normalizer is None
    for g, jg in zip(graphs, jgraphs):
        want = jax_sim.apply(variables, jg, is_training=False)
        with torch.no_grad():
            got = sim(g.to("cpu"))
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=SIM_RTOL, atol=SIM_ATOL)


def test_statistics_accumulate_without_edges_as_jax():
    jax_sim, sim = transformer_pair(blocks=1, hidden=16)
    graphs = [_graph(seed=s) for s in (8, 9, 10)]
    variables = _jax_variables(jax_sim, [_jax_graph(g) for g in graphs])
    for g in graphs:
        sim.accumulate_stats(g.to("cpu"))
    want = export_reference_checkpoint(variables)
    for name in ("_output_normalizer", "_node_normalizer"):
        for stat in ("_acc_count", "_num_accumulations", "_acc_sum", "_acc_sum_squared"):
            got = sim.state_dict()[f"{name}.{stat}"].numpy()
            np.testing.assert_allclose(got.ravel(), np.ravel(want[name][stat]), rtol=1e-5, atol=1e-5)
    assert not any(k.startswith("_edge_normalizer") for k in sim.state_dict())


def test_edge_normalizer_mismatch_is_refused():
    jax_sim, sim = transformer_pair(blocks=1, hidden=16)
    ckpt = export_reference_checkpoint(_jax_variables(jax_sim, [_jax_graph(_graph())]))
    with_edges = dict(ckpt, _edge_normalizer=ckpt["_node_normalizer"])
    with pytest.raises(ValueError, match="_edge_normalizer"):
        load_reference_checkpoint(sim, with_edges)


def _panels():
    with open(ROOT / "training_config" / "panels.json") as fp:
        return json.load(fp)


def test_get_simulator_builds_the_jax_shapes_for_panels():
    param = _panels()
    param["model"]["message_passing_num"] = 3  # the published 15 blocks repeat the same shapes
    sim = get_simulator(param, device="cpu")
    assert isinstance(sim.model, EncodeTransformDecode)
    assert sim.config == SimulatorConfig(
        node_input_size=11, edge_input_size=0, output_size=3, **PANELS_INDEX
    )
    jax_sim = jax_pp.get_simulator(param)
    variables = jax_sim.init({"params": jax.random.key(0)}, _jax_graph(_graph()))
    want = export_reference_checkpoint(variables)
    want_shapes = {k: np.shape(v) for k, v in want["model"].items()}
    for name in ("_output_normalizer", "_node_normalizer"):
        for stat in ("_acc_sum", "_acc_sum_squared"):
            want_shapes[f"{name}.{stat}"] = np.shape(want[name][stat])
    got_shapes = {
        k: tuple(v.shape) for k, v in sim.state_dict().items()
        if k.startswith("model.") or k.endswith(("_acc_sum", "_acc_sum_squared"))
    }
    assert got_shapes == want_shapes
    assert want["_edge_normalizer"] is None and sim._edge_normalizer is None
    # the full published config builds too: 15 blocks of width 128, 4 heads
    full = get_model(_panels())
    assert len(full.processor_list) == 15 and full.processor_list[0].attention.num_heads == 4
    assert full.processor_list[0].attention.q_proj.weight.shape == (128, 128)


@pytest.mark.parametrize(
    "key,value,match",
    [
        ("precision", "bf16", None),
        ("precision", "bfloat16", None),
        ("remat", True, None),
        ("scan_blocks", True, None),
        ("precision", "fp8", "fp8"),
    ],
)
def test_unported_model_keys_raise(key, value, match):
    """The model keys the port once refused build the model the JAX
    ``get_model`` builds: the compute dtype, ``remat``, ``scan_blocks``
    (the same unrolled block count); an unknown precision raises as the
    JAX dict lookup does."""
    param = _panels()
    param["model"][key] = value
    if match is not None:
        with pytest.raises(KeyError, match=match):
            jax_pp.get_model(param)
        with pytest.raises(KeyError, match=match):
            get_model(param)
        return
    want = jax_pp.get_model(param)
    model = get_model(param)
    assert model.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16 else None)
    assert (model.remat, model.scan_blocks) == (want.remat, want.scan_blocks)
    assert len(model.processor_list) == want.message_passing_num == 15
    block = model.processor_list[0]
    assert block.attention.q_proj.compute_dtype == model.dtype
    assert block.gated_mlp[2].compute_dtype == model.dtype


def test_preprocessing_for_prediction():
    param = _panels()
    # training keeps the config's noise after FaceToEdge; prediction drops it
    train = get_preprocessing(param, use_edge_feature=False)
    assert [getattr(s, "func", s).__name__ for s in train.steps] == ["apply_face_to_edge", "add_noise"]
    pre = get_preprocessing(param, use_edge_feature=False, remove_noise=True)
    assert [s.__name__ for s in pre.steps] == ["apply_face_to_edge"]
    # with world positions, the DeformingPlate steps (the default radius)
    param["transformations"]["world_pos_parameters"].update(
        use=True, world_pos_index_start=0, world_pos_index_end=3)
    pre = get_preprocessing(param, remove_noise=True)
    assert [getattr(s, "func", s).__name__ for s in pre.steps] == [
        "add_obstacles_next_pos", "apply_face_to_edge", "add_world_edges", "add_edge_features",
        "add_world_pos_features"]
    assert pre.steps[2].keywords["radius"] == 0.03
