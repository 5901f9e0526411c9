"""GPipe pipeline parallelism on gloo ranks against the JAX package (twins
of ``tests/test_parallel.py``'s ``test_pp_step_matches_single_device``,
``test_pp_transformer_step_matches_single_device`` and
``test_pp_gmm_step_matches_single_device[diag|full]``).

As in the JAX tests: 4 stages, 4 microbatches (the JAX tests'
``make_test_graph`` graphs), 4 blocks of width 8 with ``scan_blocks``, one
SGD-momentum step. The JAX step runs on ``make_mesh(4, (PIPE_AXIS,))`` of
the 8 virtual CPU devices on COO microbatches; the port's on one spawn of
4 gloo ranks on the pipe axis (one intra-op thread a rank, a timeout) on
the same graphs in its models' layouts (receiver-sorted for the EPD, CSR
for the transformer, whose padding is 128 nodes on both sides), with the
JAX weights unstacked (``utils.reference_weights.unstack_scanned_blocks``).
Limits, JAX's own: the loss within rtol 1e-5; the parameters rtol 2e-4,
atol 1e-6 (the GMM NLL's large untrained gradients: rtol 2e-3, atol
1e-5, as the JAX GMM test); the normalizer's count equal and sums rtol
1e-4; each also against the port's single-process step on the
concatenation. Every refusal of the JAX step has its test."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphphysics_tpu.core.graph import flatten_batched_graph as jax_flatten
from graphphysics_tpu.core.graph import pad_graph_np as jax_pad_graph_np
from graphphysics_tpu.core.graph import stack_graphs as jax_stack_graphs
from graphphysics_tpu.core.nodetype import NodeType
from graphphysics_tpu.models.processors import EncodeProcessDecode, EncodeTransformDecode
from graphphysics_tpu.models.simulator import Simulator, SimulatorConfig
from graphphysics_tpu.parallel import PIPE_AXIS, make_mesh, make_pp_train_step, shard_pp_state
from graphphysics_tpu.utils.torch_import import export_reference_state_dict
from graphphysics_torch.core.graph import (
    concat_graphs,
    pad_graph_csr_np,
    pad_graph_sorted_np,
    stack_graphs,
)
from graphphysics_torch.parallel import pp
from graphphysics_torch.parallel.mesh import PIPE_AXIS as PORT_PIPE_AXIS
from graphphysics_torch.parallel.mesh import launch
from graphphysics_torch.utils.reference_weights import unstack_scanned_blocks

from tests import _torch_port_common  # noqa: F401  (thread cap, sync dispatch)
from tests._torch_port_model_parallel_cases import build_sim, run_cases, single_step
from tests._torch_port_partition_cases import sample_graph_raw

LAUNCH_TIMEOUT_S = 180
STAGES, MICROBATCHES = 4, 4
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
GMM_PARAM_TOL = dict(rtol=2e-3, atol=1e-5)
CFG = dict(feature_index_start=0, feature_index_end=2, output_index_start=0,
           output_index_end=2, node_type_index=2)
# name: (family, K, use_diagonal)
CASES = {"epd": ("epd", 0, True), "transformer": ("transformer", 0, True),
         "gmm_diag": ("epd", 3, True), "gmm_full": ("epd", 3, False)}


def n_pad(family):
    return 128 if family == "transformer" else 64  # the CSR layout pads to whole 128-row blocks


@functools.lru_cache(maxsize=None)
def setup(name):
    """(JAX Simulator, its variables, the raw microbatches, the port spec)."""
    family, K, diagonal = CASES[name]
    edge_in = 3 if family == "epd" else 0
    raws = [sample_graph_raw(seed=s, edge_in=edge_in, n_pad=n_pad(family))
            for s in range(MICROBATCHES)]
    node_in = 2 + NodeType.SIZE
    cfg = SimulatorConfig(node_input_size=node_in, edge_input_size=edge_in, output_size=2, **CFG)
    if family == "epd":
        model = EncodeProcessDecode(message_passing_num=4, node_input_size=node_in,
                                    edge_input_size=3, output_size=2, hidden_size=8,
                                    num_mixture_components=K, use_diagonal=diagonal,
                                    scan_blocks=True)
    else:
        model = EncodeTransformDecode(message_passing_num=4, node_input_size=node_in,
                                      output_size=2, hidden_size=8, num_heads=2, scan_blocks=True)
    sim = Simulator(config=cfg, model=model)
    stacked = jax.tree_util.tree_map(jnp.asarray,
                                     jax_stack_graphs([jax_pad_graph_np(**r) for r in raws]))
    variables = sim.init({"params": jax.random.key(0)}, jax_flatten(stacked))
    spec = dict(family=family, blocks=4, hidden=8, heads=2, K=K, diagonal=diagonal,
                state=port_state(variables["params"]))
    return sim, variables, raws, stacked, spec


def port_state(params) -> dict:
    model = unstack_scanned_blocks(jax.tree_util.tree_map(np.asarray, params))["model"]
    return {k[len("model."):]: np.array(v, np.float32)
            for k, v in export_reference_state_dict({"model": model}).items()}


@functools.lru_cache(maxsize=None)
def jax_pp_step(name):
    """JAX ``make_pp_train_step`` on ``make_mesh(4, (PIPE_AXIS,))``: (loss,
    the parameters after one step under the reference names, the node and
    output normalizers' states)."""
    sim, variables, _, stacked, _ = setup(name)
    fresh = jax.tree_util.tree_map(jnp.array, variables)
    tx = optax.sgd(1e-2, momentum=0.9)
    state = {"params": fresh["params"], "normalizer": fresh["normalizer"],
             "opt_state": tx.init(fresh["params"]), "step": jnp.zeros((), jnp.int32)}
    mesh = make_mesh(STAGES, (PIPE_AXIS,))
    step = make_pp_train_step(sim, tx, [NodeType.NORMAL, NodeType.OUTFLOW], mesh)
    new_state, loss = step(shard_pp_state(state, mesh), stacked)
    norms = {k: new_state["normalizer"][k]["state"] for k in ("node_normalizer",
                                                              "output_normalizer")}
    return float(loss), port_state(new_state["params"]), jax.tree_util.tree_map(np.asarray, norms)


def port_graphs(name):
    family = CASES[name][0]
    pad = pad_graph_sorted_np if family == "epd" else pad_graph_csr_np
    return [pad(**r) for r in setup(name)[2]]


@pytest.fixture(scope="module")
def ranks():
    """Every case's per-rank results: one spawn of 4 stages."""
    cases = {name: dict(kind="pp", spec=setup(name)[4], graphs=port_graphs(name)) for name in CASES}
    results = launch(run_cases, STAGES, "cpu", args=(cases,), timeout=LAUNCH_TIMEOUT_S, threads=1,
                     axis_name=PORT_PIPE_AXIS)
    return {name: [r[name] for r in results] for name in CASES}


def check(name, ranks):
    jax_loss, jax_params, jax_norms = jax_pp_step(name)
    spec = setup(name)[4]
    tol = GMM_PARAM_TOL if spec["K"] else PARAM_TOL
    single = single_step(spec, concat_graphs(port_graphs(name)))
    np.testing.assert_allclose(single["loss"], jax_loss, rtol=LOSS_RTOL)
    for r, res in enumerate(ranks[name]):
        assert res["stage"] == (PORT_PIPE_AXIS, STAGES, r, 1) and res["local_blocks"] == 1
        tables = 2 if CASES[name][0] == "epd" else 1  # the EPD ships its edge table too
        assert res["shifts"] == 2 * tables * (MICROBATCHES + STAGES - 1)  # forward, backward
        np.testing.assert_allclose(res["loss"], jax_loss, rtol=LOSS_RTOL, err_msg=f"rank {r}")
        params = {k[len("model."):]: v for k, v in res["state"].items() if k.startswith("model.")}
        assert set(params) == set(jax_params)
        for k, v in jax_params.items():
            np.testing.assert_allclose(params[k], v, **tol, err_msg=f"rank {r} {k} vs JAX PP")
            np.testing.assert_allclose(params[k], single["state"][f"model.{k}"], **tol,
                                       err_msg=f"rank {r} {k} vs one process")
        for port_name, jax_name in (("_node_normalizer", "node_normalizer"),
                                    ("_output_normalizer", "output_normalizer")):
            want = jax_norms[jax_name]
            assert float(res["state"][f"{port_name}._acc_count"]) == float(want.acc_count)
            np.testing.assert_allclose(res["state"][f"{port_name}._acc_sum"], want.acc_sum,
                                       rtol=1e-4, atol=1e-5)
        assert np.isfinite(res["losses"]).all() and res["losses"] == ranks[name][0]["losses"]
        assert "plain unpartitioned" in res["refused"]


def test_pp_step_matches_single_device(ranks):
    check("epd", ranks)


def test_pp_transformer_step_matches_single_device(ranks):
    check("transformer", ranks)


@pytest.mark.parametrize("use_diagonal", [True, False])
def test_pp_gmm_step_matches_single_device(ranks, use_diagonal):
    check("gmm_diag" if use_diagonal else "gmm_full", ranks)


def _sim(**spec):
    return build_sim(dict(dict(family="epd", blocks=4, hidden=8, scan_blocks=True), **spec))


@pytest.mark.parametrize("what,make,error,match", [
    ("no scan_blocks", lambda: _sim(scan_blocks=False), ValueError, "scan_blocks"),
    ("L not divisible", lambda: _sim(blocks=3), ValueError, "not divisible"),
    ("only_processor", lambda: _only_processor(_sim()), NotImplementedError, "only_processor"),
    ("remat", lambda: _sim(remat=True), NotImplementedError, "remat"),
    ("EPD without edge features", lambda: _no_edges(_sim()), ValueError, "edge features"),
    ("another model", lambda: types.SimpleNamespace(model=torch.nn.Linear(1, 1)),
     NotImplementedError, "EPD/transformer"),
])
def test_pp_refuses_what_jax_refuses(what, make, error, match):
    with pytest.raises(error, match=match):
        pp.check_pp_model(make(), 2)


def _only_processor(sim):
    sim.model.only_processor = True  # the JAX flag; the port has no such model
    return sim


def _no_edges(sim):
    sim.config = dataclasses.replace(sim.config, edge_input_size=0)
    return sim


@pytest.mark.parametrize("field,value", [
    ("partition_axis", "graph"), ("halo_send_idx", np.zeros((4, 2, 1), np.int32)),
    ("ell_degree", 4)])
def test_pp_refuses_partitioned_halo_and_ell_microbatches(field, value):
    mbs = stack_graphs(port_graphs("epd"))
    with pytest.raises(ValueError, match="plain unpartitioned"):
        pp.check_microbatches(mbs.replace(**{field: value}))
    pp.check_microbatches(mbs)


def test_pp_step_refuses_an_unstaged_simulator():
    sim = _sim()
    with pytest.raises(ValueError, match="shard_pp_state"):
        pp.make_pp_train_step(sim, torch.optim.SGD(sim.parameters(), lr=1e-2), [0])
