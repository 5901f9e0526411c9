"""Port parity, model: ``Simulator(EncodeProcessDecode)`` eval outputs and
``accumulate_stats`` against the JAX simulator, with the JAX weights and
normalizer statistics carried across by ``export_reference_checkpoint`` ->
``load_reference_checkpoint``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core.graph import Graph as JaxGraph
from graphphysics_tpu.models.simulator import Simulator as JaxSim
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core.graph import pad_graph_sorted_np
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests._torch_port_common import simulator_pair

# f32 through 3 blocks in another summation order (XLA vs ATen GEMMs and
# segment sums), then the output normalizer's inverse
RTOL, ATOL = 1e-4, 1e-4


def _graph(seed=0, n=50, e=170, n_pad=64, e_pad=192):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    return pad_graph_sorted_np(
        x, r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
        n_pad, e_pad, edge_attr=r.normal(size=(e, 3)).astype(np.float32),
        y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
    )


def _jax_graph(g):
    return JaxGraph(
        x=jnp.asarray(g.x), pos=jnp.asarray(g.pos), senders=jnp.asarray(g.senders),
        receivers=jnp.asarray(g.receivers), edge_attr=jnp.asarray(g.edge_attr),
        node_mask=jnp.asarray(g.node_mask), edge_mask=jnp.asarray(g.edge_mask),
        y=jnp.asarray(g.y),
    )


def _jax_variables(jax_sim, jgraph):
    variables = jax_sim.init({"params": jax.random.key(0)}, jgraph)
    _, mut = jax_sim.apply(
        variables, jgraph, method=JaxSim.accumulate_stats, mutable=["normalizer"]
    )
    return {"params": variables["params"], "normalizer": mut["normalizer"]}


@pytest.mark.parametrize("from_file", [False, True])
def test_simulator_eval_matches_jax(tmp_path, from_file):
    jax_sim, sim = simulator_pair(blocks=3, hidden=32)
    g = _graph()
    jgraph = _jax_graph(g)
    variables = _jax_variables(jax_sim, jgraph)
    want = jax_sim.apply(variables, jgraph, is_training=False)
    path = str(tmp_path / "ckpt.pt")
    ckpt = export_reference_checkpoint(variables, path=path if from_file else None)
    load_reference_checkpoint(sim, path if from_file else ckpt)
    with torch.no_grad():
        got = sim(g.to("cpu"))
    for name, ours, theirs in zip(("network_output", "target_delta", "outputs"), got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL, err_msg=name)


def test_accumulate_stats_matches_jax():
    jax_sim, sim = simulator_pair(blocks=1, hidden=8)
    graphs = [_graph(seed=s) for s in (1, 2)]
    jgraphs = [_jax_graph(g) for g in graphs]
    variables = jax_sim.init({"params": jax.random.key(0)}, jgraphs[0])
    for jg in jgraphs:
        _, mut = jax_sim.apply(variables, jg, method=JaxSim.accumulate_stats, mutable=["normalizer"])
        variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    for g in graphs:
        sim.accumulate_stats(g.to("cpu"))
    sd = sim.state_dict()
    for name in ("output_normalizer", "node_normalizer", "edge_normalizer"):
        st = variables["normalizer"][name]["state"]
        for ours, theirs in (("_acc_count", st.acc_count), ("_num_accumulations", st.num_accumulations),
                             ("_acc_sum", st.acc_sum), ("_acc_sum_squared", st.acc_sum_sq)):
            np.testing.assert_allclose(
                sd[f"_{name}.{ours}"].numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-5,
                err_msg=f"{name}.{ours}",
            )


def test_checkpoint_of_another_depth_is_refused():
    jax_sim, _ = simulator_pair(blocks=2, hidden=8)
    _, sim = simulator_pair(blocks=3, hidden=8)
    jgraph = _jax_graph(_graph())
    ckpt = export_reference_checkpoint(_jax_variables(jax_sim, jgraph))
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_checkpoint(sim, ckpt)
