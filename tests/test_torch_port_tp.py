"""Tensor parallelism on gloo ranks against the JAX package (twins of
``tests/test_parallel.py``'s ``test_tp_step_matches_single_device`` and
``test_tp_step_compiles_once``).

The port shards whole heads (``parallel.tp``), so the model group's size
``T`` must divide the heads and every sharded width; the JAX test shards 2
heads over 8 devices, which the port refuses (``test_tp_refuses_*``). The
twins run ``T = 2`` and ``T = 4`` at width 16 with 4 heads. One spawn of 2
ranks and one of 4 (``parallel.mesh.launch`` on the model axis, one
intra-op thread a rank, a timeout) run every case of
``tests/_torch_port_model_parallel_cases.py``; the parent holds them, with
the same numpy weights (``export_reference_state_dict``), against JAX's
``make_tp_train_step`` on ``make_mesh(T, (MODEL_AXIS,))`` of the 8 virtual
CPU devices and against the port's single-process step: the loss within
rtol 1e-5, the parameters after one SGD-momentum step within rtol 2e-4,
atol 1e-6 (JAX's own limits for TP against one device). The port's plan
marks column, row and replicated exactly as ``tp_param_specs`` does, leaf
by leaf under the reference names."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec

from graphphysics_tpu.core.graph import flatten_batched_graph as jax_flatten
from graphphysics_tpu.core.graph import pad_graph_np as jax_pad_graph_np
from graphphysics_tpu.core.graph import stack_graphs as jax_stack_graphs
from graphphysics_tpu.core.nodetype import NodeType
from graphphysics_tpu.models.processors import EncodeProcessDecode, EncodeTransformDecode
from graphphysics_tpu.models.simulator import Simulator, SimulatorConfig
from graphphysics_tpu.parallel import MODEL_AXIS, make_mesh, make_tp_train_step, shard_tp_state
from graphphysics_tpu.parallel import tp_param_specs as jax_tp_param_specs
from graphphysics_tpu.utils.torch_import import export_reference_state_dict
from graphphysics_torch.core.graph import concat_graphs, pad_graph_np
from graphphysics_torch.parallel import tp
from graphphysics_torch.parallel.mesh import MODEL_AXIS as PORT_MODEL_AXIS
from graphphysics_torch.parallel.mesh import launch

from tests import _torch_port_common  # noqa: F401  (thread cap, sync dispatch)
from tests._torch_port_model_parallel_cases import (
    MASKS,
    build_sim,
    run_cases,
    sgd,
    single_step,
)
from tests._torch_port_partition_cases import sample_graph_raw

LAUNCH_TIMEOUT_S = 180
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=1e-6)
CFG = dict(feature_index_start=0, feature_index_end=2, output_index_start=0,
           output_index_end=2, node_type_index=2)
# (family, T): the twins of the JAX test's two families at T = 2, the
# transformer's also at T = 4 (one head a rank)
CASES = {"epd_t2": ("epd", 2), "transformer_t2": ("transformer", 2),
         "transformer_t4": ("transformer", 4)}


def jax_model(family, blocks=2, hidden=16, heads=4, K=0, diagonal=True):
    node_in = 2 + NodeType.SIZE
    if family == "epd":
        return EncodeProcessDecode(message_passing_num=blocks, node_input_size=node_in,
                                   edge_input_size=3, output_size=2, hidden_size=hidden,
                                   num_mixture_components=K, use_diagonal=diagonal)
    return EncodeTransformDecode(message_passing_num=blocks, node_input_size=node_in,
                                 output_size=2, hidden_size=hidden, num_heads=heads,
                                 num_mixture_components=K, use_diagonal=diagonal)


def jax_sim(family, **kw):
    edge_in = 3 if family == "epd" else 0
    cfg = SimulatorConfig(node_input_size=2 + NodeType.SIZE, edge_input_size=edge_in,
                          output_size=2, **CFG)
    return Simulator(config=cfg, model=jax_model(family, **kw))


def port_state(params) -> dict:
    return {k[len("model."):]: np.array(v, np.float32)
            for k, v in export_reference_state_dict({"model": params}).items()}


@functools.lru_cache(maxsize=None)
def setup(family):
    """(JAX Simulator, its variables, the 2 raw graphs, the port spec):
    width 16, 4 heads, 2 blocks, initialised on the flattened graphs as
    the JAX TP test does."""
    raws = [sample_graph_raw(seed=s, edge_in=3 if family == "epd" else 0) for s in range(2)]
    sim = jax_sim(family)
    graph = jax_flatten(jax.tree_util.tree_map(
        jnp.asarray, jax_stack_graphs([jax_pad_graph_np(**r) for r in raws])))
    variables = sim.init({"params": jax.random.key(0)}, graph)
    spec = dict(family=family, blocks=2, hidden=16, heads=4,
                state=port_state(variables["params"]["model"]))
    return sim, variables, raws, graph, spec


@functools.lru_cache(maxsize=None)
def jax_tp_step(family, size):
    """JAX ``make_tp_train_step`` on ``make_mesh(size, (MODEL_AXIS,))``:
    (loss, the parameters after one step under the reference names)."""
    sim, variables, _, graph, _ = setup(family)
    fresh = jax.tree_util.tree_map(jnp.array, variables)  # the step donates its state
    tx = optax.sgd(1e-2, momentum=0.9)
    state = {"params": fresh["params"], "normalizer": fresh["normalizer"],
             "opt_state": tx.init(fresh["params"]), "step": jnp.zeros((), jnp.int32)}
    mesh = make_mesh(size, (MODEL_AXIS,))
    step = make_tp_train_step(sim, tx, [NodeType.NORMAL, NodeType.OUTFLOW], mesh)
    new_state, loss = step(shard_tp_state(state, mesh), jax.device_put(graph))
    return float(loss), port_state(new_state["params"]["model"])


def port_graphs(raws):
    return [pad_graph_np(**r) for r in raws]


def pbg_case():
    """The EPD with ``project_before_gather`` (its first edge layer a
    column-parallel ``SplitDense``), the same weights: the port's knob."""
    _, _, raws, _, spec = setup("epd")
    return dict(kind="tp", spec=dict(spec, project_before_gather=True), graphs=port_graphs(raws))


@pytest.fixture(scope="module")
def ranks():
    """Every case's per-rank results: one spawn of 2 ranks, one of 4."""
    out = {}
    for size in (2, 4):
        cases = {}
        for name, (family, t) in CASES.items():
            if t == size:
                _, _, raws, _, spec = setup(family)
                cases[name] = dict(kind="tp", spec=spec, graphs=port_graphs(raws))
        if size == 2:
            cases["epd_pbg_t2"] = pbg_case()
        results = launch(run_cases, size, "cpu", args=(cases,), timeout=LAUNCH_TIMEOUT_S,
                         threads=1, axis_name=PORT_MODEL_AXIS)
        for r in results:
            for name in cases:
                out.setdefault(name, []).append(r[name])
    return out


def model_params(state: dict) -> dict:
    return {k[len("model."):]: v for k, v in state.items() if k.startswith("model.")}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_single_device(ranks, name):
    family, size = CASES[name]
    _, _, raws, _, spec = setup(family)
    jax_loss, jax_params = jax_tp_step(family, size)
    single = single_step(spec, concat_graphs(port_graphs(raws)))
    np.testing.assert_allclose(single["loss"], jax_loss, rtol=LOSS_RTOL)
    for r, res in enumerate(ranks[name]):
        np.testing.assert_allclose(res["loss"], jax_loss, rtol=LOSS_RTOL, err_msg=f"rank {r}")
        params = model_params(res["state"])
        assert set(params) == set(jax_params)
        for k in jax_params:
            np.testing.assert_allclose(params[k], jax_params[k], **PARAM_TOL,
                                       err_msg=f"rank {r} {k} vs JAX TP")
            np.testing.assert_allclose(res["state"][f"model.{k}"], single["state"][f"model.{k}"],
                                       **PARAM_TOL, err_msg=f"rank {r} {k} vs one process")
        for k, v in single["state"].items():  # the normalizers' statistics
            if not k.startswith("model."):
                np.testing.assert_allclose(res["state"][k], v, rtol=1e-6, err_msg=k)
        # every matmul-bearing weight is sharded, as in the JAX test
        assert all(f"model.{k}" in res["sharded"] for k in params
                   if k.endswith(".weight") and "decode_module.proj" not in k)
        assert np.isfinite(res["losses"]).all()
    assert all(res["loss"] == ranks[name][0]["loss"] for res in ranks[name])


def test_tp_project_before_gather_step_matches_single_process(ranks):
    """The port's ``project_before_gather`` EPD (the JAX model leaves the
    knob at its default) on 2 ranks against its single-process step."""
    case = pbg_case()
    single = single_step(case["spec"], concat_graphs(case["graphs"]))
    for res in ranks["epd_pbg_t2"]:
        np.testing.assert_allclose(res["loss"], single["loss"], rtol=LOSS_RTOL)
        for k, v in single["state"].items():
            np.testing.assert_allclose(res["state"][k], v, **PARAM_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["epd_t2", "transformer_t4"])
def test_tp_step_compiles_once(ranks, name):
    """The twin of the JAX test that step 2 hits the jit cache: over 3
    steps the local shapes of the parameters and of the optimizer's
    momenta stay those of the first, the optimizer keeps stepping the
    sharded parameters, and every step makes the same all-reduces."""
    for res in ranks[name]:
        first = res["layouts"][0]
        assert first["params"] == first["momenta"]
        assert all(lay == first for lay in res["layouts"])
        assert first["same_objects"] and first["optimizer_params"] and first["all_reduces"] > 0
        assert "replicated" in res["refused"]


@pytest.mark.parametrize("family,K,diagonal", [
    ("epd", 0, True), ("transformer", 0, True), ("epd", 3, True), ("transformer", 3, False)])
def test_tp_plan_matches_jax_leaf_by_leaf(family, K, diagonal):
    """``tp.tp_param_specs`` against ``tp_param_specs`` on the same model:
    each JAX leaf's spec written into an array of its shape, carried to
    the reference names by ``export_reference_state_dict``; 0 replicated,
    1 + the torch dimension cut."""
    sim = jax_sim(family, K=K, diagonal=diagonal)
    raws = [sample_graph_raw(seed=0, edge_in=3 if family == "epd" else 0)]
    graph = jax.tree_util.tree_map(jnp.asarray, jax_pad_graph_np(**raws[0]))
    params = sim.init({"params": jax.random.key(0)}, graph)["params"]
    specs = jax_tp_param_specs(params)

    def code(spec, leaf):
        if MODEL_AXIS not in tuple(spec):
            return np.zeros(np.shape(leaf))
        return np.full(np.shape(leaf), 1 + (np.ndim(leaf) - 1 - tuple(spec).index(MODEL_AXIS)))

    codes = jax.tree_util.tree_map(code, specs, params,
                                   is_leaf=lambda x: isinstance(x, PartitionSpec))
    want = {}
    for k, v in export_reference_state_dict({"model": codes["model"]}).items():
        assert np.all(v == v.flat[0]), k
        want[k] = int(v.flat[0])
    port = build_sim(dict(family=family, blocks=2, hidden=16, heads=4, K=K, diagonal=diagonal))
    got = {k: 0 if s is None else 1 + s.dim for k, s in tp.tp_param_specs(port).items()}
    assert got == want
    assert set(got.values()) == {0, 1, 2}


@pytest.mark.parametrize("family,hidden,heads,size,what", [
    ("transformer", 16, 4, 3, "heads"),     # 3 ranks cannot hold whole heads of 4
    ("transformer", 16, 2, 8, "heads"),     # the JAX test's 2 heads over 8 devices
    ("epd", 18, 4, 4, "width 18"),          # 4 ranks do not divide the width
    ("epd", 16, 4, 3, "width 16"),
])
def test_tp_refuses_widths_the_group_does_not_divide(family, hidden, heads, size, what):
    sim = build_sim(dict(family=family, blocks=1, hidden=hidden, heads=heads))
    with pytest.raises(ValueError, match=what):
        tp.check_tp_sizes(sim, size)


def test_tp_step_refuses_an_unsharded_simulator():
    sim = build_sim(dict(family="epd", blocks=1, hidden=8))
    with pytest.raises(ValueError, match="shard_tp_state"):
        tp.make_tp_train_step(sim, sgd(sim), MASKS)


def test_shard_indices_keep_whole_interleaved_heads():
    """Rank r's q/k/v columns are ``d * H + h`` for its heads in ``(d,
    h_local)`` order; the ranks' sets partition the width."""
    width, heads, size = 16, 4, 2
    sets = [tp.shard_indices(width, size, r, heads).tolist() for r in range(size)]
    assert sets[0] == [d * heads + h for d in range(width // heads) for h in (0, 1)]
    assert sorted(sets[0] + sets[1]) == list(range(width))
    assert tp.shard_indices(12, 3, 1).tolist() == [4, 5, 6, 7]
