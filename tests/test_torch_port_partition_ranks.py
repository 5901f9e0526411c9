"""Edge-partitioned training and rollout on P gloo ranks against the JAX
package (twins of ``tests/test_graph_partition.py``,
``tests/test_attention_overlap.py`` and ``test_remat.py``'s partitioned
forward).

One spawn of 4 ranks (``parallel.mesh.launch``, a ``FileStore`` under
``tmp_path``, one intra-op thread a rank, a timeout) runs every case of
``tests/_torch_port_partition_cases.py`` and writes each rank's results to
``tmp_path``; one spawn of 2 ranks runs the P = 2 cases. The parent holds
them against the JAX package on the 8-device CPU mesh: forwards within
rtol 2e-4, atol 1e-5 (EPD) / 2e-5 (transformer) of the unpartitioned
forward and of ``graph_parallel_forward``; one train step within loss
rtol 1e-5, the merged normalizer ``acc_sum`` rtol 1e-4, parameters rtol
5e-3, atol 5e-5 of ``make_graph_parallel_train_step``; 3-frame
``partitioned_rollout`` within rtol 2e-4, atol 2e-5 of JAX's; a 2-epoch
``Trainer.fit(graph_partition=4)`` of the split layout within rtol 5e-3 of
the unsplit one.

The same 4-rank spawn runs the 2-D (data x graph) cases, each laying the
world out as 2 data rows of 2 parts for itself (twins of
``tests/test_parallel.py::test_dp_graph_parallel_2d_step_matches_dp``,
``test_attention_overlap.py::test_split_2d_dp_graph_step_matches_unsplit``
and ``test_trainer.py``'s 2-D fit and budget growth): a batch of 2
graphs of 256 nodes, each cut into 2, two steps; the first step's loss
within rtol 1e-5 of JAX's 2-D step on a ``(2, 2)`` mesh and 2e-5 of the
data-parallel step on the unpartitioned graphs, the second 5e-3 (as the
JAX test: fp reassociation across parts flips near-zero gradients' signs),
the merged ``acc_sum`` rtol 1e-4, the parameters after the first step
rtol 5e-3, atol 5e-5 of JAX's 2-D step."""

import functools
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from graphphysics_tpu.core.graph import pad_graph_np as jax_pad_graph_np
from graphphysics_tpu.core.graph import stack_graphs as jax_stack_graphs
from graphphysics_tpu.core.nodetype import NodeType
from graphphysics_tpu.models.processors import EncodeProcessDecode, EncodeTransformDecode
from graphphysics_tpu.models.simulator import Simulator, SimulatorConfig
from graphphysics_tpu.parallel import make_mesh, shard_batch
from graphphysics_tpu.parallel.dp import (
    graph_parallel_forward,
    make_dp_graph_parallel_train_step,
    make_dp_train_step,
    make_graph_parallel_train_step,
    partitioned_rollout,
)
from graphphysics_tpu.parallel.graph_partition import (
    partition_frames_np,
    partition_graph_halo_np,
    partition_graph_np,
    unpartition_rows,
)
from graphphysics_tpu.parallel.mesh import DATA_AXIS, GRAPH_AXIS
from graphphysics_tpu.training.losses import l2_loss
from graphphysics_tpu.training.rollout import rollout
from graphphysics_tpu.utils.torch_import import export_reference_state_dict

from tests import _torch_port_common  # noqa: F401  (thread cap, sync dispatch)
from tests._torch_port_partition_cases import probe_graph_raw, raw_graph, run_cases

LAUNCH_TIMEOUT_S = 300
FWD_TOL = {"epd": dict(rtol=2e-4, atol=1e-5), "transformer": dict(rtol=2e-4, atol=2e-5)}
MASKS = [NodeType.NORMAL, NodeType.OUTFLOW]
CFG = dict(feature_index_start=0, feature_index_end=2, output_index_start=0,
           output_index_end=2, node_type_index=2)


def _jnp(g):
    return jax.tree_util.tree_map(jnp.asarray, g)


def jax_model(family, blocks, hidden, node_in=4):
    if family == "epd":
        return EncodeProcessDecode(message_passing_num=blocks, node_input_size=node_in,
                                   edge_input_size=3, output_size=2, hidden_size=hidden)
    return EncodeTransformDecode(message_passing_num=blocks, node_input_size=node_in,
                                 output_size=2, hidden_size=hidden, num_heads=4)


def port_state(params) -> dict:
    return {k[len("model."):]: np.array(v, np.float32)
            for k, v in export_reference_state_dict({"model": params}).items()}


@functools.lru_cache(maxsize=None)
def model_setup(family, seed):
    """(JAX model, its params, the raw graph, the port model spec) of a
    forward case: 2 blocks, width 16, as the JAX tests."""
    raw = raw_graph(seed=seed)
    model = jax_model(family, 2, 16)
    params = model.init(jax.random.key(0), _jnp(jax_pad_graph_np(**raw)))
    spec = dict(family=family, blocks=2, hidden=16, node_in=4, edge_in=3,
                state=port_state(params["params"]))
    return model, params, raw, spec


@functools.lru_cache(maxsize=None)
def sim_setup(family, seed):
    """(JAX Simulator, its variables, the raw graph, the port spec) of a
    train-step or rollout case."""
    raw = raw_graph(seed=seed)
    node_in = 2 + NodeType.SIZE
    edge_in = 3 if family == "epd" else 0
    blocks, hidden = (1, 8) if family == "epd" else (2, 16)
    cfg = SimulatorConfig(node_input_size=node_in, edge_input_size=edge_in, output_size=2, **CFG)
    sim = Simulator(config=cfg, model=jax_model(family, blocks, hidden, node_in))
    variables = sim.init({"params": jax.random.key(0)}, _jnp(jax_pad_graph_np(**raw)))
    spec = dict(family=family, blocks=blocks, hidden=hidden, edge_in=edge_in,
                state=port_state(variables["params"]["model"]))
    return sim, variables, raw, spec


def rollout_frames(raw):
    r = np.random.default_rng(9)
    frames = []
    for _ in range(3):
        x = raw["x"].copy()
        x[:, 0:2] = r.normal(size=x[:, 0:2].shape).astype(np.float32)
        frames.append(dict(raw, x=x, y=r.normal(size=raw["y"].shape).astype(np.float32)))
    return frames


FORWARDS = {  # name: (family, seed, mode, split, wire, overlap, remat)
    "epd_halo": ("epd", 0, "halo", False, None, True, False),
    "epd_halo_no_overlap": ("epd", 0, "halo", False, None, False, False),
    "epd_gather": ("epd", 0, "gather", False, None, True, False),
    "epd_gather_no_overlap": ("epd", 0, "gather", False, None, False, False),
    "epd_halo_bf16": ("epd", 11, "halo", False, "bf16", True, False),
    "epd_remat_gather": ("epd", 4, "gather", False, None, True, True),
    "transformer_halo": ("transformer", 1, "halo", False, None, True, False),
    "transformer_split": ("transformer", 1, "halo", True, None, True, False),
    "transformer_gather": ("transformer", 1, "gather", False, None, True, False),
    "transformer_split_bf16": ("transformer", 11, "halo", True, "bf16", True, False),
}
STEPS = {  # name: (family, seed, mode, split)
    "epd_halo": ("epd", 2, "halo", False),
    "transformer_split": ("transformer", 2, "halo", True),
    "transformer_unsplit": ("transformer", 2, "halo", False),
}
ROLLOUTS = {  # name: (family, mode, split)
    "epd_halo": ("epd", "halo", False),
    "transformer_split": ("transformer", "halo", True),
}
TWO_RANKS = ("transformer_split", "epd_halo")
DP2D = {  # name: (family, mode, split)
    "epd_halo": ("epd", "halo", False),
    "epd_gather": ("epd", "gather", False),
    "transformer_split": ("transformer", "halo", True),
    "transformer_unsplit": ("transformer", "halo", False),
}
ROUNDOFF_LEAVES = ("k_proj.bias",)


def forward_case(name):
    family, seed, mode, split, wire, overlap, remat = FORWARDS[name]
    _, _, raw, spec = model_setup(family, seed)
    return dict(kind="forward", graph=raw, mode=mode, split=split, wire=wire,
                model=dict(spec, overlap=overlap, remat=remat))


def fit_param(tmp):
    from tests.fixtures import write_cylinder_h5

    h5_path, meta_path = write_cylinder_h5(str(tmp), num_traj=1, steps=6, nx=8, ny=6)
    return {
        "dataset": {"extension": "h5", "h5_path": h5_path, "meta_path": meta_path, "khop": 1},
        "model": {"type": "transformer", "message_passing_num": 1, "hidden_size": 16,
                  "node_input_size": 2, "output_size": 2, "edge_input_size": 0, "num_heads": 4},
        "index": dict(CFG),
        "transformations": {"preprocessing": {"noise": 0.02, "noise_index_start": [0],
                                              "noise_index_end": [2], "masking": 0},
                            "world_pos_parameters": {"use": False}},
    }


def spawn(directory, num_parts, cases):
    from graphphysics_torch.parallel.mesh import launch

    with open(directory / "cases.pkl", "wb") as f:
        pickle.dump((num_parts, cases), f)
    paths = launch(run_cases, num_parts, "cpu", args=(str(directory),), timeout=LAUNCH_TIMEOUT_S,
                   threads=1)
    out = []
    for path in paths:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("four_ranks")
    cases = {f"forward:{n}": forward_case(n) for n in FORWARDS}
    for name, (family, seed, mode, split) in STEPS.items():
        _, _, raw, spec = sim_setup(family, seed)
        cases[f"step:{name}"] = dict(kind="train_step", graph=raw, mode=mode, split=split,
                                     model=spec)
    for name, (family, mode, split) in ROLLOUTS.items():
        _, _, raw, spec = sim_setup(family, 5)
        cases[f"rollout:{name}"] = dict(kind="rollout", frames=rollout_frames(raw), mode=mode,
                                        split=split, model=spec)
    cases["fit"] = dict(kind="fit", param=fit_param(directory), dir=str(directory))
    for name, (family, mode, split) in DP2D.items():
        _, _, raws, spec = dp2d_setup(family)
        cases[f"dp2d:{name}"] = dict(kind="dp2d_step", graphs=raws, model=spec, layout=(2, 2),
                                     mode=mode, split=split, steps=2)
    (directory / "dp2d").mkdir()
    dp2d_param = fit_param(directory / "dp2d")
    shutil.copy(dp2d_param["dataset"]["h5_path"], directory / "dp2d" / "test.h5")  # the val split
    cases["dp2d_fit"] = dict(kind="dp_fit", param=dp2d_param, graph_partition=2,
                             batch_size=2, epochs=2, loader="multihost", val=True, gmm=False,
                             trainer=dict(partitioned_validation=True), dir=str(directory / "dp2d"))
    probe = dict(cylinder_param_like(), model=dict(type="epd", message_passing_num=1,
                                                   hidden_size=8, node_input_size=2, output_size=2,
                                                   edge_input_size=3))
    balanced, skewed = (probe_graph_raw(256, 256, skew) for skew in (False, True))
    cases["dp2d_growth"] = dict(kind="dp2d_growth", param=probe, dir=str(directory / "growth"),
                                batches=[[balanced, balanced], [balanced, skewed], [balanced, skewed]])
    return spawn(directory, 4, cases)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("two_ranks")
    return spawn(directory, 2, {f"forward:{n}": forward_case(n) for n in TWO_RANKS})


def cylinder_param_like():
    """The training-config keys the Trainer reads without a dataset."""
    return {"model": {}, "index": dict(CFG)}


@functools.lru_cache(maxsize=None)
def dp2d_setup(family):
    """(JAX Simulator, variables, 2 raw graphs of 256 nodes padded to 1,664
    edges, the port spec): the JAX 2-D test's graphs and model, 2 blocks,
    width 16 as the partition cases."""
    raws = [raw_graph(seed=s, e_pad=1664) for s in (10, 11)]
    edge_in = 3 if family == "epd" else 0
    if not edge_in:
        raws = [dict(r, edge_attr=None) for r in raws]
    node_in = 2 + NodeType.SIZE
    cfg = SimulatorConfig(node_input_size=node_in, edge_input_size=edge_in, output_size=2, **CFG)
    sim = Simulator(config=cfg, model=jax_model(family, 2, 16, node_in))
    variables = sim.init({"params": jax.random.key(0)}, _jnp(jax_pad_graph_np(**raws[0])))
    spec = dict(family=family, blocks=2, hidden=16, edge_in=edge_in,
                state=port_state(variables["params"]["model"]))
    return sim, variables, raws, spec


def jax_uniform_parts(graphs, num_parts, mode, split):
    """JAX's parts of each graph with one set of budgets, stacked
    ``[B, P, ...]`` (as ``_torch_port_partition_cases.uniform_parts``)."""
    if mode == "gather":
        eb = max(partition_graph_np(g, num_parts).senders.shape[1] for g in graphs)
        return jax_stack_graphs([partition_graph_np(g, num_parts, edge_budget_local=eb)
                                 for g in graphs])
    trials = [partition_graph_halo_np(g, num_parts, split_local=split) for g in graphs]
    if split:
        eb = (max(t.num_local_edges for t in trials),
              max(t.senders.shape[1] - t.num_local_edges for t in trials))
    else:
        eb = max(t.senders.shape[1] for t in trials)
    hb = max(t.halo_send_idx.shape[2] for t in trials)
    return jax_stack_graphs([partition_graph_halo_np(g, num_parts, edge_budget_local=eb,
                                                     halo_budget=hb, split_local=split)
                             for g in graphs])


@functools.lru_cache(maxsize=None)
def jax_dp2d(name):
    """JAX's two 2-D steps on a (2, 2) mesh and two data-parallel steps on
    the unpartitioned graphs: (2-D losses, DP losses, 2-D parameters and
    normalizer state after the first step)."""
    family, mode, split = DP2D[name]
    sim, variables, raws, _ = dp2d_setup(family)
    tx = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=1e-4)

    def fresh():
        v = jax.tree_util.tree_map(jnp.array, variables)  # the steps donate their state
        return {"params": v["params"], "normalizer": v["normalizer"],
                "opt_state": tx.init(v["params"]), "step": jnp.zeros((), jnp.int32)}

    graphs = [jax_pad_graph_np(**r) for r in raws]
    mesh_dp = make_mesh(2, (DATA_AXIS,))
    dp_step = make_dp_train_step(sim, tx, MASKS, mesh_dp)
    dp_batch = shard_batch(_jnp(jax_stack_graphs(graphs)), mesh_dp, DATA_AXIS)
    state, dp_losses = fresh(), []
    for _ in range(2):
        state, loss = dp_step(state, dp_batch)
        dp_losses.append(float(loss))
    mesh2d = make_mesh(4, (DATA_AXIS, GRAPH_AXIS), shape=(2, 2))
    step2d = make_dp_graph_parallel_train_step(sim, tx, MASKS, mesh2d)
    sharding = NamedSharding(mesh2d, PartitionSpec(DATA_AXIS, GRAPH_AXIS))
    batch = jax.tree_util.tree_map(lambda a: jax.device_put(jnp.asarray(a), sharding),
                                   jax_uniform_parts(graphs, 2, mode, split))
    state, losses, first = fresh(), [], None
    for _ in range(2):
        state, loss = step2d(state, batch)
        losses.append(float(loss))
        if first is None:  # copied: the next step donates the state
            norm = state["normalizer"]["node_normalizer"]["state"]
            first = (port_state(state["params"]["model"]),
                     {k: np.array(getattr(norm, k)) for k in ("acc_count", "num_accumulations",
                                                              "acc_sum")})
    return losses, dp_losses, first


@functools.lru_cache(maxsize=None)
def jax_forward(name, num_parts=None):
    """The JAX forward of a case: unpartitioned (``num_parts`` None), else
    ``graph_parallel_forward`` over that many parts of its layout."""
    family, seed, mode, split, wire, _, _ = FORWARDS[name]
    model, params, raw, _ = model_setup(family, seed)
    g = jax_pad_graph_np(**raw)
    if num_parts is None:
        return np.asarray(model.apply(params, _jnp(g)))
    if mode == "gather":
        parts = partition_graph_np(g, num_parts)
    else:
        parts = partition_graph_halo_np(g, num_parts, split_local=split).replace(halo_dtype=wire)
    mesh = make_mesh(num_parts, (GRAPH_AXIS,))
    out = graph_parallel_forward(model, params, shard_batch(_jnp(parts), mesh, GRAPH_AXIS), mesh)
    return unpartition_rows(np.asarray(out))


@pytest.mark.parametrize("name", list(FORWARDS))
def test_partitioned_forward_matches_jax(four_ranks, name):
    family, _, mode, _, wire, _, _ = FORWARDS[name]
    outs = [r[f"forward:{name}"]["out"] for r in four_ranks]
    for other in outs[1:]:
        np.testing.assert_array_equal(other, outs[0])  # every rank gathers the same rows
    tol = FWD_TOL[family]
    if wire is None:
        np.testing.assert_allclose(outs[0], jax_forward(name), **tol)
    if mode == "halo" and name in ("epd_halo", "transformer_split", "epd_halo_bf16",
                                   "transformer_split_bf16"):
        np.testing.assert_allclose(outs[0], jax_forward(name, 4), **tol)


@pytest.mark.parametrize("name", TWO_RANKS)
def test_two_ranks_forward_matches_jax(two_ranks, name):
    family = FORWARDS[name][0]
    out = two_ranks[0][f"forward:{name}"]["out"]
    np.testing.assert_allclose(out, jax_forward(name), **FWD_TOL[family])
    np.testing.assert_allclose(out, jax_forward(name, 2), **FWD_TOL[family])


@pytest.mark.parametrize("name", list(STEPS))
def test_partitioned_train_step_matches_jax(four_ranks, name):
    family, seed, mode, split = STEPS[name]
    sim, variables, raw, _ = sim_setup(family, seed)
    # the unpartitioned loss, as the JAX test's reference
    gj = _jnp(jax_pad_graph_np(**raw))

    def loss_fn(p):
        (out, tgt, _), _ = sim.apply({"params": p, "normalizer": variables["normalizer"]}, gj,
                                     is_training=True, mutable=["normalizer"])
        return l2_loss(tgt, out, gj.x[:, 2].astype(jnp.int32), MASKS, node_valid=gj.node_mask)

    ref_loss = float(loss_fn(variables["params"]))
    tx = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=1e-4)
    fresh = jax.tree_util.tree_map(jnp.array, variables)  # the step donates its state
    state = {"params": fresh["params"], "normalizer": fresh["normalizer"],
             "opt_state": tx.init(fresh["params"]), "step": jnp.zeros((), jnp.int32)}
    mesh = make_mesh(4, (GRAPH_AXIS,))
    step = make_graph_parallel_train_step(sim, tx, MASKS, mesh)
    parts = partition_graph_halo_np(jax_pad_graph_np(**raw), 4, split_local=split)
    new_state, loss = step(state, shard_batch(_jnp(parts), mesh, GRAPH_AXIS))
    norm = new_state["normalizer"]["node_normalizer"]["state"]
    want_params = port_state(new_state["params"]["model"])
    for r in four_ranks:
        got = r[f"step:{name}"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-5)
        assert got["acc_count"] == float(norm.acc_count)
        assert got["num_accumulations"] == float(norm.num_accumulations) == 1.0
        np.testing.assert_allclose(got["acc_sum"], np.asarray(norm.acc_sum), rtol=1e-4, atol=1e-5)
        assert got["params"].keys() == want_params.keys()
        for k, v in want_params.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=5e-3, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("name", list(ROLLOUTS))
def test_partitioned_rollout_matches_jax(four_ranks, name):
    family, mode, split = ROLLOUTS[name]
    sim, variables, raw, _ = sim_setup(family, 5)
    frames = [jax_pad_graph_np(**f) for f in rollout_frames(raw)]
    mesh = make_mesh(4, (GRAPH_AXIS,))
    parts = jax.tree_util.tree_map(
        jnp.asarray, partition_frames_np(frames, 4, halo=mode == "halo", split_local=split))
    preds, targets = partitioned_rollout(sim, variables, parts, mesh, jax.random.key(1))
    ref_preds, _ = rollout(sim, variables, _jnp(jax_stack_graphs(frames)), jax.random.key(1))
    for r in four_ranks:
        got = r[f"rollout:{name}"]
        np.testing.assert_allclose(got["preds"], np.asarray(preds), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["preds"], np.asarray(ref_preds), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["targets"], np.asarray(targets), rtol=1e-6)


def test_trainer_fit_split_matches_unsplit(four_ranks):
    fits = [r["fit"] for r in four_ranks]
    on, off = fits[0][True], fits[0][False]
    assert on["split"] and not off["split"]
    assert len(on["train_loss"]) == 2 and len(on["host_ms"]) > 0
    np.testing.assert_allclose(on["train_loss"], off["train_loss"], rtol=5e-3)
    for f in fits[1:]:  # the ranks report the same losses
        assert f[True]["train_loss"] == on["train_loss"]


def test_cli_train_and_predict_on_two_ranks(tmp_path, monkeypatch):
    """``--graph_partition 2`` through both CLIs: the command starts the
    ranks; rank 0 writes the checkpoint and metrics; the partitioned
    predict equals the unpartitioned one on the same checkpoint."""
    import json

    from graphphysics_torch.cli import predict as predict_cli
    from graphphysics_torch.cli import train as train_cli
    from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader
    from tests._torch_port_common import cylinder_param, write_cylinder_split

    data = tmp_path / "data"
    data.mkdir()
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(cylinder_param(*write_cylinder_split(data), "epd")))
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' torch threads
    base = ["--training_parameters_path", str(cfg), "--device", "cpu"]
    assert train_cli.main([*base, "--graph_partition", "2", "--halo_dtype", "bf16",
                           "--num_epochs", "1", "--batch_size", "2", "--warmup", "5",
                           "--val_trajectories", "1"]) == 0
    ckpt = work / "checkpoints" / "state.pt"
    assert ckpt.exists() and (work / "metrics.csv").exists()
    preds = {}
    for label, extra in (("parts", ["--graph_partition", "2"]), ("whole", [])):
        assert predict_cli.main([*base, "--model_path", str(ckpt), "--save_dir", label,
                                 "--max_trajectories", "1", *extra]) == 0
        with XdmfTimeSeriesReader(str(work / label / "graph_0.xdmf")) as reader:
            preds[label] = np.stack([reader.read_data(k)[1]["prediction"]
                                     for k in range(reader.num_steps)])
    np.testing.assert_allclose(preds["parts"], preds["whole"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("options,error,match", [
    (dict(data_parallel=True, graph_partition=2, num_devices=6, gradient_accumulation=True),
     ValueError, "data_parallel and gradient_accumulation"),
    (dict(graph_partition=2, partition_mode="gather", halo_dtype="bf16"), ValueError,
     "requires partition_mode"),
    (dict(partitioned_validation=True), ValueError, "requires graph_partition"),
    (dict(graph_partition=2), RuntimeError, "no process group"),
    (dict(graph_partition=2, partition_reorder="spiral"), ValueError, "unknown partition_reorder"),
])
def test_trainer_partition_options_are_checked(options, error, match):
    from graphphysics_torch.training.trainer import Trainer

    param = {"model": {"type": "epd", "output_size": 2}, "index": dict(CFG)}
    with pytest.raises(error, match=match):
        Trainer(param, device="cpu", metrics_path=None, **options)


def test_cli_data_parallel_graph_partition_must_divide_the_ranks(tmp_path):
    from graphphysics_torch.cli import train as train_cli

    with pytest.raises(SystemExit, match="--graph_partition 2 must divide the 3 ranks"):
        train_cli.main(["--training_parameters_path", str(tmp_path / "none.json"), "--device", "cpu",
                        "--graph_partition", "2", "--data_parallel", "--num_devices", "3"])


@pytest.mark.parametrize("name", list(DP2D))
def test_dp_graph_parallel_2d_step_matches_jax(four_ranks, name):
    """The 2-D step on 2 x 2 ranks against JAX's on a (2, 2) mesh and against
    the data-parallel step on the unpartitioned graphs; a [1, P, ...] shard
    is refused with JAX's message."""
    losses, dp_losses, (want_params, norm) = jax_dp2d(name)
    for r in four_ranks:
        got = r[f"dp2d:{name}"]
        np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-5)
        np.testing.assert_allclose(got["losses"][0], dp_losses[0], rtol=2e-5)
        np.testing.assert_allclose(got["losses"][1], dp_losses[1], rtol=5e-3)
        assert got["losses"] == four_ranks[0][f"dp2d:{name}"]["losses"]
        assert got["acc_count"] == float(norm["acc_count"])
        assert got["num_accumulations"] == float(norm["num_accumulations"]) == 1.0
        np.testing.assert_allclose(got["acc_sum"], norm["acc_sum"], rtol=1e-4, atol=1e-5)
        for k, v in want_params.items():
            if k.endswith(ROUNDOFF_LEAVES):
                # a gradient 0 in exact arithmetic: moved by round-off's
                # sign, at most one learning rate (AdamW's first step)
                start = dp2d_setup(DP2D[name][0])[3]["state"][k]
                assert np.abs(got["params"][k] - start).max() <= 1e-3 * (1 + 1e-4), k
                continue
            np.testing.assert_allclose(got["params"][k], v, rtol=5e-3, atol=5e-5, err_msg=k)
        assert "expected a [1, 1, ...] local shard" in got["refused"]


def test_split_2d_step_matches_unsplit(four_ranks):
    """Twin of ``test_split_2d_dp_graph_step_matches_unsplit``: the 2-D
    transformer step in the split-edge layout equals the unsplit one."""
    for r in four_ranks:
        np.testing.assert_allclose(r["dp2d:transformer_split"]["losses"][0],
                                   r["dp2d:transformer_unsplit"]["losses"][0], rtol=1e-5)


def test_fit_dp_graph_partition_2d(four_ranks):
    """Twin of ``test_fit_dp_graph_partition_2d``: ``Trainer(data_parallel,
    graph_partition=2, num_devices=4)`` trains 2 epochs from a
    ``MultihostGraphLoader``, every rank the same losses; each data row
    validates its share of the trajectories partitioned over its parts,
    equal to the sequential validation."""
    fits = [r["dp2d_fit"] for r in four_ranks]
    assert [f["places"] for f in fits] == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    assert [f["is_writer"] for f in fits] == [True, False, False, False]
    losses = fits[0]["history"]["train_loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(f["history"]["train_loss"] == losses for f in fits)
    assert all(len(f["host_ms"]) > 0 for f in fits)
    for f in fits:
        (seq, vseq), (par, vpar) = f[("validate", False)], f[("validate", True)]
        assert par == pytest.approx(seq, rel=1e-12) and vpar == pytest.approx(vseq, rel=1e-12)


def test_partition_budget_growth_per_data_row(four_ranks):
    """Twin of ``test_partition_budget_growth_dp_mid_batch``: each data row
    cuts its own graph, so when row 1's graph outgrows the budgets only
    row 1 grows them (both its ranks alike), once; every step runs."""
    runs = [r["dp2d_growth"] for r in four_ranks]
    assert all(np.isfinite(r["losses"]).all() for r in runs)
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    row0, row1 = runs[0]["edge_slots"], runs[2]["edge_slots"]
    assert runs[1]["edge_slots"] == row0 and runs[3]["edge_slots"] == row1
    assert row0[0] == row0[1] == row0[2] == row1[0]
    assert row1[1] == row1[2] != row1[0]
