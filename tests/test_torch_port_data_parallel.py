"""Data parallelism on gloo ranks against the JAX package (twins of
``tests/test_parallel.py``'s data-parallel step cases, ``test_multihost.py``,
``test_dataset.py``'s multihost worker case and ``test_trainer.py``'s
data-parallel fit and parallel validation), and ``flatten_batched_graph``.

One spawn of 2 ranks (``parallel.mesh.launch`` with the layout ``(2, 1)``,
a ``FileStore`` under ``tmp_path``, one intra-op thread a rank, a timeout)
runs the data-parallel cases of ``tests/_torch_port_partition_cases.py``;
the 2-D (data x graph) cases run in ``test_torch_port_partition_ranks.py``'s
4-rank spawn. The parent holds the ranks against the JAX package on the
8-device CPU mesh: one step within loss rtol 1e-5, the merged normalizer
``acc_sum`` rtol 1e-4, parameters rtol 5e-3, atol 5e-5 of
``make_dp_train_step`` on ``make_mesh(2)``; the Trainer's data-parallel
fits within rtol 1e-4 of a one-process fit on the same global batches;
parallel validation within 1e-12 of the sequential one. The loader's
schedule equals JAX ``MultihostGraphLoader``'s index for index, with the
JAX process index and count set to each rank's."""

import dataclasses
import functools
import json
import pickle

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
from graphphysics_tpu.models.simulator import Simulator, SimulatorConfig
from graphphysics_tpu.parallel import make_dp_train_step, make_mesh, shard_batch
from graphphysics_torch.core.graph import (
    concat_graphs,
    flatten_batched_graph,
    pad_graph_csr_np,
    pad_graph_ell_np,
    pad_graph_np,
    pad_graph_sorted_np,
    stack_graphs,
)
from graphphysics_torch.parallel.multihost import (
    MultihostGraphLoader,
    global_batch_from_local,
    initialize_distributed,
    process_local_indices,
)

from tests import _torch_port_common  # noqa: F401  (thread cap, sync dispatch)
from tests._torch_port_partition_cases import run_cases, sample_graph_raw
from tests.test_torch_port_partition_ranks import CFG, MASKS, _jnp, jax_model, port_state

LAUNCH_TIMEOUT_S = 300
FAMILIES = ("epd", "transformer")
FIT_RTOL = 1e-4
VALIDATION_RTOL = 1e-12
ROUNDOFF_LEAVES = ("k_proj.bias",)


@functools.lru_cache(maxsize=None)
def dp_setup(family):
    """(JAX Simulator, its variables, 8 raw graphs, the port spec): 2 blocks,
    width 16, initialised on the flattened batch as the JAX DP tests do."""
    edge_in = 3 if family == "epd" else 0
    raws = [sample_graph_raw(seed=s, edge_in=edge_in) for s in range(8)]
    node_in = 2 + NodeType.SIZE
    cfg = SimulatorConfig(node_input_size=node_in, edge_input_size=edge_in, output_size=2, **CFG)
    sim = Simulator(config=cfg, model=jax_model(family, 2, 16, node_in))
    stacked = _jnp(jax_stack_graphs([jax_pad_graph_np(**r) for r in raws]))
    variables = sim.init({"params": jax.random.key(0)}, jax_flatten(stacked))
    spec = dict(family=family, blocks=2, hidden=16, edge_in=edge_in,
                state=port_state(variables["params"]["model"]))
    return sim, variables, raws, spec


@functools.lru_cache(maxsize=None)
def jax_dp_steps(family, order, steps):
    """JAX ``make_dp_train_step`` on ``make_mesh(2)`` over the stacked graphs
    in ``order``: (the parameters and normalizer state after the first
    step, every step's loss)."""
    sim, variables, raws, _ = dp_setup(family)
    tx = optax.adamw(1e-3, b1=0.9, b2=0.95, weight_decay=1e-4)
    fresh = jax.tree_util.tree_map(jnp.array, variables)  # the step donates its state
    state = {"params": fresh["params"], "normalizer": fresh["normalizer"],
             "opt_state": tx.init(fresh["params"]), "step": jnp.zeros((), jnp.int32)}
    mesh = make_mesh(2)
    step = make_dp_train_step(sim, tx, MASKS, mesh)
    batch = shard_batch(_jnp(jax_stack_graphs([jax_pad_graph_np(**raws[i]) for i in order])), mesh)
    losses, first = [], None
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
        if first is None:  # copied: the next step donates the state
            norm = state["normalizer"]["node_normalizer"]["state"]
            first = (port_state(state["params"]["model"]),
                     {k: np.array(getattr(norm, k)) for k in ("acc_count", "num_accumulations",
                                                              "acc_sum")})
    return first, losses


def spawn(directory, num_ranks, cases, layout):
    from graphphysics_torch.parallel.mesh import launch

    with open(directory / "cases.pkl", "wb") as f:
        pickle.dump((num_ranks, cases), f)
    paths = launch(run_cases, num_ranks, "cpu", args=(str(directory),), timeout=LAUNCH_TIMEOUT_S,
                   threads=1, layout=layout)
    out = []
    for path in paths:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def cylinder_split(tmp_path_factory):
    from tests._torch_port_common import cylinder_param, write_cylinder_split

    directory = tmp_path_factory.mktemp("dp_data")
    return cylinder_param(*write_cylinder_split(directory), "epd")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, cylinder_split):
    directory = tmp_path_factory.mktemp("dp_two_ranks")
    cases = {}
    for family in FAMILIES:
        _, _, raws, spec = dp_setup(family)
        cases[f"step:{family}"] = dict(kind="dp_step", graphs=raws, model=spec, steps=3)
    _, _, raws, spec = dp_setup("epd")
    cases["loader_step"] = dict(kind="dp_step", graphs=raws, model=spec, steps=2, loader=True)
    for loader in ("stack", "multihost"):
        cases[f"fit:{loader}"] = dict(kind="dp_fit", param=cylinder_split, batch_size=4, epochs=2,
                                      loader=loader, val=loader == "stack",
                                      dir=str(directory / loader))
    return spawn(directory, 2, cases, (2, 1))


# ------------------------------------------------------------ the DP step


@pytest.mark.parametrize("family", FAMILIES)
def test_dp_step_matches_jax(two_ranks, family):
    """Twin of ``test_parallel.py::test_dp_step_matches_single_device``:
    both ranks' first step against JAX's on a 2-device data mesh."""
    (want_params, norm), losses = jax_dp_steps(family, tuple(range(8)), 3)
    for r in two_ranks:
        got = r[f"step:{family}"]
        np.testing.assert_allclose(got["loss"], losses[0], rtol=1e-5)
        assert got["acc_count"] == float(norm["acc_count"])
        assert got["num_accumulations"] == float(norm["num_accumulations"]) == 1.0
        np.testing.assert_allclose(got["acc_sum"], norm["acc_sum"], rtol=1e-4, atol=1e-5)
        assert got["params"].keys() == want_params.keys()
        for k, v in want_params.items():
            if k.endswith(ROUNDOFF_LEAVES):
                # its gradient is 0 in exact arithmetic (a key bias adds
                # the same score to every edge of a receiver's softmax):
                # both steps move it by round-off's sign, at most one
                # learning rate (AdamW's first step)
                start = dp_setup(family)[3]["state"][k]
                for moved in (got["params"][k], v):
                    assert np.abs(moved - start).max() <= 1e-3 * (1 + 1e-4), k
                continue
            np.testing.assert_allclose(got["params"][k], v, rtol=5e-3, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_dp_step_runs_multiple_steps(two_ranks, family):
    """Twin of ``test_dp_step_runs_multiple_steps``: three steps lower the
    loss, the counter advances by one a step, and the losses follow JAX's."""
    _, want = jax_dp_steps(family, tuple(range(8)), 3)
    losses = [r[f"step:{family}"]["losses"] for r in two_ranks]
    assert losses[0] == losses[1]
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]
    assert all(r[f"step:{family}"]["final_accumulations"] == 3.0 for r in two_ranks)
    np.testing.assert_allclose(losses[0], want, rtol=1e-4)


def test_ranks_form_the_data_group(two_ranks):
    """Twin of ``test_mesh_uses_requested_devices``: the layout (2, 1) is one
    data group of both ranks and a graph group of one rank each."""
    assert [r["step:epd"]["groups"] for r in two_ranks] == [(0, 2, 0, 1), (1, 2, 0, 1)]


def test_multihost_loader_step_matches_jax(two_ranks):
    """Twin of ``test_multihost.py::test_two_process_dp_matches_single_process``:
    each rank steps on the rows ``MultihostGraphLoader`` gives it (rank r
    the items ``r::2``), against JAX's step on the global batch in that
    order."""
    _, want = jax_dp_steps("epd", (0, 2, 4, 6, 1, 3, 5, 7), 2)
    for r in two_ranks:
        np.testing.assert_allclose(r["loader_step"]["losses"], want, rtol=2e-5)


# ------------------------------------------------------------- the Trainer


class ScheduleLoader:
    """The global batches of a list of per-epoch schedules, concatenated,
    for the one-process Trainer the data-parallel fits are held to."""

    def __init__(self, dataset, schedules):
        self.dataset, self.schedules, self.epoch, self.start = dataset, schedules, 0, 0

    def __len__(self):
        return len(self.schedules[0])

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.dataset.set_epoch(epoch)

    def set_start_batch(self, b):
        self.start = b

    def __iter__(self):
        for chunk in self.schedules[self.epoch][self.start:]:
            yield concat_graphs([self.dataset[int(i)] for i in chunk])


def one_process_fit(param, tmp, schedules):
    from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing

    ds = get_dataset(param, get_preprocessing(param))
    tr = Trainer(param, learning_rate=1e-3, warmup=2, seed=5, device="cpu", metrics_path=None,
                 rollout_dir=None, checkpoint_dir=str(tmp), progress=False)
    return tr.fit(ScheduleLoader(ds, schedules), num_epochs=len(schedules))["train_loss"]


def test_fit_data_parallel_matches_one_process(two_ranks, cylinder_split, tmp_path):
    """Twin of ``test_trainer.py::test_fit_data_parallel_on_mesh``: 2 epochs
    of ``Trainer(data_parallel=True)`` on a ``GraphLoader(collate="stack")``
    equal the one-process fit on the same global batches; validation is
    finite."""
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import get_dataset, get_preprocessing

    ds = get_dataset(cylinder_split, get_preprocessing(cylinder_split))
    loader = GraphLoader(ds, batch_size=4, shuffle=True, seed=3)
    schedules = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        schedules.append(loader._chunks())
    want = one_process_fit(cylinder_split, tmp_path, schedules)
    hist = [r["fit:stack"]["history"] for r in two_ranks]
    assert hist[0]["train_loss"] == hist[1]["train_loss"]
    np.testing.assert_allclose(hist[0]["train_loss"], want, rtol=FIT_RTOL)
    assert len(hist[0]["val_rmse"]) == 2 and all(np.isfinite(hist[0]["val_rmse"]))


def test_fit_with_multihost_loader_matches_one_process(two_ranks, cylinder_split, tmp_path):
    """The same fit over ``MultihostGraphLoader`` (each rank builds its own
    rows) equals the one-process fit on its global schedule."""
    from graphphysics_torch.training import get_dataset, get_preprocessing

    ds = get_dataset(cylinder_split, get_preprocessing(cylinder_split))
    schedules = []
    for epoch in range(2):
        loader = MultihostGraphLoader(ds, per_host_batch=2, seed=3, rank=0, num_ranks=2)
        loader.set_epoch(epoch)
        schedules.append(loader.schedule())
    want = one_process_fit(cylinder_split, tmp_path, schedules)
    hist = [r["fit:multihost"]["history"] for r in two_ranks]
    assert hist[0]["train_loss"] == hist[1]["train_loss"]
    np.testing.assert_allclose(hist[0]["train_loss"], want, rtol=FIT_RTOL)


def test_parallel_validation_matches_sequential(two_ranks):
    """Twin of ``test_parallel_validation_matches_sequential``: each rank rolls
    out one of the 2 trajectories; the all-reduced RMSE and val_loss equal
    the sequential ones on every rank."""
    for r in two_ranks:
        (seq, vseq), (par, vpar) = r["fit:stack"][("validate", False)], r["fit:stack"][("validate", True)]
        assert np.isfinite(seq) and vseq is not None
        assert par == pytest.approx(seq, rel=VALIDATION_RTOL)
        assert vpar == pytest.approx(vseq, rel=VALIDATION_RTOL)
    assert two_ranks[0]["fit:stack"][("validate", True)] == two_ranks[1]["fit:stack"][("validate", True)]


def test_parallel_validation_gmm_matches_sequential(two_ranks):
    """Twin of ``test_parallel_validation_gmm_matches_sequential``: the GMM
    head's draws follow the trajectory, not the rank, so the sampled
    rollouts agree too."""
    for r in two_ranks:
        seq, par = r["fit:stack"][("validate_gmm", False)], r["fit:stack"][("validate_gmm", True)]
        assert np.isfinite(seq) and par == pytest.approx(seq, rel=VALIDATION_RTOL)


def test_world_rank_zero_writes(two_ranks):
    assert [r["fit:stack"]["places"] for r in two_ranks] == [(0, 0, 0), (1, 1, 0)]
    assert [r["fit:stack"]["is_writer"] for r in two_ranks] == [True, False]


@pytest.mark.parametrize("options,error,match", [
    (dict(data_parallel=True, graph_partition=2, num_devices=3), ValueError,
     "graph_partition 2 must divide the device count 3"),
    (dict(data_parallel=True, gradient_accumulation=True), ValueError,
     "data_parallel and gradient_accumulation are separate batch layouts"),
    (dict(data_parallel=True), RuntimeError, "no process group for data_parallel"),
])
def test_trainer_data_parallel_options_are_checked(options, error, match):
    from graphphysics_torch.training.trainer import Trainer

    param = {"model": {"type": "epd", "output_size": 2}, "index": dict(CFG)}
    with pytest.raises(error, match=match):
        Trainer(param, device="cpu", metrics_path=None, **options)


def test_cli_train_data_parallel_on_two_ranks(tmp_path, monkeypatch):
    """``grph-torch train --data_parallel --num_devices 2``: the command starts
    2 ranks, trains one epoch, world rank 0 writes the checkpoint and one
    set of metrics rows, and ``predict`` reads the checkpoint."""
    import csv

    from graphphysics_torch.cli import predict as predict_cli
    from graphphysics_torch.cli import train as train_cli
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
    assert train_cli.main([*base, "--data_parallel", "--num_devices", "2", "--num_epochs", "1",
                           "--batch_size", "4", "--warmup", "5", "--val_trajectories", "2"]) == 0
    ckpt = work / "checkpoints" / "state.pt"
    assert ckpt.exists()
    rows = list(csv.DictReader(open(work / "metrics.csv")))
    assert [r["epoch"] for r in rows if r.get("val_all_rollout_rmse")] == ["0"]
    assert predict_cli.main([*base, "--model_path", str(ckpt), "--save_dir", "preds",
                             "--max_trajectories", "1"]) == 0
    assert (work / "preds" / "graph_0.xdmf").exists()


# --------------------------------------------------- the loader and helpers


class ItemDataset:
    """Graphs by index; with sizes, a size-bucketed dataset as the loaders
    read one (``num_buckets``, ``bucket_of_index``, one frame a trajectory)."""

    def __init__(self, graphs, buckets=None):
        self.items, self.buckets = graphs, buckets
        if buckets is not None:
            self.num_buckets = int(max(buckets)) + 1
            self._traj_bucket = np.asarray(buckets)
            self.frames_per_trajectory = 1

    def __len__(self):
        return len(self.items)

    def bucket_of_index(self, i):
        return int(self.buckets[i])

    def __getitem__(self, i):
        return self.items[i]


def item_raws(bucketed):
    """Raw graphs whose ``x[0, 0]`` is their index: 20 of one size, or 16
    large and 20 small (the JAX bucketed test's two classes)."""
    small = dict(n=24, e=80, n_pad=32, e_pad=96)
    sizes = [{}] * 16 + [small] * 20 if bucketed else [{}] * 20
    raws = []
    for i, size in enumerate(sizes):
        raw = sample_graph_raw(seed=i, **size)
        raw["x"][0, 0] = i
        raws.append(raw)
    return raws


class _FakeProcess:
    """JAX's process index and count, set to a rank's for the JAX loader."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def __call__(self, rank, count):
        self.monkeypatch.setattr(jax, "process_index", lambda: rank)
        self.monkeypatch.setattr(jax, "process_count", lambda: count)


@pytest.mark.parametrize("bucketed,per_rank,shuffle", [
    (False, 3, True), (False, 4, False), (True, 4, True), (True, 16, False)])
def test_multihost_loader_schedule_matches_jax(bucketed, per_rank, shuffle, monkeypatch):
    """Twins of ``test_multihost_loader_peek_and_resume_single_process`` and
    ``..._bucketed_single_process`` at 2 ranks: every rank's batches (item
    for item, filler included), ``len``, ``peek`` and a resume equal JAX
    ``MultihostGraphLoader``'s local batches for that process."""
    from graphphysics_tpu.parallel.multihost import MultihostGraphLoader as JaxLoader

    raws = item_raws(bucketed)
    buckets = [0] * 16 + [1] * 20 if bucketed else None
    port_ds = ItemDataset([pad_graph_np(**r) for r in raws], buckets)
    jax_ds = ItemDataset([jax_pad_graph_np(**r) for r in raws], buckets)
    fake = _FakeProcess(monkeypatch)
    for epoch in (0, 1):
        for rank in (0, 1):
            fake(rank, 2)
            ref = JaxLoader(jax_ds, per_host_batch=per_rank, mesh=None, shuffle=shuffle, seed=7)
            ref.set_epoch(epoch)
            if bucketed:
                want = [ref._local_from_chunk(c) for c in ref._global_chunks()]
            else:
                idx = ref._order()
                want = [ref._local_batch(idx, b) for b in range(len(ref))]
            got_loader = MultihostGraphLoader(port_ds, per_host_batch=per_rank, shuffle=shuffle,
                                              seed=7, rank=rank, num_ranks=2, prefetch=0)
            got_loader.set_epoch(epoch)
            got = list(got_loader)
            assert len(got_loader) == len(ref) == len(got) == len(want) > 0
            for a, b in zip(got, want):
                for field in ("x", "senders", "receivers", "node_mask", "edge_mask"):
                    np.testing.assert_array_equal(getattr(a, field), np.asarray(getattr(b, field)))
            np.testing.assert_array_equal(got_loader.peek().x, got[0].x)
            got_loader.set_start_batch(len(got) - 1)
            resumed = list(got_loader)
            assert len(resumed) == 1
            np.testing.assert_array_equal(resumed[0].x, got[-1].x)
            assert len(list(got_loader)) == len(got)  # the resume is one-shot
    if bucketed and per_rank == 16:
        # buckets of 16 and 20 items under a global batch of 32: rank 1's
        # slices are empty (16 masked copies) and 4 items (and 12 copies)
        assert sorted(int((b.node_mask.sum(axis=1) > 0).sum()) for b in got) == [0, 4]


def test_multihost_loader_workers_match_inline(cylinder_split):
    """Twin of ``test_dataset.py::test_multihost_loader_workers_match_inline``:
    2 worker processes give a rank the batches its inline build gives."""
    from graphphysics_torch.training import get_dataset, get_preprocessing

    def make(workers):
        ds = get_dataset(cylinder_split, get_preprocessing(cylinder_split))
        return MultihostGraphLoader(ds, per_host_batch=2, shuffle=True, seed=9, num_workers=workers,
                                    rank=1, num_ranks=2)

    inline, pooled = make(0), make(2)
    try:
        for epoch in (0, 1):
            inline.set_epoch(epoch)
            pooled.set_epoch(epoch)
            a_batches, b_batches = list(inline), list(pooled)
            assert len(a_batches) == len(b_batches) > 0
            for a, b in zip(a_batches, b_batches):
                np.testing.assert_array_equal(a.x, b.x)
    finally:
        pooled.close()


def test_process_local_indices_and_single_process_helpers():
    np.testing.assert_array_equal(process_local_indices(7, 1, 3), [1, 4])
    np.testing.assert_array_equal(process_local_indices(5), np.arange(5))  # no process group
    initialize_distributed()  # one process: nothing to join
    g = stack_graphs([pad_graph_np(**sample_graph_raw(s)) for s in range(2)])
    t = global_batch_from_local(g, "cpu")
    assert isinstance(t.x, torch.Tensor) and t.x.shape == (2, 64, 4)


# ----------------------------------------------------- flatten_batched_graph


def _symmetric_raw(seed):
    from graphphysics_torch.topology.build import to_undirected

    raw = sample_graph_raw(seed)
    s, r = to_undirected(raw["senders"], raw["receivers"])
    ea = np.random.default_rng(seed).normal(size=(len(s), 3)).astype(np.float32)
    return dict(raw, senders=np.asarray(s), receivers=np.asarray(r), edge_attr=ea)


def _ell(seed, degree=16):
    raw = {k: v for k, v in _symmetric_raw(seed).items() if k != "e_pad"}
    return pad_graph_ell_np(**raw, degree=degree)


LAYOUTS = {
    "coo": lambda s: pad_graph_np(**sample_graph_raw(s)),
    "sorted": lambda s: pad_graph_sorted_np(**sample_graph_raw(s)),
    "csr": lambda s: pad_graph_csr_np(**dict(sample_graph_raw(s), n_pad=128)),
    "ell": _ell,
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_flatten_batched_graph_equals_concat_graphs(layout):
    """``flatten_batched_graph`` of a stacked batch equals ``concat_graphs``
    of its graphs bit for bit, on host arrays and on tensors, in every
    layout; on the plain layout its indices equal JAX's."""
    graphs = [LAYOUTS[layout](s) for s in range(3)]
    want = concat_graphs(graphs)
    for stacked in (stack_graphs(graphs), stack_graphs(graphs).to("cpu")):
        got = flatten_batched_graph(stacked)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if b is None or not hasattr(b, "shape"):
                assert a == b, f.name
                continue
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            assert a.shape == b.shape and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    if layout == "coo":
        ref = jax_flatten(_jnp(jax_stack_graphs([jax_pad_graph_np(**sample_graph_raw(s))
                                                 for s in range(3)])))
        for name in ("senders", "receivers", "x", "edge_mask"):
            np.testing.assert_array_equal(getattr(want, name), np.asarray(getattr(ref, name)))


def test_flatten_batched_graph_refuses_partitioned_graphs():
    from graphphysics_torch.parallel.graph_partition import partition_graph_halo_np

    from tests._torch_port_partition_cases import graph_of, raw_graph

    parts = partition_graph_halo_np(graph_of(raw_graph(n=64, seed=0)), 2)
    with pytest.raises(ValueError, match="cannot be flattened"):
        flatten_batched_graph(parts)
