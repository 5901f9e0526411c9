"""Rank functions of the multi-rank partition and data-parallel tests
(``test_torch_port_partition_ranks.py``, ``test_torch_port_data_parallel.py``).
Each spawned gloo rank (``parallel.mesh.launch``) loads the case list the
parent pickled, runs every case on its part or rows and writes its results
to ``rank{r}.pkl`` beside it; the parent compares them with the JAX
package. A 2-D case lays the world out as ``(data, graph)`` for itself
(``layout``) and puts the partition spawn's one graph group back after.
This module imports neither JAX nor the JAX package (the ranks run the
port alone)."""

import contextlib
import pickle
from pathlib import Path

import numpy as np
import torch

from graphphysics_torch.core.graph import Graph, pad_graph_np, stack_graphs
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.models import (
    EncodeProcessDecode,
    EncodeTransformDecode,
    Simulator,
    SimulatorConfig,
)
from graphphysics_torch.parallel import mesh
from graphphysics_torch.parallel.dp import (
    gather_rows,
    graph_parallel_forward,
    make_dp_graph_parallel_train_step,
    make_dp_train_step,
    make_graph_parallel_train_step,
    partitioned_rollout,
)
from graphphysics_torch.topology.build import to_undirected
from graphphysics_torch.parallel.graph_partition import (
    part_of,
    partition_frames_np,
    partition_graph_halo_np,
    partition_graph_np,
)

MASKS = (int(NodeType.NORMAL), int(NodeType.OUTFLOW))
INDEX = dict(feature_index_start=0, feature_index_end=2, output_index_start=0,
             output_index_end=2, node_type_index=2)


def raw_graph(n=256, seed=0, e_pad=None) -> dict:
    """``pad_graph_np``'s arguments for a symmetric random graph of ``n``
    nodes (the JAX partition tests' ``_mesh_graph``), padded to ``e_pad``
    edges (32 more than it has unless named)."""
    r = np.random.default_rng(seed)
    s = r.integers(0, n, 3 * n).astype(np.int32)
    t = (s + r.integers(1, 16, 3 * n)).astype(np.int32) % n
    S, R = to_undirected(s, t)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    return dict(x=x, pos=r.normal(size=(n, 2)).astype(np.float32), senders=np.asarray(S),
                receivers=np.asarray(R), n_pad=n, e_pad=len(S) + 32 if e_pad is None else e_pad,
                edge_attr=r.normal(size=(len(S), 3)).astype(np.float32),
                y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2)


def graph_of(raw: dict) -> Graph:
    """The padded host Graph of ``raw`` (``pad_graph_np``'s arguments)."""
    return pad_graph_np(**raw)


def model_of(spec: dict):
    """A port model from ``spec``: family, sizes, knobs, weights."""
    if spec["family"] == "epd":
        model = EncodeProcessDecode(spec["blocks"], spec["node_in"], spec["edge_in"], 2,
                                    spec["hidden"], remat=spec.get("remat", False))
    else:
        model = EncodeTransformDecode(spec["blocks"], spec["node_in"], 2, spec["hidden"],
                                      spec.get("heads", 4))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state"].items()}, strict=True)
    for block in model.processor_list:
        if hasattr(block, "overlap_exchange"):
            block.overlap_exchange = spec.get("overlap", True)
    return model


def sim_of(spec: dict) -> Simulator:
    node_in = 2 + int(NodeType.SIZE)
    edge_in = spec["edge_in"]
    cfg = SimulatorConfig(node_input_size=node_in, edge_input_size=edge_in, output_size=2, **INDEX)
    return Simulator(cfg, model_of(dict(spec, node_in=node_in)), device="cpu")


def sample_graph_raw(seed: int, edge_in: int = 3, n: int = 48, e: int = 160, n_pad: int = 64,
                   e_pad: int = 192) -> dict:
    """``pad_graph_np``'s arguments of the JAX tests' ``make_test_graph``
    (by default 48 nodes, 160 random edges, padded to 64 and 192)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, size=n)
    raw = dict(x=x, pos=r.normal(size=(n, 2)).astype(np.float32),
               senders=r.integers(0, n, size=e).astype(np.int32),
               receivers=r.integers(0, n, size=e).astype(np.int32), n_pad=n_pad, e_pad=e_pad,
               edge_attr=r.normal(size=(e, 3)).astype(np.float32),
               y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2)
    if not edge_in:
        raw["edge_attr"] = None
    return raw


def probe_graph_raw(n: int, e: int, skew: bool, seed: int = 0) -> dict:
    """``pad_graph_np``'s arguments of the JAX Trainer tests'
    ``_budget_probe_graph``: a ring, or with ``skew`` every receiver in
    part 0 of a 2-way cut (the same size either way)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = 0
    pos = r.normal(size=(n, 2)).astype(np.float32)
    s = np.arange(e, dtype=np.int32) % n
    t = (np.arange(e, dtype=np.int32) % (n // 2) if skew
         else ((np.arange(e) + 1) % n).astype(np.int32))
    return dict(x=x, pos=pos, senders=s, receivers=t.astype(np.int32), n_pad=n, e_pad=e,
                edge_attr=r.normal(size=(e, 3)).astype(np.float32),
                y=np.zeros((n, 2), np.float32), node_type_index=2)


def parts_of(g: Graph, num_parts: int, mode: str, split: bool = False, wire=None) -> Graph:
    if mode == "gather":
        return partition_graph_np(g, num_parts)
    return partition_graph_halo_np(g, num_parts, split_local=split).replace(halo_dtype=wire)


def forward(rank, num_parts, case):
    part = parts_of(graph_of(case["graph"]), num_parts, case["mode"], case.get("split", False),
                    case.get("wire"))[rank]
    with torch.no_grad():
        out = graph_parallel_forward(model_of(case["model"]), part.to("cpu"))
    return {"out": gather_rows(out).numpy()}


def adamw(sim):
    return torch.optim.AdamW(sim.parameters(), lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=1e-4)


def step_result(sim, losses) -> dict:
    """The losses of a case's steps and the state after them."""
    norm = sim._node_normalizer
    return {
        "loss": losses[0],
        "losses": losses,
        "acc_count": float(norm._acc_count),
        "num_accumulations": float(norm._num_accumulations),
        "acc_sum": norm._acc_sum.numpy().copy(),
        "params": {k: v.detach().numpy().copy() for k, v in sim.model.state_dict().items()},
    }


def train_step(rank, num_parts, case):
    sim = sim_of(case["model"])
    step = make_graph_parallel_train_step(sim, adamw(sim), MASKS)
    part = parts_of(graph_of(case["graph"]), num_parts, case["mode"], case.get("split", False))
    return step_result(sim, [float(step(part[rank].to("cpu")))])


def dp_step(rank, num_parts, case):
    """``make_dp_train_step`` on the stacked batch of the case's graphs,
    ``steps`` times (every rank the same global batch), or with
    ``loader`` on the rows a ``MultihostGraphLoader`` gives this rank."""
    from graphphysics_torch.parallel.multihost import MultihostGraphLoader

    sim = sim_of(case["model"])
    step = make_dp_train_step(sim, adamw(sim), MASKS, loss_kind=case.get("loss_kind", "l2"),
                              gmm_kwargs=case.get("gmm_kwargs"), local_rows=case.get("loader", False))
    graphs = [graph_of(raw) for raw in case["graphs"]]
    if case.get("loader"):
        batch = MultihostGraphLoader(graphs, per_host_batch=len(graphs) // num_parts,
                                     shuffle=False, prefetch=0).peek()
    else:
        batch = stack_graphs(graphs)
    out = step_result(sim, [float(step(batch))])  # the state after the first step
    out["losses"] += [float(step(batch)) for _ in range(case.get("steps", 1) - 1)]
    out["final_accumulations"] = float(sim._node_normalizer._num_accumulations)
    out["groups"] = (mesh.data_rank(), mesh.data_size(), mesh.graph_rank(), mesh.graph_size())
    return out


class _Layout:
    """The 2-D ``(data, graph)`` layout for one case of a spawn started as
    one graph group; the one graph group again after it."""

    def __init__(self, data, parts):
        self.shape = (data, parts)

    def __enter__(self):
        mesh.init_layout(*self.shape)

    def __exit__(self, *exc):
        mesh.register_group(None, mesh.GRAPH_AXIS)
        mesh._GROUPS.pop(mesh.DATA_AXIS, None)


def uniform_parts(graphs, num_parts, mode, split):
    """Every graph's parts with one set of budgets (the largest of their
    trial partitions), stacked ``[B, P, ...]``, as the JAX 2-D tests cut
    them."""
    if mode == "gather":
        eb = max(partition_graph_np(g, num_parts).senders.shape[1] for g in graphs)
        return stack_graphs([partition_graph_np(g, num_parts, edge_budget_local=eb) for g in graphs])
    trials = [partition_graph_halo_np(g, num_parts, split_local=split) for g in graphs]
    if split:
        eb = (max(t.num_local_edges for t in trials),
              max(t.senders.shape[1] - t.num_local_edges for t in trials))
    else:
        eb = max(t.senders.shape[1] for t in trials)
    hb = max(t.halo_send_idx.shape[2] for t in trials)
    return stack_graphs([partition_graph_halo_np(g, num_parts, edge_budget_local=eb, halo_budget=hb,
                                                 split_local=split) for g in graphs])


def dp2d_step(rank, num_parts, case):
    """``make_dp_graph_parallel_train_step`` over a ``D x P`` layout: the
    case's ``D`` graphs cut into ``P`` parts each; rank ``(d, p)`` steps on
    its ``[1, 1, ...]`` shard, twice."""
    data, parts = case["layout"]
    with _Layout(data, parts):
        sim = sim_of(case["model"])
        step = make_dp_graph_parallel_train_step(sim, adamw(sim), MASKS)
        stacked = uniform_parts([graph_of(raw) for raw in case["graphs"]], parts, case["mode"],
                                case.get("split", False))
        d, p = rank // parts, rank % parts
        shard = stacked._map(lambda a: a[d:d + 1, p:p + 1])
        out = step_result(sim, [float(step(shard))])  # the state after the first step
        out["losses"] += [float(step(shard)) for _ in range(case.get("steps", 1) - 1)]
        try:
            step(stacked._map(lambda a: a[d:d + 1]))  # [1, P, ...]: refused
        except ValueError as e:
            out["refused"] = str(e)
    return out


def rollout(rank, num_parts, case):
    sim = sim_of(case["model"])
    frames = [graph_of(raw) for raw in case["frames"]]
    halo = case["mode"] == "halo"
    parts = partition_frames_np(frames, num_parts, halo=halo, split_local=case.get("split", False))
    preds, targets = partitioned_rollout(sim, part_of(parts, rank, axis=1), device="cpu")
    return {"preds": preds.numpy(), "targets": targets.numpy()}


def fit(rank, num_parts, case):
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import get_dataset, get_preprocessing
    from graphphysics_torch.training.trainer import Trainer

    losses = {}
    for overlap in (True, False):
        param = case["param"]
        ds = get_dataset(param, get_preprocessing(param))
        loader = GraphLoader(ds, batch_size=2, shuffle=True, prefetch=0)
        tr = Trainer(param, learning_rate=1e-3, warmup=2, graph_partition=num_parts,
                     partition_overlap_attention=overlap, device="cpu",
                     checkpoint_dir=str(Path(case["dir"]) / f"ck_{overlap}"), metrics_path=None,
                     rollout_dir=None, log_every=5, progress=False)
        history = tr.fit(loader, num_epochs=2)
        losses[overlap] = {"train_loss": history["train_loss"], "split": tr._split_attention(),
                           "host_ms": list(tr.host_ms)}
    return losses


def dp_fit(rank, num_parts, case):
    """``Trainer(data_parallel=True)`` (with ``graph_partition`` in the 2-D
    layout) for ``epochs`` epochs over the case's loader, then its
    validation with ``parallel_validation`` off and on (and of a GMM
    head's Trainer, which validates from its initial weights)."""
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.parallel.multihost import MultihostGraphLoader
    from graphphysics_torch.training import get_dataset, get_preprocessing
    from graphphysics_torch.training.trainer import Trainer

    param, parts = case["param"], case.get("graph_partition", 0)

    def trainer(p, **kw):
        return Trainer(p, learning_rate=1e-3, warmup=2, data_parallel=True, graph_partition=parts,
                       num_devices=num_parts, device="cpu", metrics_path=None, rollout_dir=None,
                       log_every=1, progress=False, **case.get("trainer", {}), **kw)

    ds = get_dataset(param, get_preprocessing(param))
    val = None
    if case.get("val"):
        val = get_dataset(param, get_preprocessing(param, remove_noise=True), switch_to_val=True)
    with _Layout(num_parts // parts, parts) if parts else contextlib.nullcontext():
        if case.get("loader") == "multihost":  # the rows of this rank's data row
            rows = num_parts // max(parts, 1)
            loader = MultihostGraphLoader(ds, per_host_batch=case["batch_size"] // rows,
                                          shuffle=True, seed=3, prefetch=0)
        else:
            loader = GraphLoader(ds, batch_size=case["batch_size"], shuffle=True, seed=3,
                                 prefetch=0, collate="stack")
        tr = trainer(param, checkpoint_dir=str(Path(case["dir"]) / "ck"), seed=5)
        history = tr.fit(loader, val_dataset=val, num_epochs=case["epochs"])
        out = {"history": history, "places": (tr.world_rank, tr.data_rank, tr.rank),
               "is_writer": tr.is_writer, "host_ms": list(tr.host_ms)}
        if val is not None:
            for on in (False, True):
                tr.parallel_validation = on
                out[("validate", on)] = (tr.validate(val, save_rollout=False), tr.last_val_loss)
        if val is not None and case.get("gmm", True):
            gmm = {**param, "model": {**param["model"], "num_mixture_components": 2}}
            tg = trainer(gmm, checkpoint_dir=str(Path(case["dir"]) / "ck_gmm"), seed=5)
            tg.init_state(num_steps=4)
            for on in (False, True):
                tg.parallel_validation = on
                out[("validate_gmm", on)] = tg.validate(val, save_rollout=False)
    return out


def dp2d_growth(rank, num_parts, case):
    """Budget growth in the 2-D layout: each data row cuts its own graph, so
    a row whose graph exceeds the budgets grows its own (its two ranks
    agreeing) while the other row keeps them; the steps run on."""
    from graphphysics_torch.training.trainer import Trainer

    with _Layout(2, 2):
        tr = Trainer(case["param"], data_parallel=True, graph_partition=2, num_devices=num_parts,
                     partition_edge_headroom=1.0, device="cpu", metrics_path=None,
                     rollout_dir=None, checkpoint_dir=str(Path(case["dir"]) / "ck"), progress=False)
        tr.init_state(num_steps=4)
        out = {"losses": [], "edge_slots": []}
        for raws in case["batches"]:
            batch = stack_graphs([graph_of(raw) for raw in raws])
            out["losses"].append(float(tr.train_step(batch)))
            key = next(iter(tr._part_budgets))
            out["edge_slots"].append(tr._part_budgets[key])
    return out


RUNNERS = {"forward": forward, "train_step": train_step, "rollout": rollout, "fit": fit,
           "dp_step": dp_step, "dp2d_step": dp2d_step, "dp_fit": dp_fit, "dp2d_growth": dp2d_growth}


def run_cases(rank: int, directory: str) -> str:
    """Run the pickled cases of ``directory/cases.pkl`` on this rank and
    write ``directory/rank{rank}.pkl``; returns its path."""
    with open(Path(directory) / "cases.pkl", "rb") as f:
        num_parts, cases = pickle.load(f)
    results = {name: RUNNERS[case["kind"]](rank, num_parts, case) for name, case in cases.items()}
    path = Path(directory) / f"rank{rank}.pkl"
    with open(path, "wb") as f:
        pickle.dump(results, f)
    return str(path)

