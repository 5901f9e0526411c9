"""Rank functions of the multi-rank partition tests
(``test_torch_port_partition_ranks.py``). Each spawned gloo rank
(``parallel.mesh.launch``) loads the case list the parent pickled, runs
every case on its part and writes its results to ``rank{r}.pkl`` beside
it; the parent compares them with the JAX package. This module imports
neither JAX nor the JAX package (the ranks run the port alone)."""

import pickle
from pathlib import Path

import numpy as np
import torch

from graphphysics_torch.core.graph import Graph, pad_graph_np
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.models import (
    EncodeProcessDecode,
    EncodeTransformDecode,
    Simulator,
    SimulatorConfig,
)
from graphphysics_torch.parallel.dp import (
    gather_rows,
    graph_parallel_forward,
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


def raw_graph(n=256, seed=0) -> dict:
    """``pad_graph_np``'s arguments for a symmetric random graph of ``n``
    nodes (the JAX partition tests' ``_mesh_graph``)."""
    r = np.random.default_rng(seed)
    s = r.integers(0, n, 3 * n).astype(np.int32)
    t = (s + r.integers(1, 16, 3 * n)).astype(np.int32) % n
    S, R = to_undirected(s, t)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    return dict(x=x, pos=r.normal(size=(n, 2)).astype(np.float32), senders=np.asarray(S),
                receivers=np.asarray(R), n_pad=n, e_pad=len(S) + 32,
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


def train_step(rank, num_parts, case):
    sim = sim_of(case["model"])
    opt = torch.optim.AdamW(sim.parameters(), lr=1e-3, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=1e-4)
    step = make_graph_parallel_train_step(sim, opt, MASKS)
    part = parts_of(graph_of(case["graph"]), num_parts, case["mode"], case.get("split", False))
    loss = step(part[rank].to("cpu"))
    norm = sim._node_normalizer
    return {
        "loss": float(loss),
        "acc_count": float(norm._acc_count),
        "num_accumulations": float(norm._num_accumulations),
        "acc_sum": norm._acc_sum.numpy().copy(),
        "params": {k: v.detach().numpy().copy() for k, v in sim.model.state_dict().items()},
    }


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


RUNNERS = {"forward": forward, "train_step": train_step, "rollout": rollout, "fit": fit}


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

