"""Rank functions of the tensor-parallel, pipeline, hybrid-layout and
partitioned-export tests (``test_torch_port_tp.py``,
``test_torch_port_pp.py``, ``test_torch_port_hybrid_layout.py``,
``test_torch_port_export_partitioned.py``). Each spawned gloo rank
(``parallel.mesh.launch``) runs the cases the parent passes and returns
its results; the parent compares them with the JAX package. This module
imports neither JAX nor the JAX package (the ranks run the port alone)."""

import torch

from graphphysics_torch.core.graph import Graph, concat_graphs, stack_graphs
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.models import (
    EncodeProcessDecode,
    EncodeTransformDecode,
    Simulator,
    SimulatorConfig,
)
from graphphysics_torch.parallel import mesh, pp, tp
from graphphysics_torch.parallel.dp import gather_rows, graph_parallel_forward
from graphphysics_torch.parallel.graph_partition import part_of
from graphphysics_torch.training.losses import make_local_loss

MASKS = (int(NodeType.NORMAL), int(NodeType.OUTFLOW))
INDEX = dict(feature_index_start=0, feature_index_end=2, output_index_start=0,
             output_index_end=2, node_type_index=2)
STEPS = 3


def build_sim(spec: dict) -> Simulator:
    """A port Simulator on the CPU from ``spec``: family, blocks, hidden,
    heads, K and ``use_diagonal``, ``scan_blocks``, ``remat``,
    ``project_before_gather``, the weights
    (``state``, reference names under ``model.``; random from the seed
    without) and the normalizers' statistics (``stats``)."""
    node_in = 2 + int(NodeType.SIZE)
    edge_in = 3 if spec["family"] == "epd" else 0
    knobs = dict(num_mixture_components=spec.get("K", 0), use_diagonal=spec.get("diagonal", True),
                 scan_blocks=spec.get("scan_blocks", False), remat=spec.get("remat", False))
    if spec["family"] == "epd":
        model = EncodeProcessDecode(spec["blocks"], node_in, edge_in, 2, spec["hidden"], **knobs,
                                    project_before_gather=spec.get("project_before_gather", False))
    else:
        model = EncodeTransformDecode(spec["blocks"], node_in, 2, spec["hidden"],
                                      spec.get("heads", 4), **knobs)
    cfg = SimulatorConfig(node_input_size=node_in, edge_input_size=edge_in, output_size=2, **INDEX)
    sim = Simulator(cfg, model, device="cpu")
    if "state" in spec:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["state"].items()},
                              strict=True)
    for name, value in spec.get("stats", {}).items():
        sim.get_buffer(name).copy_(torch.from_numpy(value))
    return sim


def sgd(sim):
    """SGD with momentum: the JAX parity tests' ``optax.sgd(1e-2,
    momentum=0.9)`` (Adam's first update is about sign(grad), which
    round-off flips)."""
    return torch.optim.SGD(sim.parameters(), lr=1e-2, momentum=0.9)


def loss_kind(spec: dict):
    if not spec.get("K"):
        return "l2", None
    return ("diag_gmm" if spec.get("diagonal", True) else "full_gmm"), dict(d=2, K=spec["K"],
                                                                            temperature=1.0)


def numpy_state(state: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def single_step(spec: dict, graph: Graph) -> dict:
    """The single-process step on ``graph`` (host arrays): the loss and the
    state after it, the reference of every parallel step."""
    sim = build_sim(spec)
    opt = sgd(sim)
    graph = graph.to("cpu")
    local_loss = make_local_loss(list(MASKS), *loss_kind(spec))
    out, target, _ = sim(graph, is_training=True)
    loss_sum, count = local_loss(target, out, sim.node_type(graph), graph.node_mask,
                                 graph.exclude_mask)
    loss = loss_sum / torch.clamp(count, min=1.0)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {"loss": float(loss.detach()), "state": numpy_state(sim.state_dict())}


def tp_case(rank, case):
    """``make_tp_train_step`` on the case's concatenated graphs: the first
    step's loss and full state, then ``STEPS - 1`` more with the local
    shapes of the parameters and momenta after each, and the refusal of a
    partitioned graph."""
    sim = build_sim(case["spec"])
    opt = sgd(sim)
    specs = tp.shard_tp_state(sim, opt)
    step = tp.make_tp_train_step(sim, opt, MASKS, loss_kind=loss_kind(case["spec"])[0],
                                 gmm_kwargs=loss_kind(case["spec"])[1])
    graph = concat_graphs(case["graphs"]).to("cpu")
    params = list(sim.parameters())
    out = {"loss": float(step(graph)), "state": numpy_state(tp.gather_tp_state_dict(sim)),
           "grads": numpy_state(tp.gather_tp_state_dict(sim, grads=True)), "layouts": [],
           "sharded": sorted(k for k, v in specs.items() if v is not None), "losses": []}
    for _ in range(STEPS - 1):
        calls = tp.ALL_REDUCES["calls"]
        out["losses"].append(float(step(graph)))
        out["layouts"].append({
            "params": [tuple(p.shape) for p in sim.parameters()],
            "same_objects": all(a is b for a, b in zip(params, sim.parameters())),
            "optimizer_params": all(a is b for a, b in zip(params, opt.param_groups[0]["params"])),
            "momenta": [tuple(opt.state[p]["momentum_buffer"].shape) for p in params],
            "all_reduces": tp.ALL_REDUCES["calls"] - calls,
        })
    try:
        step(graph.replace(partition_axis=mesh.GRAPH_AXIS))
    except ValueError as e:
        out["refused"] = str(e)
    return out


def pp_case(rank, case):
    """``make_pp_train_step`` on the case's stacked microbatches: the first
    step's loss and full state, the ring shifts a step, ``STEPS - 1`` more
    losses, and the refusal of partitioned microbatches."""
    spec = dict(case["spec"], scan_blocks=True)
    sim = build_sim(spec)
    opt = sgd(sim)
    stage = pp.shard_pp_state(sim, opt)
    step = pp.make_pp_train_step(sim, opt, MASKS)
    mbs = stack_graphs(case["graphs"]).to("cpu")
    calls = pp.SHIFTS["calls"]
    out = {"loss": float(step(mbs)), "shifts": pp.SHIFTS["calls"] - calls,
           "stage": tuple(stage), "state": numpy_state(pp.gather_pp_state_dict(sim)),
           "local_blocks": len(sim.model.processor_list)}
    out["losses"] = [float(step(mbs)) for _ in range(STEPS - 1)]
    try:
        step(mbs.replace(partition_axis=mesh.GRAPH_AXIS))
    except ValueError as e:
        out["refused"] = str(e)
    return out


def dp2d_case(rank, case):
    """The 2-D step twice on the hybrid layout the spawn laid out: this
    rank's places and losses."""
    from graphphysics_torch.parallel.dp import make_dp_graph_parallel_train_step

    sim = build_sim(case["spec"])
    step = make_dp_graph_parallel_train_step(sim, sgd(sim), MASKS)
    d, p = mesh.data_rank(), mesh.graph_rank()
    shard = case["parts"]._map(lambda a: a[d:d + 1, p:p + 1]).to("cpu")
    return {"places": (d, p), "sizes": (mesh.data_size(), mesh.graph_size()),
            "losses": [float(step(shard)) for _ in range(2)]}


def export_case(rank, case):
    """Load the case's partitioned artifact and run it on this rank's part:
    the gathered rows, and the live ``graph_parallel_forward``'s; a GMM
    artifact draws from a per-rank generator, as does the live eval."""
    from graphphysics_torch.utils.export import load_partitioned_eval_step

    part = part_of(case["parts"], rank).to("cpu")
    try:
        step = load_partitioned_eval_step(case["blob"])
    except ValueError as e:
        return {"refused": str(e)}
    sim = build_sim(case["spec"])
    sim.eval()
    seed = 100 + rank
    out = {"num_parts": step.num_parts}
    generator = torch.Generator().manual_seed(seed) if case["spec"].get("K") else None
    out["exported"] = gather_rows(step(part, generator=generator)).numpy()
    generator = torch.Generator().manual_seed(seed) if case["spec"].get("K") else None
    with torch.no_grad():
        live = graph_parallel_forward(sim, part, is_training=False, generator=generator)[2]
    out["live"] = gather_rows(live).numpy()
    return out


RUNNERS = {"tp": tp_case, "pp": pp_case, "dp2d": dp2d_case, "export": export_case}


def run_cases(rank: int, cases: dict) -> dict:
    """Every case of ``cases`` (name: a dict with its ``kind``) on this
    rank."""
    return {name: RUNNERS[case["kind"]](rank, case) for name, case in cases.items()}


def stats_of(sim) -> dict:
    """The normalizers' statistics of ``sim`` by buffer name."""
    return {name: buf.detach().cpu().numpy().copy() for name, buf in sim.named_buffers()}

