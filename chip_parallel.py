"""The data-parallel phases of ``chip_smoke.py`` (run from it, on one CUDA
card; this module starts nothing on import):

- ``dp_epd_training``: ``cylinder.json`` (EncodeProcessDecode 15 x 128) on
  the 8 x 2,048 batch of ``epd_training`` (``chip_smoke.flagship_graphs``),
  stacked, as ``Trainer(data_parallel=True)`` on 2 ranks sharing the card
  (gloo), 4 graphs a rank: the first step (loss, and rank 0's summed
  gradients) against the single-process step on the 8 graphs concatenated
  from the same weights (``chip_partition.compare_step``, limits
  ``chip_smoke.STEP_LOSS_RTOL`` and ``EPD_GRAD_RTOL``), then 2 warm-up and
  3 timed steps with every launch count zeroed just before them (K1 and
  K1b, 15 each a step and rank), and a profile of 2 steps on rank 0 (its
  device ms, and the host ms of the collectives, the gradients'
  all-reduce among them);
- ``dp_transformer_training``: ``panels.json`` (15 x 128, 4 heads) on the
  panels batch (``chip_smoke.panels_graphs``), the same checks with
  ``TRANSFORMER_GRAD_RTOL``; the fused f32 pair, 15 each a step and rank;
- ``dp_2d_training``: 4 ranks, 2 data rows of 2 parts
  (``Trainer(data_parallel=True, graph_partition=2, num_devices=4)``): the
  EPD on two 16,384-node meshes (``chip_partition.mesh_graph``) in halo
  mode, K1 and K1b 15 each a step and rank; ``coarse-aneurysm.json`` (the
  transformer 10 x 64, 4 heads) on two 32,768-node tetrahedral meshes
  (``tet_grid(32)``, 434,558 edges each, 15 features) in the split-edge
  layout, K5 forward and backward 10 each; each first step against the
  1-D data-parallel step on the unpartitioned meshes (one a rank of the
  2-rank spawn), with ``chip_partition``'s partitioned limits; 2 warm-up
  and 3 timed steps; the 4 ranks laid out by ``make_hybrid_layout`` (the
  data axis across 2 emulated hosts, each graph group inside one), the
  rank grid in the phase's line;
- ``dp_validation``: on the 2-rank spawn, the EPD Trainer's ``validate``
  over two 8-frame 2,048-node trajectories with ``parallel_validation``
  off and on: the RMSE and ``val_loss`` equal to 1e-12 relative on every
  rank (bitwise is expected: the forward kernels have no atomics, and two
  trajectories sum in the same order either way).

The ranks time-share one card: a rank's ms a step is 2 or 4 processes'
wall time on one H100 plus gloo's all-reduce through the host, not a
scaling figure.

``start_multirank`` runs these phases, ``chip_partition``'s and
``chip_model_parallel``'s, and the short fidelity runs in a second process
beside ``chip_smoke.py``'s own phases (``finish_multirank`` prints its
lines); the card and the host are shared with those too.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
import time

import numpy as np
import torch

# 3 timed steps, cut from 5 to keep chip_smoke.py inside its time limit
WARMUP, TIMED, PROFILED = 2, 3, 2
RANKS, LAYOUT_2D = 2, (2, 2)
HYBRID_DCN, HYBRID_ICI = (2, 1), (1, 2)  # LAYOUT_2D as make_hybrid_layout factors it
ANEURYSM_CONFIG = "training_config/coarse-aneurysm.json"
ANEURYSM_GRID = 32  # tet_grid(32): 32,768 nodes
RANKS_TIMEOUT_S = 600
MULTIRANK_TIMEOUT_S = 1100  # the second process of chip_smoke.py, every phase in it
VALIDATION_RTOL = 1e-12
VALIDATION_TRAJECTORIES = 2


def _cs():
    import chip_smoke

    return chip_smoke


def _cp():
    import chip_partition

    return chip_partition


def aneurysm_mesh_graph(seed):
    """One connected symmetric tetrahedral mesh (``tet_grid(32)``) with the
    aneurysm layout: 14 random features, the node type at index 14, 3
    outputs, sender-sorted (CSR) for the transformer."""
    from graphphysics_torch.core import pad_graph_csr_np, round_up
    from graphphysics_torch.topology import cells_to_edges
    from graphphysics_torch.utils.synthetic import tet_grid

    pos, tets = tet_grid(ANEURYSM_GRID)
    senders, receivers = cells_to_edges(tets)
    n, e = len(pos), len(senders)
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 15)).astype(np.float32)
    x[:, 14] = r.integers(0, 7, size=n)
    return pad_graph_csr_np(x, pos[:, :2].astype(np.float32), np.asarray(senders, np.int32),
                            np.asarray(receivers, np.int32), round_up(n, 128),
                            round_up(int(e * 1.05), 128),
                            y=r.normal(size=(n, 3)).astype(np.float32), node_type_index=14)


def _trainer(param, seed, total_steps, **kw):
    from graphphysics_torch.training import Trainer

    tr = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda", metrics_path=None,
                 rollout_dir=None, checkpoint_dir=tempfile.mkdtemp(prefix="dp_ck_"), progress=False,
                 data_parallel=True, **kw)
    tr.init_state(total_steps)
    return tr


def _profile(step, device, steps=PROFILED) -> dict:
    """Where a rank's step goes over ``steps`` steps: the card's time and
    the host time of the collectives (``c10d::`` calls: the statistics',
    loss counts' and gradients' all-reduces; in the 2-D layout the halo
    exchanges too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / steps * 1e3
    rows = prof.key_averages()
    collective = {r.key: r.cpu_time_total / 1e3 / steps for r in rows
                  if r.key.startswith("c10d::") or r.key == "halo.wait"}
    device_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]

    def us(r):
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0.0)

    return {
        "profiled_steps": steps,
        "wall_ms_per_step": wall,
        "collective_host_ms_per_step": sum(collective.values()),
        "allreduce_host_ms_per_step": sum(v for k, v in collective.items() if "allreduce" in k),
        "collectives": collective,
        "device_ms_per_step": (sum(us(r) for r in device_rows) / 1e3 / steps
                               if device_rows else "not measured"),
    }


def _steps(rank, tr, step, device) -> dict:
    """A rank's first step (its loss, and rank 0's summed gradients), then
    WARMUP steps and TIMED timed ones with every launch count zeroed just
    before them, then a profile of PROFILED steps (rank 0 traced, the
    others stepping alongside)."""
    import torch.distributed as dist

    counts = _cp()._counters()
    first = step().item()
    grads = ({n: p.grad.detach().cpu().numpy() for n, p in tr.sim.named_parameters()}
             if rank == 0 else None)
    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [step() for _ in range(TIMED)]
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    if rank == 0:
        breakdown = _profile(step, device)
    else:
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize(device)
        breakdown = None
    return {"first_loss": first, "grads": grads, "losses": [x.item() for x in losses],
            "ms_per_step": seconds / TIMED * 1e3, "launches": launches, "peak_memory_gb": peak,
            "host_ms_per_step": float(np.mean(tr.host_ms[-TIMED:])) if tr.host_ms else None,
            "breakdown": breakdown}


def _first_step_only(tr, batch) -> dict:
    """One step of a fresh data-parallel trainer: the reference of a 2-D
    case (its loss, and the summed gradients)."""
    loss = tr.train_step(batch).item()
    return {"first_loss": loss,
            "grads": {n: p.grad.detach().cpu().numpy() for n, p in tr.sim.named_parameters()}}


def _validation(tr, val_ds) -> dict:
    out = {}
    for on in (False, True):
        tr.parallel_validation = on
        t0 = time.perf_counter()
        rmse = tr.validate(val_ds, save_rollout=False)
        out[on] = {"rmse": rmse, "val_loss": tr.last_val_loss, "s": time.perf_counter() - t0}
    return out


def rank_main(rank, spec_path):
    """A chip rank: the spec's data-parallel (or 2-D) cases on the shared
    card; writes and returns the path of its results."""
    import torch.distributed as dist

    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.parallel.dp import rank_rows
    from graphphysics_torch.parallel.mesh import group_backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    device = torch.device("cuda", torch.cuda.current_device())
    total = 1 + WARMUP + TIMED + PROFILED
    out = {"backend": group_backend("data"), "world": dist.get_world_size()}
    for name, case in spec["cases"].items():
        batch = stack_graphs(case["graphs"])
        tr = _trainer(case["param"], spec["seed"], total, **case.get("trainer", {}))
        if case.get("reference"):
            out[name] = _first_step_only(tr, batch)
        elif tr.graph_partition:  # the 2-D layout: each step cuts the row's graph on the host
            out[name] = _steps(rank, tr, lambda: tr.train_step(batch), device)
        else:  # the rank's rows on the card, as the kernels' phases time steps
            rows = rank_rows(batch).to(device)
            out[name] = _steps(rank, tr, lambda: tr.train_step(rows, local_rows=True), device)
        if case.get("validate"):
            out[f"{name}:validation"] = _validation(tr, spec["val"])
        del tr
        torch.cuda.empty_cache()
    if spec.get("model_parallel"):  # chip_model_parallel's 2-rank phases
        from chip_model_parallel import run_cases

        out["model_parallel"] = run_cases(rank, **spec["model_parallel"])
    path = f"{spec_path}.rank{rank}"
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


def _spawn(spec, num_ranks, layout, tmp, label, target=None):
    """Run ``target`` (this module's ``rank_main`` unless named) in
    ``num_ranks`` ranks on the card with ``spec`` pickled under ``tmp``;
    returns each rank's results and the seconds the spawn took."""
    from graphphysics_torch.parallel.mesh import launch

    spec_path = os.path.join(tmp, f"{label}.pkl")
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    t0 = time.perf_counter()
    paths = launch(target or rank_main, num_ranks, "cuda", args=(spec_path,),
                   timeout=RANKS_TIMEOUT_S, layout=layout)
    seconds = time.perf_counter() - t0
    ranks = []
    for path in paths:
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, seconds


def _summary(name, ranks, expected, num_ranks, timed=TIMED):
    """Every rank's ``timed`` steps: launches per step and rank against
    ``expected``, finite losses equal on every rank, the times."""
    want = {k: expected.get(k, 0) * timed for k in ranks[0]["launches"]}
    for r, res in enumerate(ranks):
        if res["launches"] != want:
            raise AssertionError(f"{name}: rank {r} launched {res['launches']} in {timed} steps, "
                                 f"expected {want}")
        if res["losses"] != ranks[0]["losses"] or not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"{name}: rank {r} losses {res['losses'][:3]}... differ or not "
                                 f"finite")
    return {
        "ranks": num_ranks,
        "ms_per_step_per_rank": [res["ms_per_step"] for res in ranks],
        "host_partition_ms_per_step_per_rank": [res.get("host_ms_per_step") for res in ranks],
        "peak_memory_gb_per_rank": [res["peak_memory_gb"] for res in ranks],
        "launches_per_step_per_rank": {k: v / timed for k, v in ranks[0]["launches"].items() if v},
        "launches": {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]},
        "first_loss": ranks[0]["first_loss"], "last_loss": ranks[0]["losses"][-1],
        "rank0_breakdown": ranks[0]["breakdown"],
    }


def parallel_phases(clock, seed, cylinder, panels, model_parallel=None):
    """Every data-parallel phase, the 2-rank spawn running
    ``model_parallel`` (``chip_model_parallel.prepare``'s 2-rank cases)
    after its own; returns ``{path: launches}`` for the kernels line and
    each rank's results of ``model_parallel``."""
    import json

    from graphphysics_torch.core import concat_graphs
    from graphphysics_torch.utils.synthetic import cylinder_trajectory

    from graphphysics_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, make_hybrid_layout

    cs, cp = _cs(), _cp()
    total = 1 + WARMUP + TIMED + PROFILED
    # the 2-D layout across hosts: the data axis over two (emulated) hosts,
    # each graph group inside one
    hybrid = make_hybrid_layout((DATA_AXIS, GRAPH_AXIS), dcn_shape=HYBRID_DCN, ici_shape=HYBRID_ICI,
                                world_size=LAYOUT_2D[0] * LAYOUT_2D[1])
    with open(ANEURYSM_CONFIG) as f:
        aneurysm = json.load(f)
    cyl_graphs, tf_graphs = cs.flagship_graphs(seed), cs.panels_graphs(seed + 200)
    epd_meshes = [cp.mesh_graph("sorted", seed + 600 + k) for k in range(2)]
    tet_meshes = [aneurysm_mesh_graph(seed + 700 + k) for k in range(2)]
    # the single-process steps the 1-D data-parallel first steps are held to
    ref = {"epd": cp.unpartitioned_steps(cylinder, concat_graphs(cyl_graphs), seed, total),
           "transformer": cp.unpartitioned_steps(panels, concat_graphs(tf_graphs), seed, total)}
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="dp_ranks_") as tmp:
        _, val_ds = cs.memory_datasets(cylinder, cylinder_trajectory, seed, tmp,
                                       n_traj=VALIDATION_TRAJECTORIES)
        val_frames = val_ds.frames_per_trajectory
        spec = {"seed": seed, "val": val_ds, "cases": {
            "epd": dict(param=cylinder, graphs=cyl_graphs, validate=True),
            "transformer": dict(param=panels, graphs=tf_graphs),
            "epd_2d_reference": dict(param=cylinder, graphs=epd_meshes, reference=True),
            "transformer_2d_reference": dict(param=aneurysm, graphs=tet_meshes, reference=True),
        }, "model_parallel": model_parallel}
        ranks, ranks_s = _spawn(spec, RANKS, (RANKS, 1), tmp, "dp")
        spec2d = {"seed": seed, "cases": {
            "epd_2d": dict(param=cylinder, graphs=epd_meshes,
                           trainer=dict(graph_partition=LAYOUT_2D[1], num_devices=4)),
            "transformer_2d": dict(param=aneurysm, graphs=tet_meshes,
                                   trainer=dict(graph_partition=LAYOUT_2D[1], num_devices=4)),
        }}
        ranks2d, ranks2d_s = _spawn(spec2d, 4, hybrid, tmp, "dp2d")

    paths = {}
    backend = ranks[0]["backend"]
    for fam, param, grad_rtol, kernels in (
            ("epd", cylinder, cs.EPD_GRAD_RTOL, ("csr_segment_sum", "csr_segment_sum_backward")),
            ("transformer", panels, cs.TRANSFORMER_GRAD_RTOL,
             ("csr_attention", "csr_attention_backward"))):
        name = f"dp_{fam}_training"
        per_rank = [r[fam] for r in ranks]
        blocks = param["model"]["message_passing_num"]
        summary = _summary(name, per_rank, {k: blocks for k in kernels}, RANKS)
        summary.update(cp.compare_step(name, ref[fam], per_rank[0], cs.STEP_LOSS_RTOL, grad_rtol))
        paths[name] = summary["launches"]
        clock.emit({"phase": name, "model": f"{param['model']['type']} "
                    f"{param['model']['message_passing_num']}x{param['model']['hidden_size']}",
                    "graphs": 8, "graphs_per_rank": 8 // RANKS, "backend": backend,
                    "ranks_share_one_card": True, "ranks_s": ranks_s,
                    "single_process_ms_per_step": ref[fam][2], **summary})

    result2d = {}
    for fam, param, grad_rtol, blocks, kernels in (
            ("epd", cylinder, cs.EPD_GRAD_RTOL, cylinder["model"]["message_passing_num"],
             ("csr_segment_sum", "csr_segment_sum_backward")),
            ("transformer", aneurysm, cp.PARTITIONED_TRANSFORMER_GRAD_RTOL,
             aneurysm["model"]["message_passing_num"],
             ("csr_softmax_spmm_pair", "csr_softmax_spmm_pair_backward"))):
        name = f"dp_2d_training:{fam}"
        per_rank = [r[f"{fam}_2d"] for r in ranks2d]
        summary = _summary(name, per_rank, {k: blocks for k in kernels}, 4)
        reference = ranks[0][f"{fam}_2d_reference"]
        summary.update(cp.compare_step(name, (reference["first_loss"], reference["grads"]),
                                       per_rank[0], cs.STEP_LOSS_RTOL, grad_rtol))
        paths[name] = summary["launches"]
        result2d[fam] = {"config": cs.CYLINDER_CONFIG if fam == "epd" else ANEURYSM_CONFIG,
                         "graph": (f"triangulated_grid{cp.MESH}, {epd_meshes[0].num_nodes} nodes"
                                   if fam == "epd" else
                                   f"tet_grid({ANEURYSM_GRID}), {tet_meshes[0].num_nodes} nodes, "
                                   f"{int(tet_meshes[0].edge_mask.sum())} edges"),
                         "layout": "halo" if fam == "epd" else "split-edge halo", **summary}
    clock.emit({"phase": "dp_2d_training", "data_rows": LAYOUT_2D[0], "parts": LAYOUT_2D[1],
                "layout": {"make_hybrid_layout": {"dcn_shape": HYBRID_DCN, "ici_shape": HYBRID_ICI},
                           "rank_grid": hybrid.grid.tolist()},
                "backend": ranks2d[0]["backend"], "ranks_share_one_card": True,
                "ranks_s": ranks2d_s, "reference": "the 1-D data-parallel step on the "
                "unpartitioned graphs, 2 ranks", **result2d})

    validation = [r["epd:validation"] for r in ranks]
    for r, v in enumerate(validation):
        seq, par = v[False], v[True]
        for key in ("rmse", "val_loss"):
            if abs(par[key] - seq[key]) > VALIDATION_RTOL * abs(seq[key]) or not math.isfinite(par[key]):
                raise AssertionError(f"dp_validation: rank {r} {key} parallel {par[key]} vs "
                                     f"sequential {seq[key]}")
        if (par["rmse"], par["val_loss"]) != (validation[0][True]["rmse"],
                                              validation[0][True]["val_loss"]):
            raise AssertionError(f"dp_validation: rank {r} reads {par}, rank 0 {validation[0][True]}")
    clock.emit({"phase": "dp_validation", "trajectories": VALIDATION_TRAJECTORIES,
                "frames_per_trajectory": val_frames, "ranks": RANKS,
                "sequential": validation[0][False], "parallel": validation[0][True],
                "bitwise": all(v[True]["rmse"] == v[False]["rmse"]
                               and v[True]["val_loss"] == v[False]["val_loss"] for v in validation),
                "tolerance": {"rtol": VALIDATION_RTOL}})
    return paths, [r.get("model_parallel") for r in ranks]


def _multirank_main(out_path, log_path, seed, cylinder, panels, epd_frames, tf_frames, fidelity_configs):
    """The second process of ``chip_smoke.py``: the phases that start ranks
    (``chip_partition.partition_phases``, then the data-, tensor- and
    pipeline-parallel ones) and the short fidelity runs, with counters of
    its own. Its standard output, its ranks' and its commands' go to
    ``log_path``; its phase lines and launches, or its traceback, to
    ``out_path``."""
    import signal
    import sys
    import traceback

    os.setsid()  # one process group with every process it starts, stopped together
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))  # the ranks' launch stops them
    log = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    os.dup2(log, 1)
    cs = _cs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    lines = []
    clock = cs.PhaseClock(sink=lines.append)
    out = {"lines": lines}
    try:
        from chip_model_parallel import model_parallel_phases, prepare
        from chip_partition import partition_phases

        counts = cs.kernel_counters()
        fidelity = {}
        for config in fidelity_configs:
            label = f"{config}_fidelity_short"
            fidelity[label] = cs.fidelity_short(label, counts, config)
            clock.emit({"phase": label, **fidelity[label]})
        partition_paths = partition_phases(clock, seed, cylinder, panels, epd_frames, tf_frames)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="model_parallel_") as mp_tmp:
            mp = prepare(seed, cylinder, panels, mp_tmp)
            dp_paths, mp_ranks = parallel_phases(clock, seed, cylinder, panels, mp["two_rank"])
            torch.cuda.empty_cache()
            mp_paths = model_parallel_phases(clock, mp, mp_ranks, mp_tmp)
        out["paths"] = {**fidelity, **{p: {"launches": launched} for p, launched in
                                       {**partition_paths, **dp_paths, **mp_paths}.items()}}
    except BaseException:
        out["error"] = traceback.format_exc()
    sys.stdout.flush()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def start_multirank(tmp, seed, cylinder, panels, epd_frames, tf_frames, fidelity_configs):
    """Start ``_multirank_main`` in a process of its own, beside the
    caller's phases; returns the handle ``finish_multirank`` and
    ``stop_multirank`` take."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_path, log_path = os.path.join(tmp, "multirank.pkl"), os.path.join(tmp, "multirank.log")
    proc = ctx.Process(target=_multirank_main, args=(out_path, log_path, seed, cylinder, panels,
                                                     epd_frames, tf_frames, fidelity_configs))
    proc.start()
    return proc, out_path, log_path


def finish_multirank(handle, timeout=MULTIRANK_TIMEOUT_S) -> dict:
    """Wait for the second process, print its standard output and then its
    phase lines (each with the seconds it took there), raise with its
    traceback if it failed; returns its paths' results by name."""
    import sys

    proc, out_path, log_path = handle
    proc.join(timeout)
    if proc.is_alive():
        raise TimeoutError(f"the multi-rank phases did not finish within {timeout} s")
    if os.path.exists(log_path):
        with open(log_path) as f:
            sys.stdout.write(f.read())
    if not os.path.exists(out_path):
        raise RuntimeError(f"the multi-rank process exited with code {proc.exitcode} and no result")
    with open(out_path, "rb") as f:
        out = pickle.load(f)
    for line in out["lines"]:
        _cs().emit(line)
    if "error" in out:
        raise RuntimeError(f"the multi-rank phases failed:\n{out['error']}")
    return out["paths"]


def stop_multirank(handle) -> None:
    """Stop every process of the second process's group that still runs
    (after a failure on the caller's side; a no-op once it has ended)."""
    import signal

    proc = handle[0]
    for sig, wait in ((signal.SIGTERM, 20), (signal.SIGKILL, 10)):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        proc.join(wait)
