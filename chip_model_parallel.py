"""The tensor- and pipeline-parallel phases and the partitioned serving
export of ``chip_smoke.py`` (run from it, on one CUDA card; this module
starts nothing on import). The ranks share the card over gloo, weights
random from the seed (the Trainer's):

- ``tp_epd_training``: ``cylinder.json`` (EncodeProcessDecode 15 x 128) on
  the 8 x 2,048 batch (``chip_smoke.flagship_graphs``), concatenated, on
  ``TP_RANKS`` ranks of the model axis (``parallel.tp``): the first step's
  loss and full gradients (gathered before the update) against the
  single-process step (``chip_partition.compare_step``, limits
  ``chip_smoke.STEP_LOSS_RTOL`` and ``EPD_GRAD_RTOL``), then WARMUP steps
  (the last one profiled on rank 0: its device ms, the collectives' host
  ms) and TIMED timed ones with every launch count zeroed just before them
  (K1 and K1b, 15 each a step and rank), and the bytes all-reduced a step;
- ``tp_transformer_training``: ``panels.json`` (15 x 128, 4 heads) on the
  panels batch, the same with ``TRANSFORMER_GRAD_RTOL``; the fused f32
  pair, 15 each a step and rank, at the local width 64 with 2 heads;
- ``pp_epd_training`` / ``pp_transformer_training``: the same batches as
  ``MICROBATCHES`` microbatches on ``PP_STAGES`` stages (``parallel.pp``;
  15 blocks do not split in 2 or 4): the first step against the
  single-process step on their concatenation; each stage launches its 5
  blocks' kernels on each of the 8 microbatches (40 + 40 a step) and none
  on its ``S - 1`` idle ticks;
- ``pp_gmm_training``: ``c-a-gmm.json`` (the transformer 10 x 64, K = 3
  diagonal GMM head) on ``GMM_STAGES`` stages and 4 microbatches of 16,640
  padded nodes, together ``gmm_training``'s 66,560, its NLL;
- ``export_partitioned_serving``: ``utils.export.export_partitioned_eval_step``
  of the EPD 15 x 128 on a 16,384-node mesh (``chip_partition.mesh_graph``)
  in halo mode, traced in this process, saved, loaded on ``EXPORT_PARTS``
  ranks and run ``EXPORT_FRAMES`` frames: against the live
  ``graph_parallel_forward`` (1e-6) and the unpartitioned eval (1e-4), K1 15
  a frame and rank, ``export_s``, ``load_s``, ``artifact_bytes``, ms a
  frame.

The script spawns 2 ranks once: the 2-rank phases run in
``chip_parallel``'s 2-rank spawn, after its data-parallel cases
(``run_cases``); the 3-rank ones in a spawn of their own. ``prepare``
makes the references and the artifact before the 2-rank spawn,
``model_parallel_phases`` spawns the 3 stages and reports every phase. A
rank's ms a step is 2 or 3 processes' wall time on one H100 plus gloo's
collectives through the host, not a scaling figure.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time

import numpy as np
import torch

# cut from 2 and 5 to keep chip_smoke.py inside its time limit (a TP EPD
# step is about 4 s of gloo all-reduces)
WARMUP, TIMED = 1, 3
TP_RANKS, PP_STAGES, GMM_STAGES, EXPORT_PARTS = 2, 3, 2, 2
GMM_MICROBATCH = (16500, 130000, 16640, 131072)  # nodes, edges, padded: a quarter of ANEURYSM
GMM_MICROBATCHES = 4
EXPORT_FRAMES = 10
EXPORT_LIVE_ATOL = 1e-6
EXPORT_UNPARTITIONED_ATOL = 1e-4


def _cs():
    import chip_smoke

    return chip_smoke


def _cp():
    import chip_partition

    return chip_partition


def _trainer(param, seed, total_steps, device):
    from graphphysics_torch.training import Trainer

    tr = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device=device, metrics_path=None,
                 rollout_dir=None, checkpoint_dir=tempfile.mkdtemp(prefix="mp_ck_"), progress=False)
    tr.init_state(total_steps)
    return tr


def _steps(rank, step, full_grads, device, group, extra) -> dict:
    """A rank's first step (its loss, and the full gradients gathered on
    every rank, kept on rank 0), WARMUP steps (the last one profiled on
    rank 0: its device ms, the collectives' host ms), then TIMED timed ones
    with every launch count zeroed and ``extra``'s counters read just
    before them."""
    import torch.distributed as dist

    from chip_parallel import _profile

    counts = _cp()._counters()
    first = step().item()
    grads = {n: g.detach().cpu().numpy() for n, g in full_grads().items()}
    breakdown = None
    for i in range(WARMUP):
        if i == WARMUP - 1 and rank == 0:
            breakdown = _profile(step, device, 1)
        else:
            step()
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier(group=group)
    for fn in counts.values():
        fn.launches = 0
    before = dict(extra)
    t0 = time.perf_counter()
    losses = [step() for _ in range(TIMED)]
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return {"first_loss": first, "grads": grads if rank == 0 else None,
            "losses": [x.item() for x in losses], "ms_per_step": seconds / TIMED * 1e3,
            "launches": {k: fn.launches for k, fn in counts.items()},
            "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 2**30,
            "per_step": {k: (extra[k] - v) / TIMED for k, v in before.items()},
            "breakdown": breakdown}


def _tp_case(rank, case, total, device):
    from graphphysics_torch.core import concat_graphs
    from graphphysics_torch.models.layers import Attention
    from graphphysics_torch.parallel import tp
    from graphphysics_torch.parallel.mesh import MODEL_AXIS, graph_group

    tr = _trainer(case["param"], case["seed"], total, device)
    tp.shard_tp_state(tr.sim, tr.optimizer)
    step = tp.make_tp_train_step(tr.sim, tr.optimizer, tr.masks)
    graph = concat_graphs(case["graphs"]).to(device)
    heads = [m.num_heads for m in tr.sim.modules() if isinstance(m, Attention)]
    out = _steps(rank, lambda: step(graph), lambda: tp.gather_tp_state_dict(tr.sim, grads=True),
                 device, graph_group(MODEL_AXIS), tp.ALL_REDUCES)
    out["local_heads"] = heads[0] if heads else None
    out["local_width"] = tr.sim.model.nodes_encoder[0].weight.shape[0]
    return out


def _pp_case(rank, case, total, device):
    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.parallel import pp
    from graphphysics_torch.parallel.mesh import PIPE_AXIS, graph_group

    param = dict(case["param"], model=dict(case["param"]["model"], scan_blocks=True))
    tr = _trainer(param, case["seed"], total, device)
    stage = pp.shard_pp_state(tr.sim, tr.optimizer)
    step = pp.make_pp_train_step(tr.sim, tr.optimizer, tr.masks)
    mbs = stack_graphs(case["graphs"]).to(device)
    out = _steps(rank, lambda: step(mbs), lambda: pp.gather_pp_state_dict(tr.sim, grads=True),
                 device, graph_group(PIPE_AXIS), pp.SHIFTS)
    out["stage"] = tuple(stage)
    return out


def _export_case(rank, case, device):
    """Load the artifact, run EXPORT_FRAMES frames of it on this rank's
    part with every launch count zeroed just before them, and the live
    partitioned forward once; both gathered."""
    import torch.distributed as dist

    from graphphysics_torch.parallel.dp import gather_rows, graph_parallel_forward
    from graphphysics_torch.parallel.graph_partition import part_of
    from graphphysics_torch.utils.export import load_partitioned_eval_step

    t0 = time.perf_counter()
    with open(case["path"], "rb") as f:
        step = load_partitioned_eval_step(f.read())
    load_s = time.perf_counter() - t0
    part = part_of(case["parts"], rank).to(device)
    sim = _cs().build_epd(case["seed"], device)
    sim.load_state_dict(case["state"])
    sim.eval()
    with torch.no_grad():
        live = gather_rows(graph_parallel_forward(sim, part, is_training=False)[2]).cpu().numpy()
    step(part)  # the first call of the loaded program
    counts = _cp()._counters()
    torch.cuda.synchronize(device)
    dist.barrier()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = [step(part) for _ in range(EXPORT_FRAMES)]
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    exported = gather_rows(outs[-1]).cpu().numpy()
    same = all(torch.equal(o, outs[0]) for o in outs)
    return {"load_s": load_s, "ms_per_frame": seconds / EXPORT_FRAMES * 1e3, "launches": launches,
            "exported": exported if rank == 0 else None, "live": live if rank == 0 else None,
            "frames_equal": same, "num_parts": step.num_parts}


def run_cases(rank, cases, total) -> dict:
    """This rank's share of ``cases`` (name: case), the model and pipe axes
    the world, the graph axis too for an export case; each case's results
    with its seconds. Runs in the 2-rank spawn of ``chip_parallel`` (whose
    world is its data group) and in this module's 3-rank spawn."""
    from graphphysics_torch.parallel.mesh import (
        GRAPH_AXIS,
        MODEL_AXIS,
        PIPE_AXIS,
        graph_group,
        register_group,
    )

    device = torch.device("cuda", torch.cuda.current_device())
    for axis in (MODEL_AXIS, PIPE_AXIS):
        register_group(None, axis)
    out = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        if case["kind"] == "export":
            graph = graph_group(GRAPH_AXIS)
            register_group(None, GRAPH_AXIS)  # the parts of one graph: the world
            try:
                out[name] = _export_case(rank, case, device)
            finally:
                register_group(graph, GRAPH_AXIS)
        else:
            run = _tp_case if case["kind"] == "tp" else _pp_case
            out[name] = run(rank, case, total, device)
        out[name]["case_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def rank_main(rank, spec_path):
    """A rank of the 3-rank spawn: writes and returns the path of its
    results."""
    import torch.distributed as dist

    from graphphysics_torch.parallel.mesh import group_backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    out = {"backend": group_backend(), "world": dist.get_world_size(),
           **run_cases(rank, spec["cases"], spec["total"])}
    path = f"{spec_path}.rank{rank}"
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


def gmm_microbatches(seed):
    """The 4 sender-sorted graphs of ``pp_gmm_training``: the c-a-gmm
    layout, each a quarter of ``gmm_training``'s aneurysm-scale graph."""
    cs = _cs()
    return [cs.random_csr_graph(*GMM_MICROBATCH, seed + k, columns=15, node_type_index=14)
            for k in range(GMM_MICROBATCHES)]


def export_serving_case(seed, tmp):
    """Trace, save and time the partitioned eval step of the EPD 15 x 128
    on the 16,384-node mesh in halo mode (the normalizers after one
    training forward), in this process; returns the ranks' case and the
    parent's numbers, the unpartitioned eval among them."""
    from graphphysics_torch.parallel.graph_partition import part_of, partition_graph_halo_np
    from graphphysics_torch.utils.export import export_partitioned_eval_step

    cs, cp = _cs(), _cp()
    mesh = cp.mesh_graph("sorted", seed + 800)
    sim = cs.build_epd(seed, "cuda")
    graph = mesh.to("cuda")
    with torch.no_grad():
        sim(graph, is_training=True)  # statistics to normalize with
        sim.eval()
        want = sim(graph)[2].cpu().numpy()
    parts = partition_graph_halo_np(mesh, EXPORT_PARTS)
    t0 = time.perf_counter()
    blob = export_partitioned_eval_step(sim, part_of(parts, 0).to("cuda"), EXPORT_PARTS)
    path = os.path.join(tmp, f"eval_step_p{EXPORT_PARTS}.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    export_s = time.perf_counter() - t0
    state = {k: v.detach().cpu() for k, v in sim.state_dict().items()}
    del sim
    torch.cuda.empty_cache()
    return (dict(kind="export", path=path, parts=parts, state=state, seed=seed),
            {"export_s": export_s, "artifact_bytes": len(blob), "nodes": mesh.num_nodes,
             "edges": int(mesh.edge_mask.sum()), "part_nodes": int(parts.x.shape[1]),
             "halo_budget": int(parts.halo_send_idx.shape[-1])}, want)


def prepare(seed, cylinder, panels, tmp) -> dict:
    """The single-process steps the first steps are held to (one on each
    batch's concatenation, from the weights the ranks' Trainers draw), the
    traced artifact (saved under ``tmp``), and the cases of the 2-rank
    spawn (``chip_parallel.parallel_phases`` runs them) and of the 3-rank
    one."""
    from graphphysics_torch.core import concat_graphs

    cs, cp = _cs(), _cp()
    t0 = time.perf_counter()
    gmm = cs.load_config(cs.GMM_CONFIG)
    graphs = {"epd": cs.flagship_graphs(seed), "transformer": cs.panels_graphs(seed + 200),
              "gmm": gmm_microbatches(seed + 900)}
    params = {"epd": cylinder, "transformer": panels, "gmm": gmm}
    ref_total = 1 + cp.WARMUP + cp.TIMED + cp.PROFILED
    ref = {fam: cp.unpartitioned_steps(params[fam], concat_graphs(graphs[fam]), seed, ref_total)
           for fam in graphs}
    torch.cuda.empty_cache()
    export_case, export_stats, want = export_serving_case(seed, tmp)
    return {
        "seed": seed, "params": params, "graphs": graphs, "ref": ref, "export_stats": export_stats,
        "want": want, "prepare_s": time.perf_counter() - t0,
        "two_rank": {"total": 1 + WARMUP + TIMED, "cases": {
            "tp_epd": dict(kind="tp", param=cylinder, graphs=graphs["epd"], seed=seed),
            "tp_transformer": dict(kind="tp", param=panels, graphs=graphs["transformer"], seed=seed),
            "pp_gmm": dict(kind="pp", param=gmm, graphs=graphs["gmm"], seed=seed),
            "export": export_case,
        }},
        "three_rank": {"total": 1 + WARMUP + TIMED, "cases": {
            "pp_epd": dict(kind="pp", param=cylinder, graphs=graphs["epd"], seed=seed),
            "pp_transformer": dict(kind="pp", param=panels, graphs=graphs["transformer"], seed=seed),
        }},
    }


def model_parallel_phases(clock, prep, ranks2, tmp):
    """Spawn the 3 stages, then report and check every tensor- and
    pipeline-parallel phase and the partitioned serving export from
    ``prep`` (``prepare``) and the 2-rank results ``ranks2`` (each rank's
    ``run_cases``); returns ``{path: launches}`` for the kernels line."""
    from graphphysics_torch.parallel.graph_partition import unpartition_rows

    from chip_parallel import _spawn, _summary

    cs, cp = _cs(), _cp()
    ranks3, ranks3_s = _spawn(prep["three_rank"], PP_STAGES, None, tmp, "three", rank_main)
    cylinder, panels, gmm = (prep["params"][k] for k in ("epd", "transformer", "gmm"))
    ref, want = prep["ref"], prep["want"]
    cyl_graphs, tf_graphs, gmm_graphs = (prep["graphs"][k] for k in ("epd", "transformer", "gmm"))
    backend = ranks3[0]["backend"]
    paths = {}
    epd_kernels = ("csr_segment_sum", "csr_segment_sum_backward")
    tf_kernels = ("csr_attention", "csr_attention_backward")
    for fam, param, grad_rtol, kernels in (("epd", cylinder, cs.EPD_GRAD_RTOL, epd_kernels),
                                           ("transformer", panels, cs.TRANSFORMER_GRAD_RTOL,
                                            tf_kernels)):
        name = f"tp_{fam}_training"
        per_rank = [r[f"tp_{fam}"] for r in ranks2]
        blocks = param["model"]["message_passing_num"]
        summary = _summary(name, per_rank, {k: blocks for k in kernels}, TP_RANKS, TIMED)
        summary.update(cp.compare_step(name, ref[fam], per_rank[0], cs.STEP_LOSS_RTOL, grad_rtol))
        paths[name] = summary["launches"]
        clock.emit({"phase": name, "model": f"{param['model']['type']} {blocks}x"
                    f"{param['model']['hidden_size']}", "graphs": 8, "backend": backend,
                    "ranks_share_one_card": True, "case_s": per_rank[0]["case_s"],
                    "local_width": per_rank[0]["local_width"],
                    "local_heads": per_rank[0]["local_heads"],
                    "all_reduces_per_step_per_rank": per_rank[0]["per_step"]["calls"],
                    "bytes_all_reduced_per_step_per_rank": per_rank[0]["per_step"]["bytes"],
                    "single_process_ms_per_step": ref[fam][2], **summary})

    for name, key, param, ranks, stages, graphs, grad_rtol, kernels in (
            ("pp_epd_training", "pp_epd", cylinder, ranks3, PP_STAGES, cyl_graphs,
             cs.EPD_GRAD_RTOL, epd_kernels),
            ("pp_transformer_training", "pp_transformer", panels, ranks3, PP_STAGES, tf_graphs,
             cs.TRANSFORMER_GRAD_RTOL, tf_kernels),
            ("pp_gmm_training", "pp_gmm", gmm, ranks2, GMM_STAGES, gmm_graphs,
             cs.TRANSFORMER_GRAD_RTOL, tf_kernels)):
        per_rank = [r[key] for r in ranks]
        blocks = param["model"]["message_passing_num"] // stages
        m = len(graphs)
        # each stage runs its blocks once on each microbatch, none on idle ticks
        summary = _summary(name, per_rank, {k: blocks * m for k in kernels}, stages, TIMED)
        fam = "gmm" if key == "pp_gmm" else key[3:]
        summary.update(cp.compare_step(name, ref[fam], per_rank[0], cs.STEP_LOSS_RTOL, grad_rtol))
        paths[name] = summary["launches"]
        clock.emit({"phase": name, "model": f"{param['model']['type']} "
                    f"{param['model']['message_passing_num']}x{param['model']['hidden_size']}"
                    + (f", K={param['model']['num_mixture_components']}"
                       if param["model"].get("num_mixture_components") else ""),
                    "stages": stages, "blocks_per_stage": blocks, "microbatches": m,
                    "microbatch_nodes": int(graphs[0].num_nodes),
                    "ticks_per_step": m + stages - 1,
                    "launches_per_active_tick_per_stage": {k: blocks for k in kernels},
                    "launches_per_idle_tick": 0, "backend": backend,
                    "ranks_share_one_card": True, "case_s": per_rank[0]["case_s"],
                    "spawn_s": ranks3_s if stages == PP_STAGES else None,
                    "single_process_ms_per_step": ref[fam][2],
                    "stages_of_rank": [r[key]["stage"] for r in ranks], **summary})

    exports = [r["export"] for r in ranks2]
    blocks = cylinder["model"]["message_passing_num"]
    got, live = exports[0]["exported"], exports[0]["live"]
    live_err = float(np.abs(got - live).max())
    flat = unpartition_rows(got.reshape(EXPORT_PARTS, -1, got.shape[-1]))
    whole_err = float(np.abs(flat - want).max())
    if live_err > EXPORT_LIVE_ATOL or whole_err > EXPORT_UNPARTITIONED_ATOL or not np.isfinite(got).all():
        raise AssertionError(f"export_partitioned_serving: vs live {live_err}, vs unpartitioned "
                             f"{whole_err}")
    want_launches = {k: (blocks if k == "csr_segment_sum" else 0) * EXPORT_FRAMES
                     for k in exports[0]["launches"]}
    for r, res in enumerate(exports):
        if res["launches"] != want_launches or not res["frames_equal"] or res["num_parts"] != EXPORT_PARTS:
            raise AssertionError(f"export_partitioned_serving: rank {r} launched {res['launches']}, "
                                 f"expected {want_launches}; frames equal {res['frames_equal']}")
    paths["export_partitioned_serving"] = {k: v * EXPORT_PARTS for k, v in want_launches.items()}
    clock.emit({"phase": "export_partitioned_serving", "model": f"EncodeProcessDecode {blocks}x"
                f"{cylinder['model']['hidden_size']}", "mode": "halo", "parts": EXPORT_PARTS,
                **prep["export_stats"], "frames": EXPORT_FRAMES, "case_s": exports[0]["case_s"],
                "prepare_s": prep["prepare_s"],
                "load_s_per_rank": [res["load_s"] for res in exports],
                "ms_per_frame_per_rank": [res["ms_per_frame"] for res in exports],
                "launches_per_frame_per_rank": {k: v / EXPORT_FRAMES
                                                for k, v in want_launches.items() if v},
                "max_abs_err_vs_live": live_err, "max_abs_err_vs_unpartitioned": whole_err,
                "tolerance": {"vs_live_atol": EXPORT_LIVE_ATOL,
                              "vs_unpartitioned_atol": EXPORT_UNPARTITIONED_ATOL},
                "ranks_share_one_card": True})
    return paths
