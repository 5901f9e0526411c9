"""The edge-partitioned phases of ``chip_smoke.py`` (run from it, on one
CUDA card; this module starts nothing on import):

- ``k5_pair``: K5 (``csr_softmax_spmm_pair``) forward and backward against
  their plain versions on the card at three parts of a 4-way split-edge
  partition (the 16,384-node mesh below, 4,096 rows, width 128; one
  2,048-node serving frame, width 128; the aneurysm-scale graph, 66,560
  nodes and 524,288 edges, width 64), each timed beside its bound, its
  plain version, the path it replaced (two K2 launches and the merge of
  their (m, l) in PyTorch; backward two K3 launches) and the launch floor;
- ``partitioned_epd_training``: ``cylinder.json`` (EncodeProcessDecode
  15 x 128) on one 16,384-node mesh (``triangulated_grid(128, 128)``: the
  node count of bench.py's 8 x 2,048 batch as one connected graph; the
  batch's own 8 graphs fall into whole parts at P = 4 and would exchange
  nothing), ``Trainer(graph_partition=4)`` in 4 ranks sharing the card
  (gloo), halo mode with the f32 and the bf16 wire: each rank's first step
  against the unpartitioned card step on the same mesh, then 20 timed
  steps with K1 and K1b counted (15 each a step and rank), ms per step
  beside the unpartitioned step's, peak memory, host ms and halo bytes
  per layer;
- ``partitioned_transformer_training``: ``panels.json`` (15 x 128) on the
  same mesh with the panels features (its adjacency symmetric, as the
  partitioned attention's receiver-side softmax needs to equal the
  unpartitioned sender-side one), split-edge (K5 forward and backward, 15
  each a step and rank) and unsplit (K2 and K3, 15 each);
- ``partitioned_rollout``: 10 frames of each family partitioned over the 4
  ranks against the unpartitioned card rollout;
- ``partitioned_fit``: ``python -m graphphysics_torch.cli.train
  --graph_partition 4`` for one epoch on 2,048-node panels trajectories
  (inline XDMF: the card's machine has no h5py for the cylinder's h5),
  rank 0 writing the checkpoint and ``metrics.csv``, then ``predict
  --graph_partition 4`` from it against the unpartitioned ``predict``.

The ranks time-share one card: their times are P processes' wall time on
one H100, not a scaling figure. ``python3 chip_partition.py`` prints what
sets the partitioned transformer's first-step gradient gap
(``transformer_gradients``).
"""

from __future__ import annotations

import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PARTS = 4
WARMUP, TIMED, PROFILED = 3, 20, 3
ROLLOUT_FRAMES = 10
# the bf16 wire rounds every halo row and its cotangent once: its first step
# is held to the JAX package's bf16-halo forward limit (rtol 0.05,
# tests/test_graph_partition.py) instead of the f32 first-step limits
BF16_WIRE_LOSS_RTOL = 5e-2
BF16_WIRE_GRAD_RTOL = 5e-2
# the partitioned transformer's first step against the unpartitioned card
# step on the mesh: the two walk the softmax from opposite ends of each edge
# (receivers against senders) and sum in other orders, and on this mesh the
# model's ReLU MLPs carry inputs within round-off of 0, whose flipped signs
# move every gradient upstream of them (``python3 chip_partition.py`` reads
# the unpartitioned card step against the CPU on this mesh, and the steps
# against each other).
# So the limit against the unpartitioned step is the first-step limit of
# gradients that cross ReLU kinks (chip_smoke.EPD_GRAD_RTOL), and the
# transformer's 1e-4 (chip_smoke.TRANSFORMER_GRAD_RTOL) holds the split-edge
# step (K5) against the unsplit one (K2, K3), which share everything else.
PARTITIONED_TRANSFORMER_GRAD_RTOL = 1e-2
FIT_NODES = (64, 32)  # panels grid of the fit phase: 2,048 nodes
FIT_FRAMES, FIT_TRAJECTORIES = 4, 2
SUBPROCESS_TIMEOUT_S = 600
RANKS_TIMEOUT_S = 900


def _cs():
    import chip_smoke

    return chip_smoke


def k5_case(name, graph, width, seed, floor):
    """K5 forward and backward on part 0 of ``graph``'s 4-way split-edge
    partition, against their plain versions on the card, timed beside
    their bounds, the plain versions and the replaced path."""
    from graphphysics_torch.ops.csr_attention import (
        NEG,
        _merge_partials,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_softmax_spmm_pair,
        csr_softmax_spmm_pair_backward,
        csr_softmax_spmm_pair_backward_reference,
        csr_softmax_spmm_pair_reference,
    )
    from graphphysics_torch.parallel.graph_partition import partition_graph_halo_np

    cs = _cs()
    part = partition_graph_halo_np(graph, PARTS, split_local=True)[0]
    dev, h = torch.device("cuda"), cs.HEADS
    el, n = part.num_local_edges, part.num_nodes
    recv = torch.as_tensor(part.receivers).to(dev)
    mask = torch.as_tensor(part.edge_mask).to(dev)
    seg = (recv[:el].contiguous(), recv[el:].contiguous())
    masks = (mask[:el].contiguous(), mask[el:].contiguous())
    bounds = (torch.as_tensor(part.row_bounds).to(dev), torch.as_tensor(part.halo_row_bounds).to(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores, values = [], []
    for m in masks:
        s = 3 * torch.randn((m.shape[0], h), generator=gen, device=dev)
        scores.append(torch.where(m[:, None], s, torch.full((), NEG, device=dev)))
        values.append(torch.randn((m.shape[0], width), generator=gen, device=dev))
    g = torch.randn((n, width), generator=gen, device=dev)

    def pair(sa, va, sb, vb):
        return csr_softmax_spmm_pair(sa, va, seg[0], bounds[0], sb, vb, seg[1], bounds[1], *masks)

    def pair_plain(sa, va, sb, vb):
        return csr_softmax_spmm_pair_reference(sa, va, seg[0], sb, vb, seg[1], n, *masks)

    def replaced(sa, va, sb, vb):  # two K2 launches and the merge in PyTorch
        oa, ma = csr_softmax_spmm(sa, va, seg[0], bounds[0], masks[0])
        ob, mb = csr_softmax_spmm(sb, vb, seg[1], bounds[1], masks[1])
        return _merge_partials(oa, ma, ob, mb, h)

    def backward(sa, va, sb, vb, ml, out, g_):
        return csr_softmax_spmm_pair_backward(sa, va, seg[0], bounds[0], sb, vb, seg[1], bounds[1],
                                              ml, out, g_, *masks)

    def backward_plain(sa, va, sb, vb, ml, out, g_):
        return csr_softmax_spmm_pair_backward_reference(sa, va, seg[0], sb, vb, seg[1], ml, out, g_,
                                                        *masks)

    def backward_replaced(sa, va, sb, vb, ml, out, g_):  # two K3 launches
        return (csr_softmax_spmm_backward(sa, va, seg[0], bounds[0], ml, out, g_, masks[0])
                + csr_softmax_spmm_backward(sb, vb, seg[1], bounds[1], ml, out, g_, masks[1]))

    args = (scores[0], values[0], scores[1], values[1])
    with torch.no_grad():
        out, ml = pair(*args)
        want_out, want_ml = pair_plain(*args)
        torch.cuda.synchronize()
        for got, want, what in ((out, want_out, "out"), (ml, want_ml, "ml")):
            if not torch.isfinite(got).all() or not torch.allclose(
                    got, want, rtol=cs.SOFTMAX_RTOL, atol=cs.SOFTMAX_ATOL):
                raise AssertionError(f"{name}: K5 vs plain {what} max_abs_err "
                                     f"{(got - want).abs().max().item()}")
        fwd_err = (out - want_out).abs().max().item()
        rep_out, _ = replaced(*args)
        replaced_err = (rep_out - want_out).abs().max().item()
        grads = backward(*args, ml, out, g)
        again = backward(*args, ml, out, g)
        want_grads = backward_plain(*args, ml, out, g)
        torch.cuda.synchronize()
        bwd_errs = []
        for a, b, c, m in zip(grads, want_grads, again, (masks[0], masks[0], masks[1], masks[1])):
            if not torch.equal(a, c):
                raise AssertionError(f"{name}: two K5 backward runs differ")
            if not torch.isfinite(a).all() or not bool((a[~m] == 0).all()):
                raise AssertionError(f"{name}: K5 backward not finite, or not 0 on masked edges")
            if not torch.allclose(a, b, rtol=cs.K3_GRAD_RTOL, atol=cs.K3_GRAD_ATOL):
                raise AssertionError(f"{name}: K5 backward vs plain max_abs_err "
                                     f"{(a - b).abs().max().item()}")
            bwd_errs.append((a - b).abs().max().item())

        real = [int(m.sum().item()) for m in masks]
        real_edges = sum(real)
        slots = sum(int(m.shape[0]) for m in masks)
        # forward: each real edge's scores, value row and mask byte; each
        # row's four bounds, output row and (m, l) per head
        fwd_bytes = real_edges * (4 * h + 4 * width + 1) + n * (16 + 4 * width + 8 * h)
        fwd_ops = real_edges * (2 * width + 3 * h) + n * width
        # backward: those reads plus each row's out and g rows and (m, l);
        # every slot's dscores and dvalues rows written
        bwd_bytes = (real_edges * (4 * h + 4 * width + 1) + n * (16 + 8 * width + 8 * h)
                     + slots * (4 * h + 4 * width))
        bwd_ops = real_edges * (3 * width + 3 * h) + n * 2 * width
        copies = cs.copies_past_l2(fwd_bytes)
        inputs = [args] + [tuple(t.clone() for t in args) for _ in range(copies - 1)]
        fwd_t = cs.device_ms(pair, inputs)
        fwd_plain_t = cs.device_ms(pair_plain, inputs)
        fwd_replaced_t = cs.device_ms(replaced, inputs)
        binputs = [args + (ml, out, g)] + [tuple(t.clone() for t in args + (ml, out, g))
                                             for _ in range(cs.copies_past_l2(bwd_bytes) - 1)]
        bwd_t = cs.device_ms(backward, binputs)
        bwd_plain_t = cs.device_ms(backward_plain, binputs)
        bwd_replaced_t = cs.device_ms(backward_replaced, binputs)

    def entry(kind, err, tol, t, plain_t, replaced_t, bytes_, ops):
        bound = bytes_ / cs.H100_BYTES_PER_S * 1e3
        ops_bound = ops / cs.H100_F32_OPS_PER_S * 1e3
        return {
            "shape": name, "direction": kind, "rows": n, "local_slots": el,
            "halo_slots": int(masks[1].shape[0]), "local_edges": real[0], "halo_edges": real[1],
            "width": width, "heads": h, "max_abs_err": err, "tolerance": tol, "ms": t,
            "plain_ms": plain_t, "replaced_ms": replaced_t,
            "replaced": ("two K2 launches (csr_softmax_spmm) and the (m, l) merge in PyTorch"
                         if kind == "forward" else "two K3 launches (csr_softmax_spmm_backward)"),
            "library_ms": None,
            "library_note": "no single PyTorch call computes a segment softmax + SpMM",
            "launch_floor_ms": floor, "bound_ms": max(bound, ops_bound),
            "bound_by": "bytes" if bound >= ops_bound else "operations", "bytes": bytes_,
            "operations": ops,
        }

    return (
        entry("forward", fwd_err, {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}, fwd_t,
              fwd_plain_t, fwd_replaced_t, fwd_bytes, fwd_ops) | {"replaced_max_abs_err": replaced_err},
        entry("backward", max(bwd_errs), {"rtol": cs.K3_GRAD_RTOL, "atol": cs.K3_GRAD_ATOL}, bwd_t,
              bwd_plain_t, bwd_replaced_t, bwd_bytes, bwd_ops),
    )


def _counters():
    from graphphysics_torch.ops.csr_attention import (
        csr_attention,
        csr_attention_backward,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_softmax_spmm_pair,
        csr_softmax_spmm_pair_backward,
    )
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_backward

    return {
        "csr_segment_sum": csr_segment_sum,
        "csr_segment_sum_backward": csr_segment_sum_backward,
        "csr_softmax_spmm": csr_softmax_spmm,
        "csr_softmax_spmm_backward": csr_softmax_spmm_backward,
        "csr_attention": csr_attention,
        "csr_attention_backward": csr_attention_backward,
        "csr_attention_bf16": csr_attention.bf16,
        "csr_attention_backward_bf16": csr_attention_backward.bf16,
        "csr_softmax_spmm_pair": csr_softmax_spmm_pair,
        "csr_softmax_spmm_pair_backward": csr_softmax_spmm_pair_backward,
    }


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(device, reset=False):
    if torch.device(device).type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return torch.cuda.max_memory_allocated() / 2**30


def _rank_step(rank, case, total_steps, workdir, device):
    """One partitioned Trainer on this rank: its first step (loss and the
    summed gradients), then WARMUP steps and TIMED timed ones with every
    launch count zeroed just before them."""
    import torch.distributed as dist

    from graphphysics_torch.parallel.mesh import GRAPH_AXIS, graph_group
    from graphphysics_torch.training import Trainer

    counts = _counters()
    tr = Trainer(case["param"], learning_rate=1e-4, warmup=10, seed=case["seed"], device=device,
                 graph_partition=PARTS, halo_dtype=case.get("wire"),
                 partition_overlap_attention=case.get("split", True), metrics_path=None,
                 rollout_dir=None, checkpoint_dir=workdir, progress=False)
    tr.init_state(total_steps)
    batch = case["batch"]
    first = tr.train_step(batch).item()
    grads = ({n: p.grad.detach().cpu().numpy() for n, p in tr.sim.named_parameters()}
             if rank == 0 else None)
    for _ in range(WARMUP):
        tr.train_step(batch)
    _sync(device)
    _peak_gb(device, reset=True)
    dist.barrier(group=graph_group(GRAPH_AXIS))
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [tr.train_step(batch) for _ in range(TIMED)]
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    breakdown = _profiled_steps(tr, batch, device) if rank == 0 else None
    if rank != 0:
        for _ in range(PROFILED):
            tr.train_step(batch)
        _sync(device)
    part = tr.partition_graph(batch)
    b = int(part.halo_send_idx.shape[-1]) if part.halo_send_idx is not None else None
    width = case["param"]["model"]["hidden_size"]
    # per layer one exchange forward, one of the cotangent backward: the
    # EPD ships the projected sender rows (width wide), the transformer k|v
    columns = width if case["param"]["model"]["type"] == "epd" else 2 * width
    itemsize = 2 if case.get("wire") else 4
    return {
        "first_loss": first,
        "grads": grads,
        "losses": [x.item() for x in losses],
        "ms_per_step": seconds / TIMED * 1e3,
        "launches": launches,
        "peak_memory_gb": _peak_gb(device),
        "host_ms_per_step": float(np.mean(tr.host_ms[-TIMED:])),
        "part_nodes": int(part.num_nodes),
        "part_edge_slots": int(part.num_edges),
        "local_edge_slots": part.num_local_edges,
        "halo_budget": b,
        "halo_bytes_per_layer_each_way": None if b is None else (PARTS - 1) * b * columns * itemsize,
        "breakdown": breakdown,
    }


def _profiled_steps(tr, batch, device) -> dict:
    """Where rank 0's partitioned step goes, over PROFILED steps: the
    collectives' host time (the ``c10d::`` calls, a synchronous one
    returning when done, and the asynchronous exchange's ``halo.wait``),
    the host's partitioning (``Trainer.host_ms``), and the card's time by
    kind (kernels, and the copies gloo stages through the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for _ in range(PROFILED):
            tr.train_step(batch)
        _sync(device)
    wall = (time.perf_counter() - t0) / PROFILED * 1e3
    rows = prof.key_averages()
    collective = {r.key: r.cpu_time_total / 1e3 / PROFILED for r in rows
                  if r.key.startswith("c10d::") or r.key == "halo.wait"}
    device_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                   and not getattr(r, "is_user_annotation", False)]

    def us(r):
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0.0)

    copies = sum(us(r) for r in device_rows if "memcpy" in r.key.lower()) / 1e3 / PROFILED
    device_total = sum(us(r) for r in device_rows) / 1e3 / PROFILED
    return {
        "profiled_steps": PROFILED,
        "wall_ms_per_step": wall,
        "collective_host_ms_per_step": sum(collective.values()),
        "collectives": collective,
        "host_partition_ms_per_step": float(np.mean(tr.host_ms[-PROFILED:])),
        "device_ms_per_step": device_total if device_rows else "not measured",
        "device_copy_ms_per_step": copies if device_rows else "not measured",
    }


def _rank_rollout(rank, case, device):
    from graphphysics_torch.parallel.dp import partitioned_rollout
    from graphphysics_torch.parallel.graph_partition import part_of, partition_frames_np

    cs = _cs()
    counts = _counters()
    sim = (cs.build_epd(case["seed"], device) if case["family"] == "epd"
           else cs.build_transformer(case["param"], case["seed"], device))
    frames = case["frames"]
    parts = partition_frames_np([frames[t] for t in range(frames.x.shape[0])], PARTS, halo=True,
                                split_local=case["family"] != "epd")
    import torch.distributed as dist

    from graphphysics_torch.parallel.mesh import GRAPH_AXIS, graph_group

    mine = part_of(parts, rank, axis=1)
    _sync(device)
    dist.barrier(group=graph_group(GRAPH_AXIS))  # rank 0 comes from its profiled steps
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    preds, _ = partitioned_rollout(sim, mine, device=device)
    _sync(device)
    return {"preds": preds.cpu().numpy() if rank == 0 else None,
            "ms_per_frame": (time.perf_counter() - t0) / frames.x.shape[0] * 1e3,
            "launches": {k: fn.launches for k, fn in counts.items()}}


def rank_main(rank, spec_path):
    """A chip rank: the spec's partitioned train steps and rollouts on the
    shared card; writes and returns the path of its results."""
    from graphphysics_torch.parallel.mesh import group_backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    device = spec.get("device", "cuda")
    out = {"backend": group_backend()}
    workdir = tempfile.mkdtemp(prefix=f"rank{rank}_")
    for name, case in spec["steps"].items():
        out[name] = _rank_step(rank, case, spec["total_steps"], workdir, device)
    for name, case in spec["rollouts"].items():
        out[name] = _rank_rollout(rank, case, device)
    path = f"{spec_path}.rank{rank}"
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


MESH = (128, 128)  # triangulated_grid: 16,384 nodes


def mesh_graph(layout, seed):
    """One connected symmetric mesh of 16,384 nodes with random features:
    the cylinder layout ``[vel(2), node_type, time]`` with 3 edge features
    receiver-sorted (``"sorted"``), or the panels layout ``[vel(3),
    node_type, time]`` sender-sorted (``"csr"``)."""
    from graphphysics_torch.core import pad_graph_csr_np, pad_graph_sorted_np, round_up
    from graphphysics_torch.topology import face_to_edge
    from graphphysics_torch.utils.synthetic import triangulated_grid

    pos, tris = triangulated_grid(*MESH)
    senders, receivers = face_to_edge(tris)
    n, e = len(pos), len(senders)
    r = np.random.default_rng(seed)
    cols, nti, outs = (4, 2, 2) if layout == "sorted" else (5, 3, 3)
    x = r.normal(size=(n, cols)).astype(np.float32)
    x[:, nti] = r.integers(0, 7, size=n)
    pad = pad_graph_sorted_np if layout == "sorted" else pad_graph_csr_np
    return pad(x, pos, senders.astype(np.int32), receivers.astype(np.int32), n,
               round_up(int(e * 1.05), 128),
               edge_attr=r.normal(size=(e, 3)).astype(np.float32) if layout == "sorted" else None,
               y=r.normal(size=(n, outs)).astype(np.float32), node_type_index=nti)


def unpartitioned_steps(param, graph, seed, total_steps):
    """The unpartitioned card step on ``graph`` from the weights the
    partitioned Trainer draws: the first step's loss and gradients, then
    WARMUP steps and the ms of TIMED ones."""
    from graphphysics_torch.training import Trainer

    tr = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda",
                 metrics_path=None, rollout_dir=None)
    tr.init_state(total_steps)
    dev_graph = graph.to("cuda")
    loss = tr.train_step(dev_graph).item()
    grads = {n: p.grad.detach().cpu().numpy() for n, p in tr.sim.named_parameters()}
    for _ in range(WARMUP):
        tr.train_step(dev_graph)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        tr.train_step(dev_graph)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TIMED * 1e3
    del tr
    return loss, grads, ms


def compare_step(name, ref, got, loss_rtol, grad_rtol):
    """Rank 0's first partitioned step against the unpartitioned one: the
    loss, and per parameter ||g_p - g|| / ||g|| (the worst one named), the
    key bias (round-off only) held to ``STEP_ROUNDOFF_SHARE`` instead."""
    cs = _cs()
    loss, grads = ref[:2]
    loss_err = abs(got["first_loss"] - loss) / abs(loss)
    roundoff = [n for n in grads if n.endswith(cs.ROUNDOFF_LEAVES)]
    rel = {n: float(np.linalg.norm(got["grads"][n] - g) / np.linalg.norm(g))
           for n, g in grads.items() if n not in roundoff}
    worst = max(rel, key=rel.get)
    top = max(np.abs(g).max() for n, g in got["grads"].items() if n not in roundoff)
    share = max([0.0] + [float(np.abs(got["grads"][n]).max() / top) for n in roundoff])
    result = {"first_step_loss": got["first_loss"], "unpartitioned_loss": loss,
              "first_step_loss_rel_err": loss_err, "first_step_grad_rel_err_worst": rel[worst],
              "first_step_grad_worst_param": worst,
              "first_step_grad_rel_err_median": float(np.median(list(rel.values()))),
              "first_step_roundoff_share": share,
              "first_step_tolerance": {"loss_rtol": loss_rtol, "grad_rtol_per_param": grad_rtol,
                                       "roundoff_share": cs.STEP_ROUNDOFF_SHARE}}
    if not (math.isfinite(got["first_loss"]) and loss_err <= loss_rtol and rel[worst] <= grad_rtol
            and share <= cs.STEP_ROUNDOFF_SHARE):
        raise AssertionError(f"{name}: first partitioned step vs unpartitioned out of tolerance: "
                             f"{result}")
    return result


def summarize(name, ranks, expected, unpartitioned_ms):
    """Every rank's timed steps: the launches per step and rank against
    ``expected``, finite losses equal on every rank, the times."""
    want = {k: expected.get(k, 0) * TIMED for k in ranks[0]["launches"]}
    for r, res in enumerate(ranks):
        if res["launches"] != want:
            raise AssertionError(f"{name}: rank {r} launched {res['launches']} in {TIMED} steps, "
                                 f"expected {want}")
        if res["losses"] != ranks[0]["losses"] or not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"{name}: rank {r} losses {res['losses'][:3]}... differ or not "
                                 f"finite")
    return {
        "ranks": PARTS,
        "ms_per_step_per_rank": [res["ms_per_step"] for res in ranks],
        "unpartitioned_ms_per_step": unpartitioned_ms,
        "host_ms_per_step_per_rank": [res["host_ms_per_step"] for res in ranks],
        "peak_memory_gb_per_rank": [res["peak_memory_gb"] for res in ranks],
        "launches_per_step_per_rank": {k: v / TIMED for k, v in ranks[0]["launches"].items() if v},
        "launches": {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]},
        "first_loss": ranks[0]["losses"][0], "last_loss": ranks[0]["losses"][-1],
        "rank0_breakdown": ranks[0]["breakdown"],
        **{k: ranks[0][k] for k in ("part_nodes", "part_edge_slots", "local_edge_slots",
                                    "halo_budget", "halo_bytes_per_layer_each_way")},
    }


def _predict_rank(rank, cfg, ckpt):
    """``predict --graph_partition 4``'s rank (``rank`` None: the
    unpartitioned predict): the held-out trajectory's predictions from the
    checkpoint, nothing written."""
    import json

    from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing, load_checkpoint

    with open(cfg) as f:
        param = json.load(f)
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=False, remove_noise=True),
                     use_edge_feature=False, switch_to_val=True)
    partition = {} if rank is None else dict(graph_partition=PARTS, partitioned_validation=True)
    tr = Trainer(param, metrics_path=None, rollout_dir=None, device="cuda", **partition)
    tr.init_state(num_steps=1)
    load_checkpoint(ckpt, tr.sim)
    return tr.predict(ds, save_dir=None, max_trajectories=1)[0]


def partitioned_fit(seed):
    """``cli.train --graph_partition 4`` for one epoch on inline-XDMF panels
    trajectories of 2,048 nodes, rank 0 writing the checkpoint and the
    metrics, then the partitioned predict from it (``_predict_rank``)
    against the unpartitioned one."""
    import json

    from chip_fidelity import panels_param, write_panels_inline
    from graphphysics_torch.parallel.mesh import launch

    nx, ny = FIT_NODES
    with tempfile.TemporaryDirectory(prefix="partitioned_fit_") as tmp:
        train_dir, meta = write_panels_inline(os.path.join(tmp, "data", "train"), FIT_TRAJECTORIES,
                                              FIT_FRAMES, nx, ny, seed=seed)
        write_panels_inline(os.path.join(tmp, "data", "test"), 1, FIT_FRAMES, nx, ny, seed=seed + 1)
        cfg = os.path.join(tmp, "cfg.json")
        with open(cfg, "w") as f:
            json.dump(panels_param(train_dir, meta), f)
        base = [sys.executable, "-m", "graphphysics_torch.cli"]
        common = ["--training_parameters_path", cfg, "--device", "cuda"]
        # the commands run in the temporary directory: the repository on their path
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        t0 = time.perf_counter()
        subprocess.run([*base, "train", *common, "--graph_partition", str(PARTS), "--num_epochs", "1",
                        "--batch_size", "1", "--warmup", "5", "--val_trajectories", "1",
                        "--progress", "off"], cwd=tmp, env=env, check=True,
                       timeout=SUBPROCESS_TIMEOUT_S)
        train_s = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "checkpoints", "state.pt")
        with open(os.path.join(tmp, "metrics.csv")) as f:
            metric_rows = sum(1 for _ in f) - 1
        if not os.path.exists(ckpt) or metric_rows < 1:
            raise AssertionError("partitioned_fit: rank 0 wrote no checkpoint or metrics")
        # the predict command writes its XDMF through h5py, which the card's
        # machine lacks: its partitioned path (the ranks' Trainer with
        # partitioned_validation, as cli.predict builds it) runs here with
        # save_dir=None, against the unpartitioned Trainer.predict
        t0 = time.perf_counter()
        preds = {"parts": launch(_predict_rank, PARTS, "cuda", args=(cfg, ckpt),
                                 timeout=RANKS_TIMEOUT_S)[0]}
        seconds = {"parts": time.perf_counter() - t0}
        t0 = time.perf_counter()
        preds["whole"] = _predict_rank(None, cfg, ckpt)
        seconds["whole"] = time.perf_counter() - t0
    cs = _cs()
    err = float(np.abs(preds["parts"] - preds["whole"]).max())
    if not np.allclose(preds["parts"], preds["whole"], rtol=cs.ROLLOUT_RTOL, atol=cs.ROLLOUT_ATOL):
        raise AssertionError(f"partitioned_fit: partitioned predict vs whole max_abs_err {err}")
    return {"config": "panels.json schema (chip_fidelity.panels_param), 15 x 128",
            "nodes": nx * ny, "train_trajectories": FIT_TRAJECTORIES, "frames": FIT_FRAMES,
            "ranks": PARTS, "train_s": train_s, "predict_s": seconds,
            "predicted_frames": int(preds["parts"].shape[0]), "metrics_rows": metric_rows,
            "predict_max_abs_err": err,
            "tolerance": {"rtol": cs.ROLLOUT_RTOL, "atol": cs.ROLLOUT_ATOL}}


def partition_phases(clock, seed, cylinder, panels, epd_frames, tf_frames, aneurysm_csr, floor):
    """Every partitioned phase; returns ``(k5 forward shapes, k5 backward
    shapes, {path: launches})`` for the kernels line."""
    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.parallel.mesh import launch

    cs = _cs()
    # K5 on the card ------------------------------------------------------------
    # the training path's shape second, as chip_smoke's kernels line reads it
    meshes = {"epd": mesh_graph("sorted", seed + 600), "transformer": mesh_graph("csr", seed + 601)}
    shapes = [k5_case("serving_frame_2048_part0_of_4", tf_frames[0], cs.HIDDEN, seed + 1, floor),
              k5_case("mesh_16384_part0_of_4", meshes["transformer"], cs.HIDDEN, seed, floor),
              k5_case("aneurysm_csr_66560x524288_part0_of_4", aneurysm_csr, 64, seed + 2, floor)]
    for f, b in shapes:
        clock.emit({"phase": "k5_pair", "name": "csr_softmax_spmm_pair", **f})
        clock.emit({"phase": "k5_pair", "name": "csr_softmax_spmm_pair_backward", **b})

    # the unpartitioned card steps the partitioned first steps are held to --
    total_steps = 1 + WARMUP + TIMED + PROFILED
    ref = {"epd": unpartitioned_steps(cylinder, meshes["epd"], seed, total_steps),
           "transformer": unpartitioned_steps(panels, meshes["transformer"], seed, total_steps)}
    roll = {"epd": stack_graphs([epd_frames[t] for t in range(ROLLOUT_FRAMES)]),
            "transformer": stack_graphs([tf_frames[t] for t in range(ROLLOUT_FRAMES)])}
    torch.cuda.empty_cache()

    # the ranks -------------------------------------------------------------------
    spec = {
        "total_steps": total_steps,
        "steps": {
            "epd_f32": dict(param=cylinder, batch=meshes["epd"], seed=seed),
            "epd_bf16": dict(param=cylinder, batch=meshes["epd"], seed=seed, wire="bf16"),
            "transformer_split": dict(param=panels, batch=meshes["transformer"], seed=seed,
                                      split=True),
            "transformer_unsplit": dict(param=panels, batch=meshes["transformer"], seed=seed,
                                        split=False),
        },
        "rollouts": {f"{fam}_rollout": dict(family=fam, param=panels, seed=seed, frames=roll[fam])
                     for fam in ("epd", "transformer")},
    }
    with tempfile.TemporaryDirectory(prefix="partition_ranks_") as tmp:
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        t0 = time.perf_counter()
        paths = launch(rank_main, PARTS, "cuda", args=(spec_path,), timeout=RANKS_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        ranks = []
        for path in paths:
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
    backend = ranks[0]["backend"]
    blocks = cylinder["model"]["message_passing_num"]
    tf_blocks = panels["model"]["message_passing_num"]
    paths_launched = {}
    epd = {}
    for wire, key, loss_rtol, grad_rtol in ((None, "epd_f32", cs.STEP_LOSS_RTOL, cs.EPD_GRAD_RTOL),
                                            ("bf16", "epd_bf16", BF16_WIRE_LOSS_RTOL,
                                             BF16_WIRE_GRAD_RTOL)):
        per_rank = [r[key] for r in ranks]
        summary = summarize(f"partitioned_epd_training:{key}", per_rank,
                            {"csr_segment_sum": blocks, "csr_segment_sum_backward": blocks},
                            ref["epd"][2])
        epd[key] = {"wire": wire or "f32", **summary,
                    **compare_step(f"partitioned_epd_training:{key}", ref["epd"], per_rank[0],
                                   loss_rtol, grad_rtol)}
        paths_launched[f"partitioned_epd_training:{key}"] = summary["launches"]
    clock.emit({"phase": "partitioned_epd_training", "model": f"EncodeProcessDecode {blocks}x"
                f"{cylinder['model']['hidden_size']}, {cs.CYLINDER_CONFIG}",
                "graph": f"triangulated_grid{MESH}, {meshes['epd'].num_nodes} nodes, "
                         f"{int(meshes['epd'].edge_mask.sum())} edges", "backend": backend, "mode": "halo", "ranks_share_one_card": True,
                "ranks_s": ranks_s, **epd})
    tf = {}
    for key, split, expected in (
            ("transformer_split", True, {"csr_softmax_spmm_pair": tf_blocks,
                                         "csr_softmax_spmm_pair_backward": tf_blocks}),
            ("transformer_unsplit", False, {"csr_softmax_spmm": tf_blocks,
                                            "csr_softmax_spmm_backward": tf_blocks})):
        per_rank = [r[key] for r in ranks]
        summary = summarize(f"partitioned_transformer_training:{key}", per_rank, expected,
                            ref["transformer"][2])
        tf[key] = {"layout": "split-edge" if split else "unsplit", **summary,
                   **compare_step(f"partitioned_transformer_training:{key}", ref["transformer"],
                                  per_rank[0], cs.STEP_LOSS_RTOL,
                                  PARTITIONED_TRANSFORMER_GRAD_RTOL)}
        paths_launched[f"partitioned_transformer_training:{key}"] = summary["launches"]
    unsplit = ranks[0]["transformer_unsplit"]
    tf["split_against_unsplit"] = compare_step(
        "partitioned_transformer_training:split_against_unsplit",
        (unsplit["first_loss"], unsplit["grads"]), ranks[0]["transformer_split"], cs.STEP_LOSS_RTOL,
        cs.TRANSFORMER_GRAD_RTOL)
    clock.emit({"phase": "partitioned_transformer_training", "model": f"EncodeTransformDecode "
                f"{tf_blocks}x{panels['model']['hidden_size']}, {cs.PANELS_CONFIG}",
                "graph": f"triangulated_grid{MESH}, {meshes['transformer'].num_nodes} nodes",
                "backend": backend, "mode": "halo",
                "ranks_share_one_card": True, **tf})

    # partitioned rollouts against the unpartitioned card rollout -----------------
    from graphphysics_torch.training.rollout import rollout

    rollouts = {}
    for fam, expected in (("epd", {"csr_segment_sum": blocks}),
                          ("transformer", {"csr_softmax_spmm_pair": tf_blocks})):
        sim = (cs.build_epd(seed, "cuda") if fam == "epd"
               else cs.build_transformer(panels, seed, "cuda"))
        want, _ = rollout(sim, roll[fam], device="cuda")
        got = ranks[0][f"{fam}_rollout"]["preds"]
        err = float(np.abs(got - want.cpu().numpy()).max())
        if not np.allclose(got, want.cpu().numpy(), rtol=cs.ROLLOUT_RTOL, atol=cs.ROLLOUT_ATOL):
            raise AssertionError(f"partitioned_rollout:{fam}: vs unpartitioned max_abs_err {err}")
        launched = {k: sum(r[f"{fam}_rollout"]["launches"][k] for r in ranks)
                    for k in ranks[0][f"{fam}_rollout"]["launches"]}
        want_launches = {k: expected.get(k, 0) * ROLLOUT_FRAMES * PARTS for k in launched}
        if launched != want_launches:
            raise AssertionError(f"partitioned_rollout:{fam}: launches {launched}, expected "
                                 f"{want_launches}")
        paths_launched[f"partitioned_rollout:{fam}"] = launched
        rollouts[fam] = {"frames": ROLLOUT_FRAMES, "max_abs_err": err,
                         "ms_per_frame_per_rank": [r[f"{fam}_rollout"]["ms_per_frame"]
                                                   for r in ranks],
                         "launches": launched}
        del sim
    clock.emit({"phase": "partitioned_rollout", "layout": {"epd": "halo", "transformer":
                                                           "split-edge halo"},
                "tolerance": {"rtol": cs.ROLLOUT_RTOL, "atol": cs.ROLLOUT_ATOL}, **rollouts})
    torch.cuda.empty_cache()

    clock.emit({"phase": "partitioned_fit", **partitioned_fit(seed)})
    return [f for f, _ in shapes], [b for _, b in shapes], paths_launched


def _sync_exchange_rank(rank, spec_path):
    """``rank_main`` with the halo exchange waited for where it is started
    (``halo_recv(async_op=True)`` returns the finished rows)."""
    from graphphysics_torch.ops import halo

    started = halo.halo_recv

    def waited(x, idx, axis_name, wire_dtype=None, async_op=False):
        rows = started(x, idx, axis_name, wire_dtype)

        class Done:
            def wait(self):
                return rows

        return Done() if async_op else rows

    halo.halo_recv = waited
    return rank_main(rank, spec_path)


def transformer_gradients(seed=0) -> dict:
    """What sets the partitioned transformer's first-step gradient gap on
    the mesh: the unpartitioned card step against the CPU (ReLU sign flips
    counted), and the split-edge and unsplit partitioned steps against the
    unpartitioned card step and against each other, with the exchange
    asynchronous (as shipped) and waited for where started."""
    from graphphysics_torch.parallel.mesh import launch

    cs = _cs()
    panels = cs.load_config(cs.PANELS_CONFIG)
    mesh = mesh_graph("csr", seed + 601)
    total = 1 + WARMUP + TIMED + PROFILED
    out = {"card_against_cpu": cs.first_step("transformer_gradients", panels, mesh, seed, total,
                                              math.inf)}
    ref = unpartitioned_steps(panels, mesh, seed, total)
    torch.cuda.empty_cache()
    spec = {"total_steps": total, "rollouts": {}, "steps": {
        "split": dict(param=panels, batch=mesh, seed=seed, split=True),
        "unsplit": dict(param=panels, batch=mesh, seed=seed, split=False)}}
    with tempfile.TemporaryDirectory(prefix="transformer_gradients_") as tmp:
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        for label, fn in (("async", rank_main), ("waited", _sync_exchange_rank)):
            with open(launch(fn, PARTS, "cuda", args=(spec_path,), timeout=RANKS_TIMEOUT_S)[0],
                         "rb") as f:
                r = pickle.load(f)
            out[label] = {
                "split_against_unpartitioned": compare_step("split", ref, r["split"], 1.0, math.inf),
                "unsplit_against_unpartitioned": compare_step("unsplit", ref, r["unsplit"], 1.0,
                                                              math.inf),
                "split_against_unsplit": compare_step(
                    "split_unsplit", (r["unsplit"]["first_loss"], r["unsplit"]["grads"]),
                    r["split"], 1.0, math.inf)}
    return out


if __name__ == "__main__":  # python3 chip_partition.py: the transformer_gradients readings
    import json

    if not torch.cuda.is_available():
        print("chip_partition: torch.cuda.is_available() is false; no result", file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(_cs().nvidia_smi_line(), flush=True)
    print(json.dumps(transformer_gradients()), flush=True)
