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
  against the unpartitioned card step on the same mesh, then 3 timed
  steps with K1 and K1b counted (15 each a step and rank), ms per step
  beside the unpartitioned step's, peak memory, host ms and halo bytes
  per layer;
- ``partitioned_no_exchange``: the f32-wire EPD ranks go on with 1
  warm-up and 5 timed steps under ``ops.halo.stub_exchange_for_benchmark``
  (the halo exchange the identity, values wrong): ms a step a rank with
  and without the exchange, and its share; K1 and K1b counted (15 each a
  step and rank), not the values;
- ``partitioned_transformer_training``: ``panels.json`` (15 x 128) on the
  same mesh with the panels features (its adjacency symmetric, as the
  partitioned attention's receiver-side softmax needs to equal the
  unpartitioned sender-side one), split-edge (K5 forward and backward, 15
  each a step and rank) and unsplit (K2 and K3, 15 each); then at hidden
  48 in 4 heads, 40 in 8 and 160 in 5 (``WIDTH_STEPS``: K3's word
  geometry at 48 and 40, K2's at 40; both general at 160), each layout's
  first step and 2 counted steps, the unsplit launches counted by the
  geometry that ran (all in words at 48 and 40, all general at 160), each
  layout's first step against the unpartitioned card step at its width
  (the fused attention) and the unsplit first step against the
  split-edge one;
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
# 3 timed steps, cut from 5 to keep chip_smoke.py inside its time limit
WARMUP, TIMED, PROFILED = 2, 3, 2
# the transformer's steps at widths neither the 16-byte words of one head nor
# the V columns take among the unsplit kernels (hidden 48 in 4 heads of 12:
# K2 in 16-byte words of one head, K3 in the word geometry; hidden 40 in 8
# heads of 5: both in the word geometry; hidden 160 in 5 heads of 32: 40
# words, past 32 lanes, both in the general geometry), each split-edge and
# unsplit: the first step, then LIGHT_TIMED steps counted (no warm-up, no
# profile)
WIDTH_STEPS = ((48, 4), (40, 8), (160, 5))
LIGHT_TIMED = 2
# the partitioned EPD step with the halo exchange stubbed to the identity
STUB_WARMUP, STUB_TIMED = 1, 5
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
FIT_FRAMES, FIT_TRAJECTORIES = 3, 2
SUBPROCESS_TIMEOUT_S = 600
RANKS_TIMEOUT_S = 900


def _cs():
    import chip_smoke

    return chip_smoke


def k5_inputs(graph, width, seed, heads=None):
    """K5's inputs on part 0 of ``graph``'s 4-way split-edge partition, on
    the card, ``heads`` heads (``chip_smoke.HEADS`` by default): ``(n, local
    slots, (seg_a, seg_b), (mask_a, mask_b), (bounds_a, bounds_b),
    (scores_a, scores_b), (values_a, values_b), g)``, masked scores at -1e30
    as ``csr_sparse_attention`` masks them."""
    from graphphysics_torch.ops.csr_attention import NEG
    from graphphysics_torch.parallel.graph_partition import partition_graph_halo_np

    part = partition_graph_halo_np(graph, PARTS, split_local=True)[0]
    dev, h = torch.device("cuda"), heads or _cs().HEADS
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
    return n, el, seg, masks, bounds, scores, values, g


def k5_case(name, graph, width, seed, floor, heads=None):
    """K5 forward and backward on part 0 of ``graph``'s 4-way split-edge
    partition (``heads`` heads, ``chip_smoke.HEADS`` by default), against
    their plain versions on the card, timed beside their bounds, the plain
    versions and the replaced path."""
    from graphphysics_torch.ops.csr_attention import (
        _merge_partials,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_softmax_spmm_pair,
        csr_softmax_spmm_pair_backward,
        csr_softmax_spmm_pair_backward_reference,
        csr_softmax_spmm_pair_reference,
    )

    cs = _cs()
    h = heads or cs.HEADS
    n, el, seg, masks, bounds, scores, values, g = k5_inputs(graph, width, seed, h)

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


def _geometries():
    """The unsplit kernels' launch counts by geometry (K2's f32 entry, K3)."""
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm, csr_softmax_spmm_backward

    return {"csr_softmax_spmm": csr_softmax_spmm.geometries,
            "csr_softmax_spmm_backward": csr_softmax_spmm_backward.geometries}


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
    light = case.get("light", False)
    timed = LIGHT_TIMED if light else TIMED
    for _ in range(0 if light else WARMUP):
        tr.train_step(batch)
    _sync(device)
    _peak_gb(device, reset=True)
    dist.barrier(group=graph_group(GRAPH_AXIS))
    for fn in counts.values():
        fn.launches = 0
    for by_kind in _geometries().values():
        by_kind.update(dict.fromkeys(by_kind, 0))
    t0 = time.perf_counter()
    losses = [tr.train_step(batch) for _ in range(timed)]
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    geometries = {k: dict(by_kind) for k, by_kind in _geometries().items()}
    breakdown = _profiled_steps(tr, batch, device) if rank == 0 and not light else None
    if rank != 0 and not light:
        for _ in range(PROFILED):
            tr.train_step(batch)
        _sync(device)
    no_exchange = _stubbed_steps(tr, batch, device, counts) if case.get("stub") else None
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
        "timed_steps": timed,
        "ms_per_step": seconds / timed * 1e3,
        "launches": launches,
        "geometries": geometries,
        "peak_memory_gb": _peak_gb(device),
        "host_ms_per_step": float(np.mean(tr.host_ms[-timed:])),
        "part_nodes": int(part.num_nodes),
        "part_edge_slots": int(part.num_edges),
        "local_edge_slots": part.num_local_edges,
        "halo_budget": b,
        "halo_bytes_per_layer_each_way": None if b is None else (PARTS - 1) * b * columns * itemsize,
        "breakdown": breakdown,
        "no_exchange": no_exchange,
    }


def _stubbed_steps(tr, batch, device, counts) -> dict:
    """STUB_WARMUP steps, then STUB_TIMED timed ones, with the halo
    exchange the identity (``ops.halo.stub_exchange_for_benchmark``): the
    step without its exchange, forward and backward, for its time only
    (its values are wrong); the launches counted over the timed steps."""
    import torch.distributed as dist

    from graphphysics_torch.ops.halo import stub_exchange_for_benchmark
    from graphphysics_torch.parallel.mesh import GRAPH_AXIS, graph_group

    with stub_exchange_for_benchmark():
        for _ in range(STUB_WARMUP):
            tr.train_step(batch)
        _sync(device)
        dist.barrier(group=graph_group(GRAPH_AXIS))
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for _ in range(STUB_TIMED):
            tr.train_step(batch)
        _sync(device)
        seconds = time.perf_counter() - t0
    return {"ms_per_step": seconds / STUB_TIMED * 1e3,
            "launches": {k: fn.launches for k, fn in counts.items()}}


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


def width_cases(panels, mesh, seed) -> dict:
    """The rank steps of the transformer at ``WIDTH_STEPS`` on ``mesh``,
    split-edge and unsplit (``_rank_step`` cases, light)."""
    return {f"transformer_{layout}_w{d}": dict(param=with_width(panels, d, h), batch=mesh, seed=seed,
                                               split=layout == "split", light=True)
            for d, h in WIDTH_STEPS for layout in ("split", "unsplit")}


def width_references(panels, mesh, seed, total_steps) -> dict:
    """The unpartitioned card steps at ``WIDTH_STEPS`` (the fused
    attention, csr_attention.cu: code of its own that takes every width)
    from the weights ``width_cases`` draw: ``{(D, H): (first loss,
    gradients, None)}``."""
    refs = {(d, h): unpartitioned_steps(with_width(panels, d, h), mesh, seed, total_steps, timed=False)
            for d, h in WIDTH_STEPS}
    torch.cuda.empty_cache()
    return refs


def unsplit_geometries(name, ranks, key, width, heads, blocks):
    """The unsplit layout's K2 and K3 launches by geometry, summed over the
    ranks: every launch of each in the kind its rule gives the width
    (``softmax_spmm_kind`` on the 16-byte aligned rows the partitioned
    attention hands over), ``blocks`` a step and rank, none in another."""
    from graphphysics_torch.ops.csr_attention import softmax_spmm_kind

    timed = ranks[0][key]["timed_steps"]
    got = {k: {kind: sum(r[key]["geometries"][k][kind] for r in ranks) for kind in by_kind}
           for k, by_kind in ranks[0][key]["geometries"].items()}
    for k, backward in (("csr_softmax_spmm", False), ("csr_softmax_spmm_backward", True)):
        want = softmax_spmm_kind(width, heads, 16, backward)
        expected = {kind: blocks * timed * len(ranks) if kind == want else 0 for kind in got[k]}
        if got[k] != expected:
            raise AssertionError(f"{name}: {k} launched {got[k]} by geometry, expected {expected}")
    return got


def width_checks(ranks, blocks, refs, loss_rtol, grad_rtol, unpartitioned_grad_rtol):
    """``width_cases``' results: each layout's launches (``blocks`` of K5,
    or of K2 and K3, forward and backward a step and rank), the unsplit
    ones by geometry (``unsplit_geometries``); each layout's first step
    against the unpartitioned one (``refs``, the fused attention) within
    ``loss_rtol`` and ``unpartitioned_grad_rtol``, as the 128-wide steps
    are held; and the unsplit first step (K2, K3) against the split-edge
    one (K5) within ``loss_rtol`` and ``grad_rtol``. At 160 the first two
    see a fault of code K2, K3 and K5 share (``softmax_general.cuh``),
    which moves both sides of the third. Returns ``({"hidden_D_heads_H":
    readings}, {path: launches})``, the unsplit paths' launches with K2's
    and K3's by geometry as ``"name:kind"``."""
    out, launched = {}, {}
    for d, h in WIDTH_STEPS:
        width = {}
        for layout, expected in (("split", {"csr_softmax_spmm_pair": blocks,
                                            "csr_softmax_spmm_pair_backward": blocks}),
                                 ("unsplit", {"csr_softmax_spmm": blocks, "csr_softmax_spmm_backward": blocks})):
            key = f"transformer_{layout}_w{d}"
            summary = summarize(f"partitioned_transformer_training:{key}", [r[key] for r in ranks], expected,
                                None)
            width[layout] = {k: summary[k] for k in ("timed_steps", "ms_per_step_per_rank",
                                                     "launches_per_step_per_rank", "launches", "first_loss")}
            width[layout].update(compare_step(f"partitioned_transformer_training:{key}", refs[d, h], ranks[0][key],
                                              loss_rtol, unpartitioned_grad_rtol))
            launched[f"partitioned_transformer_training:{key}"] = summary["launches"]
            if layout == "unsplit":
                kinds = unsplit_geometries(f"partitioned_transformer_training:{key}", ranks, key, d, h, blocks)
                width[layout]["launches_by_geometry"] = kinds
                launched[f"partitioned_transformer_training:{key}"].update(
                    {f"{k}:{kind}": n for k, by_kind in kinds.items() for kind, n in by_kind.items()})
        unsplit = ranks[0][f"transformer_unsplit_w{d}"]
        width["split_against_unsplit"] = compare_step(
            f"partitioned_transformer_training:split_against_unsplit_w{d}",
            (unsplit["first_loss"], unsplit["grads"]), ranks[0][f"transformer_split_w{d}"], loss_rtol, grad_rtol)
        out[f"hidden_{d}_heads_{h}"] = width
    return out, launched


def with_width(param, hidden, heads):
    """A copy of the config ``param`` with the model's ``hidden_size`` and
    ``num_heads`` set."""
    import copy

    param = copy.deepcopy(param)
    param["model"].update(hidden_size=hidden, num_heads=heads)
    return param


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


def unpartitioned_steps(param, graph, seed, total_steps, timed=True):
    """The unpartitioned card step on ``graph`` from the weights the
    partitioned Trainer draws: the first step's loss and gradients, then
    WARMUP steps and the ms of TIMED ones (None without ``timed``)."""
    from graphphysics_torch.training import Trainer

    tr = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda",
                 metrics_path=None, rollout_dir=None)
    tr.init_state(total_steps)
    dev_graph = graph.to("cuda")
    loss = tr.train_step(dev_graph).item()
    grads = {n: p.grad.detach().cpu().numpy() for n, p in tr.sim.named_parameters()}
    if not timed:
        del tr
        return loss, grads, None
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
    timed = ranks[0]["timed_steps"]
    want = {k: expected.get(k, 0) * timed for k in ranks[0]["launches"]}
    for r, res in enumerate(ranks):
        if res["launches"] != want:
            raise AssertionError(f"{name}: rank {r} launched {res['launches']} in {timed} steps, "
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
        "timed_steps": timed,
        "launches_per_step_per_rank": {k: v / timed for k, v in ranks[0]["launches"].items() if v},
        "launches": {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]},
        "first_loss": ranks[0]["losses"][0], "last_loss": ranks[0]["losses"][-1],
        "rank0_breakdown": ranks[0]["breakdown"],
        **{k: ranks[0][k] for k in ("part_nodes", "part_edge_slots", "local_edge_slots",
                                    "halo_budget", "halo_bytes_per_layer_each_way")},
    }


def no_exchange_summary(ranks, blocks) -> dict:
    """Each rank's partitioned EPD step with and without the halo exchange
    (``_stubbed_steps`` beside the timed steps): ms a step a rank, the
    exchange's ms and share of the step; raises unless every rank launched
    K1 and K1b ``blocks`` times a stubbed step and nothing else."""
    want = {k: 0 for k in ranks[0]["no_exchange"]["launches"]}
    want.update({"csr_segment_sum": blocks * STUB_TIMED,
                 "csr_segment_sum_backward": blocks * STUB_TIMED})
    for r, res in enumerate(ranks):
        if res["no_exchange"]["launches"] != want:
            raise AssertionError(f"partitioned_no_exchange: rank {r} launched "
                                 f"{res['no_exchange']['launches']} in {STUB_TIMED} steps, "
                                 f"expected {want}")
    with_ms = [res["ms_per_step"] for res in ranks]
    without_ms = [res["no_exchange"]["ms_per_step"] for res in ranks]
    return {
        "warmup_steps": STUB_WARMUP, "steps_timed": STUB_TIMED,
        "ms_per_step_per_rank_with_exchange": with_ms,
        "ms_per_step_per_rank_without_exchange": without_ms,
        "exchange_ms_per_step_per_rank": [a - b for a, b in zip(with_ms, without_ms)],
        "exchange_share_per_rank": [(a - b) / a for a, b in zip(with_ms, without_ms)],
        "launches_per_step_per_rank": {k: v / STUB_TIMED for k, v in want.items() if v},
        "launches": {k: v * len(ranks) for k, v in want.items()},
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


def k5_phase(clock, seed, tf_frames, aneurysm_csr, floor):
    """K5 on the card; returns ``(forward shapes, backward shapes)`` for the
    kernels line, the training path's shape second, as it reads them. The
    last shape is the split-edge path's at hidden 40 in 8 heads of 5, the
    mesh's part 0: K5's general geometry (``softmax_general.cuh``; its f32
    V columns take widths that are multiples of 32 only,
    ``csr_softmax_spmm_pair.cu``)."""
    cs = _cs()
    mesh = mesh_graph("csr", seed + 601)
    shapes = [k5_case("serving_frame_2048_part0_of_4", tf_frames[0], cs.HIDDEN, seed + 1, floor),
              k5_case("mesh_16384_part0_of_4", mesh, cs.HIDDEN, seed, floor),
              k5_case("aneurysm_csr_66560x524288_part0_of_4", aneurysm_csr, 64, seed + 2, floor),
              k5_case("mesh_16384_part0_of_4_d40_h8", mesh, 40, seed + 3, floor, heads=8)]
    for f, b in shapes:
        clock.emit({"phase": "k5_pair", "name": "csr_softmax_spmm_pair", **f})
        clock.emit({"phase": "k5_pair", "name": "csr_softmax_spmm_pair_backward", **b})
    return [f for f, _ in shapes], [b for _, b in shapes]


def partition_phases(clock, seed, cylinder, panels, epd_frames, tf_frames):
    """Every partitioned phase but ``k5_pair``; returns ``{path:
    launches}`` for the kernels line."""
    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.parallel.mesh import launch

    cs = _cs()
    meshes = {"epd": mesh_graph("sorted", seed + 600), "transformer": mesh_graph("csr", seed + 601)}
    # the unpartitioned card steps the partitioned first steps are held to --
    total_steps = 1 + WARMUP + TIMED + PROFILED
    ref = {"epd": unpartitioned_steps(cylinder, meshes["epd"], seed, total_steps),
           "transformer": unpartitioned_steps(panels, meshes["transformer"], seed, total_steps)}
    # the fused f32 kernels' launches by geometry in those steps: the general
    # code of csr_attention.cuh at 160 in 5 heads (40 words, past the word
    # geometry)
    from graphphysics_torch.ops.csr_attention import csr_attention, csr_attention_backward

    before = [dict(fn.geometries) for fn in (csr_attention, csr_attention_backward)]
    width_refs = width_references(panels, meshes["transformer"], seed, total_steps)
    fused_by_geometry = {name: {k: fn.geometries[k] - b[k] for k in b} for name, fn, b in
                         (("csr_attention", csr_attention, before[0]),
                          ("csr_attention_backward", csr_attention_backward, before[1]))}
    roll = {"epd": stack_graphs([epd_frames[t] for t in range(ROLLOUT_FRAMES)]),
            "transformer": stack_graphs([tf_frames[t] for t in range(ROLLOUT_FRAMES)])}
    torch.cuda.empty_cache()

    # the ranks -------------------------------------------------------------------
    spec = {
        "total_steps": total_steps,
        "steps": {
            "epd_f32": dict(param=cylinder, batch=meshes["epd"], seed=seed, stub=True),
            "epd_bf16": dict(param=cylinder, batch=meshes["epd"], seed=seed, wire="bf16"),
            "transformer_split": dict(param=panels, batch=meshes["transformer"], seed=seed,
                                      split=True),
            "transformer_unsplit": dict(param=panels, batch=meshes["transformer"], seed=seed,
                                        split=False),
            **width_cases(panels, meshes["transformer"], seed),
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
    no_exchange = no_exchange_summary([r["epd_f32"] for r in ranks], blocks)
    paths_launched["partitioned_no_exchange"] = no_exchange["launches"]
    clock.emit({"phase": "partitioned_no_exchange", "model": f"EncodeProcessDecode {blocks}x"
                f"{cylinder['model']['hidden_size']}, {cs.CYLINDER_CONFIG}", "wire": "f32",
                "graph": f"triangulated_grid{MESH}, {meshes['epd'].num_nodes} nodes",
                "ranks_share_one_card": True, **no_exchange})
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
        if not split:  # K2 in 16-byte words of one head, K3 in V columns
            tf[key]["launches_by_geometry"] = unsplit_geometries(
                f"partitioned_transformer_training:{key}", ranks, key, panels["model"]["hidden_size"],
                panels["model"]["num_heads"], tf_blocks)
        paths_launched[f"partitioned_transformer_training:{key}"] = summary["launches"]
    unsplit = ranks[0]["transformer_unsplit"]
    tf["split_against_unsplit"] = compare_step(
        "partitioned_transformer_training:split_against_unsplit",
        (unsplit["first_loss"], unsplit["grads"]), ranks[0]["transformer_split"], cs.STEP_LOSS_RTOL,
        cs.TRANSFORMER_GRAD_RTOL)
    widths, launched = width_checks(ranks, tf_blocks, width_refs, cs.STEP_LOSS_RTOL, cs.TRANSFORMER_GRAD_RTOL,
                                    PARTITIONED_TRANSFORMER_GRAD_RTOL)
    tf.update(widths)
    tf["width_references_fused_launches_by_geometry"] = fused_by_geometry
    paths_launched.update(launched)
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
    return paths_launched


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
