#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--frames 50]

Run from the root of the repository on a machine with an NVIDIA Hopper card
and the CUDA toolkit. Phases, each of which raises on failure:

1. environment and build: the card (``nvidia-smi``), torch and CUDA
   versions, and ``nvcc`` building every kernel of ``graphphysics_torch/csrc``
   at once (one process per source), with each source's build seconds;
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, with device times, the memory bound and, where one exists, one
   PyTorch call as a yardstick. K1 (``csr_segment_sum``) at the EPD serving
   frame, the cylinder training batch (8 graphs of 2,048 nodes / 12,288
   edges) and the aneurysm_epd scale (66,560 nodes / 524,288 edges); K2
   (``csr_softmax_spmm``) at the transformer serving frame, the panels_csr
   batch (8 x 2,048 / 12,288) and the aneurysm_csr scale (66,560 / 524,288,
   width 64); the fused attention forward (``csr_attention``) and backward
   (``csr_attention_backward``) at K2's shapes, q, k and v in the model's
   layout, each beside its plain version, the PyTorch path it replaced
   (gathers + SDDMM around K2; autograd through them with K3) and SDPA with
   the dense adjacency as its mask (frame and batch), at every lane count
   the width allows;
3. EPD serving: a synthetic cylinder trajectory rolled out by the 15 x 128
   EncodeProcessDecode simulator (random weights from the seed) on the card,
   checked against the same rollout on the CPU, with the launch counts;
4. EPD batched forward: one eval forward on the cylinder batch;
5. transformer serving: a synthetic panels trajectory rolled out by the
   15 x 128, 4-head EncodeTransformDecode simulator built from
   ``training_config/panels.json`` (random weights from the seed), checked
   the same way;
6. transformer batched forward: one eval forward on the panels_csr batch;
7. backward kernels: K1b (``csr_segment_sum_backward``) at K1's three shapes
   and K3 (``csr_softmax_spmm_backward``) at K2's (K2 and K3 run on no
   path of the models now: the fused kernels took their place), each against its plain
   version on the card, ``torch.autograd.grad`` through the wrapper against
   the same call through the plain forward, with device times and bounds;
8. training: ``Trainer`` steps of the 15 x 128 EncodeProcessDecode
   (``training_config/cylinder.json``) on the cylinder batch and of the
   15 x 128, 4-head EncodeTransformDecode (``panels.json``) on the panels_csr
   batch: 3 warm-up steps, 20 timed ones with the launches per step checked,
   the first step against the same step on the CPU from equal weights, and
   a ``torch.profiler`` breakdown of 3 steps;
9. training pipeline: synthetic trajectories through ``BaseDataset``,
   ``GraphLoader`` and ``Trainer.fit`` with rollout validation, for both
   models, launches checked;
10. checkpoints (``epd_checkpoint``, ``transformer_checkpoint``): on the
    same kind of in-memory trajectories, per model, ``fit`` for 2 epochs
    saving every step (run A), the same interrupted after batch 2 (run B)
    and resumed from its checkpoint (run C), held against A (step,
    learning rate and batch stream exactly, parameters within
    ``RESUME_MEDIAN_RTOL`` and a per-model worst limit); the final checkpoint reloaded into a fresh
    ``Trainer`` on the card bitwise; ``predict`` from it on the card with
    its launches checked, against the trained model's and the CPU's; the
    checkpoint's bytes, save and load seconds and predict's ms per frame.

Every line but the last is a JSON object (one per phase), apart from the
card's ``nvidia-smi`` line; the ``{"kernels": [...]}`` line comes just before
the last line, ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, without a CUDA card or outside the repository. float32 matmuls run
without TF32 (``allow_tf32 = False`` for matmul and cuDNN): the CPU
comparison is float32.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores (same sheet)
L2_BYTES = 50 * 2**20
HIDDEN = 128
BLOCKS = 15
HEADS = 4
# f32 sums of ~10 N(0,1) terms per row in another order than index_add_
KERNEL_ATOL = 1e-4
# K1b is a gather: exact
GATHER_ATOL = 0.0
# K3 vs its plain version: the same formula, expf and per-head sums in
# another order
K3_RTOL, K3_ATOL = 1e-5, 1e-5
# K3 through autograd vs autograd of the plain two-pass softmax: the delta
# identity against the softmax's own backward, f32
K3_GRAD_RTOL, K3_GRAD_ATOL = 1e-4, 1e-4
# K2: online vs two-pass softmax in f32, a few ulps per edge of a row
SOFTMAX_ATOL = 1e-5
SOFTMAX_RTOL = 1e-5
# GPU vs CPU rollout, f32 without TF32, first frames
ROLLOUT_ATOL = 1e-4
ROLLOUT_RTOL = 1e-4
CPU_FRAMES = 3
PANELS_CONFIG = "training_config/panels.json"
CYLINDER_CONFIG = "training_config/cylinder.json"
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 20, 3
# first training step on the card vs the CPU from equal weights: f32
# without TF32, 15 blocks deep, sums in another order and atomics in the
# gathers' (EPD) and the fused attention's (transformer) backward
STEP_LOSS_RTOL = 1e-5
# ||grad_card - grad_cpu|| / ||grad_cpu|| of each parameter, the worst one
# taken, per model: 15 blocks of f32 forward and backward in two summation
# orders. Sound runs on an H100 read 4.5e-4 (EPD) and 8.4e-7-1.1e-6
# (transformer); the same check on copies with a planted fault
# (chip_smoke_mutants.py) read 0.16 and 0.28 (K1b dropping one graph's
# gradient, or the last edge of each row) and 1.04e-3, 1.04e-2, 0.70 and
# 0.32 (the fused attention backward with ds 0.1% or 1% off, one graph's
# dk dropped, or each row's last edge dropped from dq).
EPD_GRAD_RTOL = 1e-2
TRANSFORMER_GRAD_RTOL = 1e-4
# parameters whose gradient is 0 in exact arithmetic: the softmax ignores a
# shift shared by a query's scores, so the key bias gets round-off only. Its
# largest gradient entry, over the largest of all other parameters', is held
# below STEP_ROUNDOFF_SHARE on each device instead (2.6e-10 read).
ROUNDOFF_LEAVES = ("k_proj.bias",)
STEP_ROUNDOFF_SHARE = 1e-6
# the resumed run (C) against the uninterrupted one (A) on the card, per
# parameter ||C - A|| / ||A - start||: the backwards sum with atomics
# (EPD: the gathers' index_add_; transformer: the fused attention's dk and
# dv), so two runs differ in round-off, which Adam's
# normalized steps carry into the weights. The median over the parameters
# and the worst one are held to limits. Sound runs on an H100 (C, and a
# rerun A' of A, two runs with the mutants' reruns) read medians of
# 8.9e-4-1.5e-3 (EPD) and 3.3e-6-4.3e-4 (transformer), worst 0.0099-0.044
# (EPD) and 6.0e-5-1.7e-3 (transformer); the same check with a fault
# planted in the restore (chip_smoke_mutants.py) read medians of 0.62 /
# 0.51 (AdamW state not restored) and 0.023 / 0.020 (normalizer statistics
# zeroed), worst 0.83 / 0.61 and 0.080 / 0.053 (EPD / transformer). The
# median's limit sits between the two for both faults; the worst one's
# limits, 5x and 12x the largest sound reading, catch only gross faults.
RESUME_MEDIAN_RTOL = 5e-3
EPD_RESUME_WORST_RTOL = 0.2
TRANSFORMER_RESUME_WORST_RTOL = 2e-2
# the most one AdamW step moves a leaf, in units of its learning rate
# (|m_hat / sqrt(v_hat)| <= 1.17 with beta1**2 < beta2, plus the decay): a
# round-off-only leaf of C and A can differ by twice the summed rates
ADAM_STEP_MAX = 1.2
# in-memory trajectories of the checkpoint phases: 32 items, 4 batches of 8
CKPT_TRAJECTORIES = 4
# graphs of the two training batches: nodes and real edges of each, padded
# to 2,048 / 12,288. Graph 0 has n_pad == n with padded edges on its real
# last node, graph 4 no padding at all; the others pad both.
BATCH_NODES = [2048, 2000, 1950, 1900, 2048, 1800, 1700, 1600]
BATCH_EDGES = [11906, 12000, 11500, 11000, 12288, 10500, 10000, 9500]
# in the panels batch graph 5 sends from its first 1,200 nodes only, so the
# softmax rows of its other 600 real nodes are empty
EMPTY_ROWS_GRAPH, EMPTY_ROWS_SENDERS = 5, 1200


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, inputs, min_reps=20, replays=5) -> float:
    """Device time of one ``fn(*args)`` call: a CUDA graph of calls cycling
    through ``inputs`` (copies sized to stream from device memory rather than
    L2), replayed and timed with CUDA events, so host overhead is excluded."""
    reps = max(min_reps, len(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in inputs[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def call_ms(fn, iters=20) -> float:
    """Eager time of one call, host included: CUDA events around ``iters``
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_past_l2(bytes_moved: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / bytes_moved))


def _category(kernel: str) -> str:
    k = kernel.lower()
    if "csr_attention_bwd" in k:
        return "csr_attention_bwd"
    if "csr_attention" in k:
        return "csr_attention"
    if "csr_segment_sum_bwd" in k:
        return "csr_segment_sum_bwd"
    if "csr_segment_sum" in k:
        return "csr_segment_sum"
    if "softmax_spmm_bwd" in k:
        return "softmax_spmm_bwd"
    if "softmax_spmm" in k:
        return "softmax_spmm"
    if "multi_tensor" in k or "adam" in k:
        return "optimizer"
    if "indexfunc" in k or "index_add" in k or "scatter" in k:
        return "index_add_scatter"
    if "gemm" in k or "cutlass" in k or "sm90_" in k:
        return "gemm"
    if "indexselect" in k or "index_select" in k or "gather" in k:
        return "gather"
    if "cat" in k:
        return "cat"
    if "reduce" in k:
        return "reduce"
    return "elementwise_other"


def device_breakdown(fn, frames: int, unit: str = "frame"):
    """Device time of ``fn`` (a rollout of ``frames`` frames, or ``frames``
    train steps with ``unit="step"``) by kernel, from torch.profiler's CUDA
    activity; None where the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # user-annotated ranges (the optimizer's step) span kernels counted on
    # their own rows: summing both would count that time twice
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA and not getattr(r, "is_user_annotation", False)]
    if not rows:
        return None

    def us(r):
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0.0)

    total_us = sum(us(r) for r in rows)
    per = f"ms_per_{unit}"
    groups = {}
    for r in rows:
        g = groups.setdefault(_category(r.key), {per: 0.0, f"kernels_per_{unit}": 0.0})
        g[per] += us(r) / 1e3 / frames
        g[f"kernels_per_{unit}"] += r.count / frames
    top = sorted(rows, key=us, reverse=True)[:8]
    return {
        f"device_ms_per_{unit}": total_us / 1e3 / frames,
        f"kernels_per_{unit}": sum(r.count for r in rows) / frames,
        "by_category": groups,
        "top_kernels": [
            {"name": r.key[:90], per: us(r) / 1e3 / frames, f"count_per_{unit}": r.count / frames}
            for r in top
        ],
    }


def random_graph(n, e, n_pad, e_pad, seed):
    """A receiver-sorted padded graph with the cylinder feature layout
    ``[vel_x, vel_y, node_type, time]`` and random topology."""
    from graphphysics_torch.core import pad_graph_sorted_np

    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, size=n)
    return pad_graph_sorted_np(
        x,
        r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n, size=e).astype(np.int32),
        r.integers(0, n, size=e).astype(np.int32),
        n_pad,
        e_pad,
        edge_attr=r.normal(size=(e, 3)).astype(np.float32),
        y=r.normal(size=(n, 2)).astype(np.float32),
        node_type_index=2,
    )


def random_csr_graph(n, e, n_pad, e_pad, seed, senders_below=None):
    """A sender-sorted (CSR) padded graph with the panels feature layout
    ``[vel(3), node_type, time]``, no edge features and random topology;
    senders are drawn below ``senders_below`` (default: every node)."""
    from graphphysics_torch.core import pad_graph_csr_np

    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 5)).astype(np.float32)
    x[:, 3] = r.integers(0, 7, size=n)
    return pad_graph_csr_np(
        x,
        r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n if senders_below is None else senders_below, size=e).astype(np.int32),
        r.integers(0, n, size=e).astype(np.int32),
        n_pad,
        e_pad,
        y=r.normal(size=(n, 3)).astype(np.float32),
        node_type_index=3,
    )


def flagship_batch(seed):
    """The cylinder workload batch: 8 receiver-sorted graphs concatenated."""
    from graphphysics_torch.core import concat_graphs

    return concat_graphs(
        [random_graph(n, e, 2048, 12288, seed + i)
         for i, (n, e) in enumerate(zip(BATCH_NODES, BATCH_EDGES))]
    )


def panels_batch(seed):
    """The panels_csr workload batch: 8 sender-sorted graphs concatenated,
    one of them with empty softmax rows."""
    from graphphysics_torch.core import concat_graphs

    return concat_graphs([
        random_csr_graph(n, e, 2048, 12288, seed + i,
                         senders_below=EMPTY_ROWS_SENDERS if i == EMPTY_ROWS_GRAPH else None)
        for i, (n, e) in enumerate(zip(BATCH_NODES, BATCH_EDGES))
    ])


def k1_case(name, graph, seed):
    """Hold csr_segment_sum against its plain version on one edge layout."""
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_reference

    dev = torch.device("cuda")
    recv = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.row_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n = recv.shape[0], bounds.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randn((e, HIDDEN), generator=gen, device=dev)

    with torch.no_grad():
        got = csr_segment_sum(data, recv, bounds, mask)
        want = csr_segment_sum_reference(data, recv, n, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{name}: kernel vs plain max_abs_err {err} > {KERNEL_ATOL}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel output not finite")
        # the yardstick sums the same function: masked rows zeroed beforehand
        lib_data = torch.where(mask[:, None], data, torch.zeros((), device=dev))

        def library(d, r):
            return torch.zeros((n, HIDDEN), device=dev).index_add_(0, r, d)

        lib_err = (library(lib_data, recv) - want).abs().max().item()

        # the kernel walks only the row ranges, which stop before the
        # padding: each real edge's data row and mask byte, each node's two
        # bounds and output row
        real_edges = int(mask.sum().item())
        bytes_moved = real_edges * (HIDDEN * 4 + 1) + n * (8 + HIDDEN * 4)
        copies = copies_past_l2(bytes_moved)
        datas = [data] + [data.clone() for _ in range(copies - 1)]
        libs = [lib_data] + [lib_data.clone() for _ in range(copies - 1)]
        kernel_t = device_ms(lambda d: csr_segment_sum(d, recv, bounds, mask), [(d,) for d in datas])
        plain_t = device_ms(lambda d: csr_segment_sum_reference(d, recv, n, mask), [(d,) for d in datas])
        library_t = device_ms(lambda d: library(d, recv), [(d,) for d in libs])
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_bound = real_edges * HIDDEN / H100_F32_OPS_PER_S * 1e3  # one f32 add per edge and column
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": real_edges,
        "hidden": HIDDEN,
        "max_abs_err": err,
        "tolerance": KERNEL_ATOL,
        "library_max_abs_err": lib_err,
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": library_t,
        "bound_ms": max(bound, ops_bound),
        "bound_by": "bytes" if bound >= ops_bound else "operations",
        "bytes": bytes_moved,
        "input_copies": copies,
    }


def k2_case(name, graph, width, seed):
    """Hold csr_softmax_spmm against its plain version on one sender-sorted
    layout, with scores masked as csr_sparse_attention masks them."""
    from graphphysics_torch.ops.csr_attention import (
        NEG,
        csr_softmax_spmm,
        csr_softmax_spmm_reference,
    )

    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n, h = seg.shape[0], bounds.shape[1], HEADS
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = 3 * torch.randn((e, h), generator=gen, device=dev)
    scores = torch.where(mask[:, None], scores, torch.full((), NEG, device=dev))
    values = torch.randn((e, width), generator=gen, device=dev)

    with torch.no_grad():
        out, ml = csr_softmax_spmm(scores, values, seg, bounds, mask)
        want_out, want_ml = csr_softmax_spmm_reference(scores, values, seg, n, mask)
        torch.cuda.synchronize()
        err = (out - want_out).abs().max().item()
        ml_err = (ml - want_ml).abs().max().item()
        for got, want, what in ((out, want_out, "out"), (ml, want_ml, "ml")):
            if not torch.allclose(got, want, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL):
                bad = (got - want).abs().max().item()
                raise AssertionError(f"{name}: kernel vs plain {what} max_abs_err {bad}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: kernel output not finite")
        empty_rows = int((want_ml[h:] == 0).all(dim=0).sum().item())

        # the kernel walks only the row ranges, which stop before the
        # padding: each real edge's scores, value row and mask byte; each
        # node's output row, (m, l) per head and two bounds. The segment ids
        # are not read: the ranges carry them.
        real_edges = int(mask.sum().item())
        bytes_moved = real_edges * (4 * h + 4 * width + 1) + n * (4 * width + 8 * h + 8)
        copies = copies_past_l2(bytes_moved)
        inputs = [(scores, values)] + [
            (scores.clone(), values.clone()) for _ in range(copies - 1)
        ]
        kernel_t = device_ms(lambda s, v: csr_softmax_spmm(s, v, seg, bounds, mask), inputs)
        plain_t = device_ms(lambda s, v: csr_softmax_spmm_reference(s, v, seg, n, mask), inputs)
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    # f32 operations: per real edge and column a multiply-add into the sum,
    # per real edge and head a max, an exponential and an add into l; per
    # output element one division
    ops = real_edges * (2 * width + 3 * h) + n * width
    ops_bound = ops / H100_F32_OPS_PER_S * 1e3
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": real_edges,
        "empty_rows": empty_rows,
        "width": width,
        "heads": h,
        "max_abs_err": err,
        "ml_max_abs_err": ml_err,
        "tolerance": {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL},
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a segment softmax + SpMM",
        "bound_ms": max(bound, ops_bound),
        "bound_by": "bytes" if bound >= ops_bound else "operations",
        "bytes": bytes_moved,
        "operations": ops,
        "input_copies": copies,
    }


def k1b_case(name, graph, seed):
    """Hold csr_segment_sum_backward against its plain version on one edge
    layout, and autograd through csr_segment_sum against autograd of the
    plain forward."""
    from graphphysics_torch.ops.csr_segment import (
        csr_segment_sum,
        csr_segment_sum_backward,
        csr_segment_sum_backward_reference,
        csr_segment_sum_reference,
    )

    dev = torch.device("cuda")
    recv = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.row_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n = recv.shape[0], bounds.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n, HIDDEN), generator=gen, device=dev)
    data = torch.randn((e, HIDDEN), generator=gen, device=dev)

    got = csr_segment_sum_backward(g, recv, bounds, mask)
    want = csr_segment_sum_backward_reference(g, recv, bounds, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= GATHER_ATOL or not bool((got[~mask] == 0).all()):
        raise AssertionError(f"{name}: K1b vs plain max_abs_err {err} > {GATHER_ATOL}")
    d = data.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(csr_segment_sum(d, recv, bounds, mask), d, g)
    d = data.clone().requires_grad_(True)
    (grad_plain,) = torch.autograd.grad(csr_segment_sum_reference(d, recv, n, mask), d, g)
    grad_err = (grad - grad_plain).abs().max().item()
    if not grad_err <= GATHER_ATOL:
        raise AssertionError(f"{name}: autograd through K1 vs plain max_abs_err {grad_err}")

    # every edge row is written; each node's g row and bounds read once;
    # each edge's receiver and mask byte read
    bytes_moved = e * HIDDEN * 4 + e * (4 + 1) + n * (HIDDEN * 4 + 8)
    copies = copies_past_l2(bytes_moved)
    gs = [(g,)] + [(g.clone(),) for _ in range(copies - 1)]
    with torch.no_grad():
        kernel_t = device_ms(lambda x: csr_segment_sum_backward(x, recv, bounds, mask), gs)
        plain_t = device_ms(lambda x: csr_segment_sum_backward_reference(x, recv, bounds, mask), gs)
        library_t = device_ms(lambda x: x.index_select(0, recv), gs)
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": int(mask.sum().item()),
        "hidden": HIDDEN,
        "max_abs_err": err,
        "tolerance": GATHER_ATOL,
        "autograd_max_abs_err": grad_err,
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": library_t,
        "library_note": "index_select(0, receivers): the same gather without zeroing masked and padded edges",
        "bound_ms": bound,
        "bound_by": "bytes",
        "bytes": bytes_moved,
        "input_copies": copies,
    }


def k3_case(name, graph, width, seed):
    """Hold csr_softmax_spmm_backward against its plain version on one
    sender-sorted layout (scores masked as csr_sparse_attention masks
    them), and autograd through csr_softmax_spmm against autograd of the
    plain forward."""
    from graphphysics_torch.ops.csr_attention import (
        NEG,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_softmax_spmm_backward_reference,
        csr_softmax_spmm_reference,
    )

    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n, h = seg.shape[0], bounds.shape[1], HEADS
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = 3 * torch.randn((e, h), generator=gen, device=dev)
    scores = torch.where(mask[:, None], scores, torch.full((), NEG, device=dev))
    values = torch.randn((e, width), generator=gen, device=dev)
    g = torch.randn((n, width), generator=gen, device=dev)
    with torch.no_grad():
        out, ml = csr_softmax_spmm(scores, values, seg, bounds, mask)

    got = csr_softmax_spmm_backward(scores, values, seg, bounds, ml, out, g, mask)
    want = csr_softmax_spmm_backward_reference(scores, values, seg, ml, out, g, mask)
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    for a, b, what in zip(got, want, ("dscores", "dvalues")):
        if not torch.isfinite(a).all() or not bool((a[~mask] == 0).all()):
            raise AssertionError(f"{name}: K3 {what} not finite, or not 0 on masked edges")
        if not torch.allclose(a, b, rtol=K3_RTOL, atol=K3_ATOL):
            raise AssertionError(f"{name}: K3 vs plain {what} max_abs_err {(a - b).abs().max().item()}")

    def grads_of(forward):
        s_, v_ = scores.clone().requires_grad_(True), values.clone().requires_grad_(True)
        return torch.autograd.grad(forward(s_, v_)[0], (s_, v_), g)

    kernel_grads = grads_of(lambda s_, v_: csr_softmax_spmm(s_, v_, seg, bounds, mask))
    plain_grads = grads_of(lambda s_, v_: csr_softmax_spmm_reference(s_, v_, seg, n, mask))
    grad_errs = [(a - b).abs().max().item() for a, b in zip(kernel_grads, plain_grads)]
    for a, b in zip(kernel_grads, plain_grads):
        if not torch.allclose(a, b, rtol=K3_GRAD_RTOL, atol=K3_GRAD_ATOL):
            raise AssertionError(f"{name}: autograd through K2/K3 vs plain max_abs_err {grad_errs}")

    # reads: each real edge's scores, value row and mask byte; each node's
    # out and g rows, (m, l) per head and two bounds. Writes: every edge's
    # dscores and dvalues rows, padding included.
    real_edges = int(mask.sum().item())
    bytes_moved = (real_edges * (4 * h + 4 * width + 1) + n * (8 * width + 8 * h + 8)
                   + e * (4 * h + 4 * width))
    copies = copies_past_l2(bytes_moved)
    inputs = [(scores, values, ml, out, g)] + [
        tuple(t.clone() for t in (scores, values, ml, out, g)) for _ in range(copies - 1)
    ]
    with torch.no_grad():
        kernel_t = device_ms(
            lambda s_, v_, ml_, o_, g_: csr_softmax_spmm_backward(s_, v_, seg, bounds, ml_, o_, g_, mask),
            inputs)
        plain_t = device_ms(
            lambda s_, v_, ml_, o_, g_: csr_softmax_spmm_backward_reference(s_, v_, seg, ml_, o_, g_, mask),
            inputs)
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    # f32 operations per real edge: per head an exponential, a division and
    # the dscores product; per column the dvalues product and the dot's
    # multiply-add; per node and column the delta multiply-add
    ops = real_edges * (3 * width + 3 * h) + n * 2 * width
    ops_bound = ops / H100_F32_OPS_PER_S * 1e3
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": real_edges,
        "empty_rows": int((ml[h:] == 0).all(dim=0).sum().item()),
        "width": width,
        "heads": h,
        "max_abs_err": max(errs),
        "dscores_dvalues_max_abs_err": errs,
        "tolerance": {"rtol": K3_RTOL, "atol": K3_ATOL},
        "autograd_max_abs_err": grad_errs,
        "autograd_tolerance": {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL},
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the softmax + SpMM backward",
        "bound_ms": max(bound, ops_bound),
        "bound_by": "bytes" if bound >= ops_bound else "operations",
        "bytes": bytes_moved,
        "operations": ops,
        "input_copies": copies,
    }


def replaced_attention(q, k, v, seg, gather, bounds, mask, scale):
    """The transformer's attention as it ran before the fused kernels: the
    gathers and the per-head dot as PyTorch ops around K2
    (``csr_softmax_spmm``), differentiable through K3 and ``index_add_``."""
    from graphphysics_torch.ops.csr_attention import NEG, csr_softmax_spmm

    n, h, dh = q.shape
    d = h * dh
    q_e = q.reshape(n, d).index_select(0, seg)
    k_e = k.reshape(n, d).index_select(0, gather)
    v_e = v.reshape(n, d).index_select(0, gather)
    scores = (q_e * k_e).reshape(-1, h, dh).sum(dim=-1) * scale
    scores = torch.where(mask[:, None], scores, torch.full((), NEG, device=q.device))
    out, _ = csr_softmax_spmm(scores, v_e, seg, bounds, mask)
    return out.reshape(n, h, dh)


def dense_adjacency(seg, gather, mask, n):
    """The [N, N] boolean adjacency of the unmasked edges (row: the
    softmax side), for the SDPA yardstick, and the rows whose edges are
    all distinct and not empty (where SDPA computes the same function)."""
    adj = torch.zeros((n, n), dtype=torch.bool, device=seg.device)
    s, j = seg[mask].long(), gather[mask].long()
    adj[s, j] = True
    per_row = torch.zeros(n, dtype=torch.int64, device=seg.device).index_add_(0, s, torch.ones_like(s))
    return adj, (per_row == adj.sum(dim=1)) & (per_row > 0)


def attention_inputs(graph, width, seed):
    """q, k, v and an output gradient at ``width`` with 4 heads, in the
    layout the model's Attention passes ((N, Dh, H) memory), and the
    graph's device tensors."""
    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    gather = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    n, h = bounds.shape[1], HEADS
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkvg = [torch.randn((n, width // h, h), generator=gen, device=dev).transpose(1, 2)
            for _ in range(4)]
    return seg, gather, bounds, mask, qkvg


def fused_case(name, graph, width, seed, library=True):
    """Hold both fused attention kernels (``csr_attention`` and
    ``csr_attention_backward``) against their plain versions on one
    sender-sorted layout at ``width`` with 4 heads in the model's layout, and
    time each beside its bound, its plain version, the PyTorch path it
    replaced (gathers + SDDMM + K2; autograd through them with K3 and
    ``index_add_``) and, with ``library``, SDPA with the dense adjacency as
    its mask. Returns (forward record, backward record)."""
    from graphphysics_torch.ops import csr_attention as ca

    seg, gather, bounds, mask, (q, k, v, g) = attention_inputs(graph, width, seed)
    n, h = bounds.shape[1], HEADS
    scale = h ** -0.5
    interleaved = ca._is_interleaved(q)
    with torch.no_grad():
        out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale)
        want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, n, mask, scale)
        grads = ca.csr_attention_backward(q, k, v, seg, gather, bounds, ml, out, g, mask, scale)
        want_grads = ca.csr_attention_backward_reference(q, k, v, seg, gather, ml, out, g, mask, scale)
    torch.cuda.synchronize()
    fwd_errs = [(a - b).abs().max().item() for a, b in ((out, want_out), (ml, want_ml))]
    for got, want, what in ((out, want_out, "out"), (ml, want_ml, "ml")):
        if not torch.isfinite(got).all() or not torch.allclose(got, want, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL):
            raise AssertionError(f"{name}: fused forward vs plain {what} max_abs_err {fwd_errs}")
    bwd_errs = [(a - b).abs().max().item() for a, b in zip(grads, want_grads)]
    for a, b in zip(grads, want_grads):
        if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=K3_GRAD_RTOL, atol=K3_GRAD_ATOL):
            raise AssertionError(f"{name}: fused backward vs plain dq/dk/dv max_abs_err {bwd_errs}")
    empty_rows = int((want_ml[h:] == 0).all(dim=0).sum().item())
    edges_read = int((bounds[1] - bounds[0]).clamp(min=0).sum().item())  # the ranges' edges
    real_edges = int(mask.sum().item())

    # bytes: q, k, v read once (the gathered rows are node rows, which fit
    # the L2), each range edge's gather index and mask byte, the bounds,
    # out and ml; the backward also reads out and g and writes dq, dk, dv
    row = 4 * width
    fwd_bytes = n * 3 * row + edges_read * 5 + n * 8 + n * row + n * 8 * h
    bwd_bytes = n * 5 * row + edges_read * 5 + n * 8 + n * 8 * h + n * 3 * row
    # f32 operations. Forward per real edge and column the dot's and the
    # sum's multiply-adds, per head the scale, a max, two exponentials and
    # l's update; per output element a division. Backward per real edge and
    # column the two dots, dq's, dk's and dv's products and adds; per head
    # an exponential, a division and ds; per node and column delta's.
    fwd_ops = real_edges * (4 * width + 6 * h) + n * width
    bwd_ops = real_edges * (11 * width + 6 * h) + n * 2 * width
    copies = copies_past_l2(fwd_bytes)
    sets = [(q, k, v, g)] + [tuple(t.clone() for t in (q, k, v, g)) for _ in range(copies - 1)]
    saved = []
    with torch.no_grad():
        for q_, k_, v_, _ in sets:
            saved.append(ca.csr_attention(q_, k_, v_, seg, gather, bounds, mask, scale))
    lanes = [x for x in ca.FORWARD_LANES if ca._geometry_ok(x, width, h, interleaved)]
    fwd_by_lanes, bwd_by_lanes = {}, {}
    with torch.no_grad():
        fwd_t = device_ms(lambda a, b, c, _: ca.csr_attention(a, b, c, seg, gather, bounds, mask, scale),
                          sets)
        bwd_inputs = [(*st, *sv) for st, sv in zip(sets, saved)]
        bwd_t = device_ms(
            lambda a, b, c, g_, o_, ml_: ca.csr_attention_backward(a, b, c, seg, gather, bounds, ml_, o_, g_,
                                                                   mask, scale), bwd_inputs)
        for x in lanes:
            fwd_by_lanes[x] = device_ms(lambda a, b, c, _: ca._launch_attention(
                a, b, c, gather, bounds, mask, scale, interleaved, lanes=x), sets)
            bwd_by_lanes[x] = device_ms(lambda a, b, c, g_, o_, ml_: ca._launch_attention_backward(
                a, b, c, gather, bounds, mask, ml_, o_, g_, scale, interleaved, lanes=x), bwd_inputs)
        fwd_plain = device_ms(
            lambda a, b, c, _: ca.csr_attention_reference(a, b, c, seg, gather, n, mask, scale), sets)
        bwd_plain = device_ms(
            lambda a, b, c, g_, o_, ml_: ca.csr_attention_backward_reference(
                a, b, c, seg, gather, ml_, o_, g_, mask, scale), bwd_inputs)
        fwd_replaced = device_ms(lambda a, b, c, _: replaced_attention(a, b, c, seg, gather, bounds, mask,
                                                                       scale), sets)

    def fwd_bwd(forward):
        def run(a, b, c, g_):
            leaves = [t.detach().requires_grad_(True) for t in (a, b, c)]
            return torch.autograd.grad(forward(*leaves), leaves, g_)
        return run

    fused_fb = device_ms(fwd_bwd(lambda a, b, c: ca.csr_sparse_attention(a, b, c, seg, gather, bounds, mask,
                                                                         scale)), sets)
    replaced_fb = device_ms(fwd_bwd(lambda a, b, c: replaced_attention(a, b, c, seg, gather, bounds, mask,
                                                                       scale)), sets)
    lib = {"library_ms": None, "library_fwd_bwd_ms": None,
           "library_note": (f"n/a: SDPA needs a dense [{n}, {n}] mask ({n * n / 1e9:.1f} GB as bool) "
                            f"and materializes f32 scores of {4 * h * n * n / 1e9:.0f} GB")}
    if library:
        import torch.nn.functional as F

        adj, same_rows = dense_adjacency(seg, gather, mask, n)

        def sdpa(a, b, c):  # [N, H, Dh] -> [1, H, N, Dh]
            return F.scaled_dot_product_attention(
                a.transpose(0, 1)[None], b.transpose(0, 1)[None], c.transpose(0, 1)[None],
                attn_mask=adj, scale=scale)[0].transpose(0, 1)

        with torch.no_grad():
            lib_err = (sdpa(q, k, v) - out)[same_rows].abs().max().item()
            lib_fwd = device_ms(lambda a, b, c, _: sdpa(a, b, c), sets, min_reps=3)
        lib_fb = device_ms(fwd_bwd(sdpa), sets, min_reps=3)
        lib = {"library_ms": lib_fwd, "library_fwd_bwd_ms": lib_fb,
               "library_max_abs_err": lib_err, "library_rows_compared": int(same_rows.sum().item()),
               "library_note": ("torch.nn.functional.scaled_dot_product_attention, dense boolean "
                                "adjacency mask, compared on rows with edges and no repeated edge "
                                "(SDPA counts a repeated edge once, and gives NaN on a row without one)")}
    common = {"shape": name, "nodes": n, "edges": seg.shape[0], "real_edges": real_edges,
              "empty_rows": empty_rows, "width": width, "heads": h, "layout": "(N, Dh, H) view",
              "lanes_per_row": {"forward": ca.lanes_per_row(width, h, interleaved),
                                "backward": ca.lanes_per_row(width, h, interleaved, backward=True)},
              "input_copies": copies,
              "fused_fwd_bwd_ms": fused_fb, "replaced_fwd_bwd_ms": replaced_fb}
    fwd_bound, fwd_ops_bound = fwd_bytes / H100_BYTES_PER_S * 1e3, fwd_ops / H100_F32_OPS_PER_S * 1e3
    bwd_bound, bwd_ops_bound = bwd_bytes / H100_BYTES_PER_S * 1e3, bwd_ops / H100_F32_OPS_PER_S * 1e3
    forward = {
        **common,
        "max_abs_err": max(fwd_errs),
        "out_ml_max_abs_err": fwd_errs,
        "tolerance": {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL},
        "ms": fwd_t,
        "ms_by_lanes": fwd_by_lanes,
        "plain_ms": fwd_plain,
        "replaced_ms": fwd_replaced,
        "replaced_note": "PyTorch gathers + per-head dot + masking around K2 (csr_softmax_spmm)",
        "library_ms": lib["library_ms"],
        "library_note": lib["library_note"],
        **{k_: v_ for k_, v_ in lib.items() if k_ not in ("library_ms", "library_note")},
        "bound_ms": max(fwd_bound, fwd_ops_bound),
        "bound_by": "bytes" if fwd_bound >= fwd_ops_bound else "operations",
        "bytes": fwd_bytes,
        "operations": fwd_ops,
    }
    lib_bwd = None if lib["library_ms"] is None else lib["library_fwd_bwd_ms"] - lib["library_ms"]
    backward = {
        **common,
        "max_abs_err": max(bwd_errs),
        "dq_dk_dv_max_abs_err": bwd_errs,
        "tolerance": {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL},
        "ms": bwd_t,
        "ms_by_lanes": bwd_by_lanes,
        "plain_ms": bwd_plain,
        "replaced_ms": replaced_fb - fwd_replaced,
        "replaced_note": ("autograd through the replaced forward (K3, the dot's backward, index_add_ "
                          "scatters) less that forward's time"),
        "library_ms": lib_bwd,
        "library_note": (lib["library_note"] if lib_bwd is None else
                         "SDPA forward+backward less its forward; " + lib["library_note"]),
        "bound_ms": max(bwd_bound, bwd_ops_bound),
        "bound_by": "bytes" if bwd_bound >= bwd_ops_bound else "operations",
        "bytes": bwd_bytes,
        "operations": bwd_ops,
    }
    return forward, backward


def build_epd(seed, device):
    from graphphysics_torch.core import NodeType
    from graphphysics_torch.models import (
        EncodeProcessDecode,
        Simulator,
        SimulatorConfig,
        reset_parameters,
    )

    cfg = SimulatorConfig(
        node_input_size=2 + int(NodeType.SIZE), edge_input_size=3, output_size=2,
        feature_index_start=0, feature_index_end=2,
        output_index_start=0, output_index_end=2, node_type_index=2,
    )
    model = EncodeProcessDecode(BLOCKS, cfg.node_input_size, 3, 2, HIDDEN)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return Simulator(cfg, model, device=device)


def build_transformer(param, seed, device):
    from graphphysics_torch.models import reset_parameters
    from graphphysics_torch.training import get_simulator

    sim = get_simulator(param, device="cpu")
    reset_parameters(sim.model, torch.Generator().manual_seed(seed))
    return sim.to(device)


def serve(name, make_sim, frames, counts, expected, seed):
    """Roll ``frames`` out on the card with a simulator from ``make_sim``:
    zero every launch count just before the rollout, check them just after
    against ``expected`` (kernel name -> launches), hold the first frames
    against the CPU, and time the eager and CUDA-graph forwards."""
    from graphphysics_torch.training import rollout, rollout_rmse

    sim = make_sim(seed, "cuda")
    frames_dev = frames.to("cuda")
    n_frames = frames_dev.x.shape[0]
    for t in range(n_frames):
        sim.accumulate_stats(frames_dev[t])
    rollout(sim, frames_dev[:2], device="cuda")  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    preds, targets = rollout(sim, frames_dev, device="cuda")
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: expected.get(k, 0) * n_frames for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    out_width = sim.config.output_index_end - sim.config.output_index_start
    if preds.shape != (n_frames, frames.num_nodes, out_width) or not torch.isfinite(preds).all():
        raise AssertionError(f"{name}: bad predictions {tuple(preds.shape)}")

    sim_cpu = make_sim(seed, "cpu")
    sim_cpu.load_state_dict({k: v.cpu() for k, v in sim.state_dict().items()})
    preds_cpu, _ = rollout(sim_cpu, frames[:CPU_FRAMES], device="cpu")
    cpu_err = (preds[:CPU_FRAMES].cpu() - preds_cpu).abs().max().item()
    if not torch.allclose(preds[:CPU_FRAMES].cpu(), preds_cpu, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL):
        raise AssertionError(f"{name}: GPU vs CPU rollout max_abs_err {cpu_err}")

    with torch.inference_mode():
        eager_forward = call_ms(lambda: sim(frames_dev[0]))
        graph_forward = device_ms(lambda g: sim(g), [(frames_dev[0],)], min_reps=5)
    rmse = rollout_rmse(preds, targets, frames_dev.node_mask[0]).item()
    profiled = 5
    breakdown = device_breakdown(lambda: rollout(sim, frames_dev[:profiled], device="cuda"), profiled)
    ms_per_frame = rollout_s / n_frames * 1e3
    result = {
        "frames": n_frames,
        "ms_per_frame": ms_per_frame,
        "rollout_s": rollout_s,
        "forward_eager_ms": eager_forward,
        "forward_cuda_graph_ms": graph_forward,
        "launches": launches,
        "rollout_rmse": rmse,
        "cpu_frames_checked": CPU_FRAMES,
        "cpu_max_abs_err": cpu_err,
        "cpu_rtol": ROLLOUT_RTOL,
        "cpu_atol": ROLLOUT_ATOL,
    }
    profile_line = {
        "frames_profiled": profiled,
        "breakdown": breakdown if breakdown is not None else "not measured",
        "device_idle_share": (
            None if breakdown is None else 1.0 - breakdown["device_ms_per_frame"] / ms_per_frame
        ),
    }
    return sim, result, profile_line


def batched_forward(name, sim, batch, counts, expected):
    """One eval forward on a concatenated batch, launch counts checked."""
    for fn in counts.values():
        fn.launches = 0
    with torch.inference_mode():
        _, _, out = sim(batch)  # normalizer statistics from the trajectory
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: expected.get(k, 0) for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    width = sim.config.output_index_end - sim.config.output_index_start
    if out.shape != (batch.num_nodes, width) or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad outputs {tuple(out.shape)}")
    with torch.inference_mode():
        forward_ms = call_ms(lambda: sim(batch), iters=10)
    return {
        "graphs": len(BATCH_NODES),
        "nodes": batch.num_nodes,
        "edges": batch.num_edges,
        "forward_ms": forward_ms,
        "launches": launches,
    }


def trajectory_frames(make_traj, frames, node_type_index, preprocessing, layout):
    """A synthetic trajectory on ``triangulated_grid(64, 32)`` (2,048 nodes,
    11,906 directed edges) as stacked frames, with the host's seconds."""
    from graphphysics_torch.core import round_up
    from graphphysics_torch.topology import face_to_edge
    from graphphysics_torch.training import stacked_trajectory

    traj, meta = make_traj(steps=frames + 1, nx=64, ny=32, phase0=0.0)
    n_real = traj["mesh_pos"].shape[1]
    e_real = len(face_to_edge(traj["cells"][0])[0])
    n_pad = round_up(n_real, 128)
    e_pad = round_up(int(e_real * 1.15), 128)
    t0 = time.perf_counter()
    stacked = stacked_trajectory(traj, meta, n_pad, e_pad, node_type_index=node_type_index,
                                 preprocessing=preprocessing, layout=layout)
    sizes = {"nodes": n_real, "edges": e_real, "n_pad": n_pad, "e_pad": e_pad,
             "host_frames_s": time.perf_counter() - t0}
    return stacked, sizes


def load_config(path, blocks=None):
    with open(path) as fp:
        param = json.load(fp)
    if blocks is not None:
        param["model"]["message_passing_num"] = blocks
    return param


def first_step(name, param, batch, seed, total_steps, grad_rtol):
    """The first ``Trainer`` step on the card against the same step on the
    CPU from equal weights (seeded ``init_state``): the loss, and each
    parameter's gradient within ``grad_rtol``, with the worst one named."""
    from graphphysics_torch.training import Trainer

    loss, grads = {}, {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device=dev)
        trainer.init_state(total_steps)
        loss[dev] = trainer.train_step(batch).item()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in trainer.sim.named_parameters()}
        del trainer
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    roundoff = [n for n in grads["cpu"] if n.endswith(ROUNDOFF_LEAVES)]
    rel = {n: ((grads["cuda"][n] - g).norm() / g.norm()).item()
           for n, g in grads["cpu"].items() if n not in roundoff}
    worst = max(rel, key=rel.get)
    share = 0.0
    for dev, gs in grads.items():
        top = max(g.abs().max().item() for n, g in gs.items() if n not in roundoff)
        share = max([share] + [gs[n].abs().max().item() / top for n in roundoff])
    result = {
        "first_step_cpu_loss": loss["cpu"],
        "first_step_card_loss": loss["cuda"],
        "first_step_loss_rel_err": loss_err,
        "first_step_grad_rel_err_worst": rel[worst],
        "first_step_grad_worst_param": worst,
        "first_step_grad_rel_err_median": float(np.median(list(rel.values()))),
        "first_step_params_compared": len(rel),
        "first_step_roundoff_params": len(roundoff),
        "first_step_roundoff_share": share,
        "first_step_tolerance": {"loss_rtol": STEP_LOSS_RTOL, "grad_rtol_per_param": grad_rtol,
                                 "roundoff_share": STEP_ROUNDOFF_SHARE},
    }
    if not (math.isfinite(loss["cuda"]) and loss_err <= STEP_LOSS_RTOL
            and rel[worst] <= grad_rtol and share <= STEP_ROUNDOFF_SHARE):
        raise AssertionError(f"{name}: first step card vs CPU out of tolerance: {result}")
    return result


def train(name, param, batch, counts, expected, seed, grad_rtol):
    """``Trainer`` on one concatenated batch on the card: the first step
    against the CPU (``first_step``), then on a fresh trainer 3 warm-up
    steps and 20 timed ones with every launch count zeroed just before them
    and checked just after against ``expected`` (kernel name -> launches per
    step), then a profile of 3 steps."""
    from graphphysics_torch.training import Trainer

    total_steps = 1 + WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS
    first = first_step(name, param, batch, seed, total_steps, grad_rtol)

    trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda")
    trainer.init_state(total_steps)
    dev_batch = batch.to("cuda")
    for _ in range(WARMUP_STEPS):
        trainer.train_step(dev_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [trainer.train_step(dev_batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: expected.get(k, 0) * TIMED_STEPS for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} in {TIMED_STEPS} steps, expected {want}")
    losses = [x.item() for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ms_per_step = seconds / TIMED_STEPS * 1e3
    breakdown = device_breakdown(
        lambda: [trainer.train_step(dev_batch) for _ in range(PROFILED_STEPS)], PROFILED_STEPS, unit="step"
    )
    real_edges = int(np.asarray(batch.edge_mask).sum())
    return {
        "graphs": len(BATCH_NODES),
        "nodes": batch.num_nodes,
        "edges": batch.num_edges,
        "real_edges": real_edges,
        "ms_per_step": ms_per_step,
        "padded_edges_per_s": batch.num_edges / (ms_per_step / 1e3),
        "real_edges_per_s": real_edges / (ms_per_step / 1e3),
        "steps_timed": TIMED_STEPS,
        "launches": launches,
        "launches_per_step": {k: v / TIMED_STEPS for k, v in launches.items()},
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "peak_memory_gb": peak_gb,
        **first,
        "profiled_steps": PROFILED_STEPS,
        "breakdown": breakdown if breakdown is not None else "not measured",
        "device_idle_share": (
            None if breakdown is None else 1.0 - breakdown["device_ms_per_step"] / ms_per_step
        ),
    }


def memory_datasets(param, make_traj, seed, directory, n_traj):
    """Training and validation ``BaseDataset``s over ``n_traj`` synthetic
    trajectories on ``triangulated_grid(64, 32)`` (2,048 nodes, 8 frames
    each) held in memory, with the config's training preprocessing (noise
    included) and its validation one; the meta file goes to ``directory``."""
    from graphphysics_torch.dataset import BaseDataset, frame_to_sample
    from graphphysics_torch.training import edge_layout, get_preprocessing

    edges = param["model"]["edge_input_size"] > 0
    trajs = [make_traj(steps=9, nx=64, ny=32, phase0=0.15 * k)[0] for k in range(n_traj)]
    meta = make_traj(steps=9, nx=2, ny=2)[1]

    class Trajectories(BaseDataset):
        """The in-memory trajectories as a dataset."""

        size_dataset = len(trajs)
        dt = meta["dt"]

        def _load(self, index):
            traj, frame = self.get_traj_frame(index)
            sample = frame_to_sample(trajs[traj], frame, self.meta, frame_target=frame + 1)
            sample.traj_index = traj
            return sample

    meta_path = f"{directory}/meta.json"
    with open(meta_path, "w") as fp:
        json.dump(meta, fp)
    common = dict(add_edge_features=edges, edge_layout=edge_layout(param),
                  node_type_index=param["index"]["node_type_index"], seed=seed)
    train_ds = Trajectories(meta_path, preprocessing=get_preprocessing(param, use_edge_feature=edges),
                            **common)
    val_ds = Trajectories(meta_path, preprocessing=get_preprocessing(
        param, use_edge_feature=edges, remove_noise=True), **common)
    return train_ds, val_ds


def pipeline(name, param, make_traj, counts, expected, seed):
    """Two synthetic trajectories (``memory_datasets``) through
    ``GraphLoader`` batches of 8 frames and ``Trainer.fit`` for 2 epochs
    with rollout validation on the card. ``expected`` gives (launches per
    step, launches per validated frame)."""
    import tempfile

    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = memory_datasets(param, make_traj, seed, tmp, n_traj=2)
        loader = GraphLoader(train_ds, batch_size=8, shuffle=True, seed=seed)
        trainer = Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                          checkpoint_dir=tmp, metrics_path=None, rollout_dir=None)
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        history = trainer.fit(loader, val_dataset=val_ds, num_epochs=2, val_trajectories=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    steps = 2 * len(loader)
    frames = 2 * train_ds.frames_per_trajectory
    want = {k: expected.get(k, (0, 0))[0] * steps + expected.get(k, (0, 0))[1] * frames
            for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    values = history["train_loss"] + history["val_rmse"]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{name}: non-finite history {history}")
    batch = loader.peek()
    return {
        "dataset_items": len(train_ds),
        "batch_nodes": batch.num_nodes,
        "batch_edges": batch.num_edges,
        "node_budget": train_ds.node_budget,
        "edge_budget": train_ds.edge_budget,
        "steps": steps,
        "validated_frames": frames,
        "train_loss": history["train_loss"],
        "val_rmse": history["val_rmse"],
        "launches": launches,
        "fit_s": seconds,
    }


class RecordingLoader:
    """A ``GraphLoader`` that records a digest of each batch it yields and,
    given a trainer, asks it to stop after batch ``stop_after``."""

    def __init__(self, loader, trainer=None, stop_after=None):
        self.loader, self.trainer, self.stop_after = loader, trainer, stop_after
        self.digests = []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_start_batch(self, batch):
        self.loader.set_start_batch(batch)

    def __iter__(self):
        for batch in self.loader:
            self.digests.append(hashlib.sha1(np.ascontiguousarray(batch.x).tobytes()).hexdigest())
            if self.trainer is not None and len(self.digests) == self.stop_after:
                self.trainer.request_interrupt()
            yield batch


def update_rel_errs(params, params_a, start):
    """Per parameter, ||P - A|| / ||A - start||: how far ``params`` are
    from run A's over how far A moved them. The round-off-only leaves
    (``ROUNDOFF_LEAVES``) are left out and their largest absolute
    difference returned apart. Returns (rel by name, that difference)."""
    rel, roundoff = {}, 0.0
    for name, a in params_a.items():
        p, a, s0 = params[name].double(), a.double(), start[name].double()
        if name.endswith(ROUNDOFF_LEAVES):
            roundoff = max(roundoff, (p - a).abs().max().item())
        else:
            rel[name] = ((p - a).norm() / (a - s0).norm()).item()
    return rel, roundoff


def resume_runs(name, param, train_ds, val_ds, counts, expected, seed, tmp, worst_rtol):
    """Steps 1-2 of ``checkpoint_roundtrip`` in ``tmp``: runs A, A' (A again,
    the card's round-off floor), B (interrupted after batch 2) and C (B
    resumed). Returns (readings, run C, its checkpoint's path)."""
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer, load_metadata

    def trainer(run):
        return Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                       checkpoint_dir=f"{tmp}/{run}", metrics_path=f"{tmp}/{run}.csv",
                       rollout_dir=None, save_every_n_steps=1)

    def loader():
        return GraphLoader(train_ds, batch_size=8, shuffle=True, seed=seed)

    fit = dict(val_dataset=val_ds, num_epochs=2, val_trajectories=1)
    for fn in counts.values():
        fn.launches = 0
    run_a = trainer("a")
    loader_a = RecordingLoader(loader())
    total_steps = 2 * len(loader_a)
    run_a.init_state(total_steps)
    start = {k: v.detach().clone() for k, v in run_a.sim.named_parameters()}
    t0 = time.perf_counter()
    history_a = run_a.fit(loader_a, **fit)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rerun = trainer("a2")
    rerun.fit(RecordingLoader(loader()), **fit)

    run_b = trainer("b")
    loader_b = RecordingLoader(loader(), trainer=run_b, stop_after=2)
    if not run_b.fit(loader_b, **fit)["interrupted"]:
        raise AssertionError(f"{name}: run B was not interrupted")
    ckpt = f"{tmp}/b/state.pt"
    meta = load_metadata(ckpt)
    if (meta["epoch"], meta["batch_offset"], meta["step"]) != (0, 2, 2):
        raise AssertionError(f"{name}: interrupted checkpoint metadata {meta}")
    run_c = trainer("b")
    loader_c = RecordingLoader(loader())
    history_c = run_c.fit(loader_c, resume_from=ckpt, **fit)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counts.items()}
    steps = 2 * run_a.step + run_b.step + run_c.step - 2  # A, A', B, C
    frames = 6 * val_ds.frames_per_trajectory  # validations: A 2, A' 2, B 0, C 2
    want = {k: expected.get(k, (0, 0))[0] * steps + expected.get(k, (0, 0))[1] * frames
            for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")

    lr_a, lr_c = (t.optimizer.param_groups[0]["lr"] for t in (run_a, run_c))
    exact = {
        "step": run_c.step == run_a.step == total_steps,
        "scheduler_position": run_c.scheduler.last_epoch == run_a.scheduler.last_epoch,
        "lr": lr_c == lr_a,
        "batch_stream": (loader_b.digests + loader_c.digests == loader_a.digests
                         and len(loader_a.digests) == total_steps),
    }
    if not all(exact.values()):
        raise AssertionError(f"{name}: the resumed run differs from run A: {exact}, "
                             f"steps {run_c.step} / {run_a.step}, lr {lr_c} / {lr_a}")
    params_a = {k: v.detach() for k, v in run_a.sim.named_parameters()}
    rel, roundoff = update_rel_errs(
        {k: v.detach() for k, v in run_c.sim.named_parameters()}, params_a, start)
    rel_rerun, roundoff_rerun = update_rel_errs(
        {k: v.detach() for k, v in rerun.sim.named_parameters()}, params_a, start)
    roundoff_atol = 2 * ADAM_STEP_MAX * sum(run_a.schedule(i) for i in range(total_steps))
    worst = max(rel, key=rel.get)
    median = float(np.median(list(rel.values())))
    if not (median <= RESUME_MEDIAN_RTOL and rel[worst] <= worst_rtol and roundoff <= roundoff_atol):
        raise AssertionError(
            f"{name}: resumed parameters off by {median} relative (median), {rel[worst]} ({worst}),"
            f" round-off leaves by {roundoff} (limits {RESUME_MEDIAN_RTOL}, {worst_rtol}, "
            f"{roundoff_atol})")
    history = history_a["train_loss"] + history_a["val_rmse"] + history_c["val_rmse"]
    if not all(math.isfinite(v) for v in history):
        raise AssertionError(f"{name}: non-finite history {history_a} {history_c}")
    readings = {
        "dataset_items": len(train_ds),
        "steps_per_run": {"a": run_a.step, "b": run_b.step, "c": run_c.step},
        "resume_exact": exact,
        "final_step": run_c.step,
        "final_lr": lr_c,
        "resume_param_rel_err_worst": rel[worst],
        "resume_worst_param": worst,
        "resume_param_rel_err_median": median,
        "resume_roundoff_leaf_max_abs_diff": roundoff,
        "rerun_param_rel_err_worst": max(rel_rerun.values()),
        "rerun_worst_param": max(rel_rerun, key=rel_rerun.get),
        "rerun_param_rel_err_median": float(np.median(list(rel_rerun.values()))),
        "rerun_roundoff_leaf_max_abs_diff": roundoff_rerun,
        "resume_tolerance": {"median_rtol": RESUME_MEDIAN_RTOL, "worst_rtol": worst_rtol,
                             "roundoff_leaf_atol": roundoff_atol},
        "launches": launches,
        "train_loss": history_a["train_loss"],
        "val_rmse": history_a["val_rmse"],
        "fit_s": fit_s,
    }
    return readings, run_c, ckpt


def checkpoint_roundtrip(name, param, make_traj, counts, expected, frame_kernel, seed, worst_rtol):
    """Checkpoints, resume and ``predict`` on the card, on in-memory
    trajectories (``memory_datasets``, ``CKPT_TRAJECTORIES`` of them,
    batches of 8 frames):

    1. run A: ``Trainer.fit`` for 2 epochs with rollout validation, saving
       every step, and run A' the same again;
    2. run B: the same, ``request_interrupt()`` after batch 2, then run C:
       ``fit(resume_from=)`` B's checkpoint. C's step counter, learning rate
       and batch stream equal A's exactly; its parameters' distances from
       A's, relative to how far A moved them, within ``RESUME_MEDIAN_RTOL``
       (median) and ``worst_rtol`` (worst; A' against A is reported beside
       them); ``expected`` gives (launches per
       step, launches per validated frame) over A, A', B and C together;
    3. the final checkpoint loaded into a fresh ``Trainer`` on the card:
       parameters and normalizer statistics equal the file's and C's;
    4. ``predict(save_dir=None)`` from it on the card: ``BLOCKS`` launches of
       ``frame_kernel`` per frame, equal to C's own predictions, and within
       ``ROLLOUT_ATOL``/``ROLLOUT_RTOL`` of ``predict`` on the CPU from the
       same file over ``CPU_FRAMES``;
    5. the checkpoint's bytes, save and load seconds, predict's ms per
       frame."""
    import tempfile

    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.training import Trainer, load_checkpoint

    blocks = param["model"]["message_passing_num"]
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = memory_datasets(param, make_traj, seed, tmp, n_traj=CKPT_TRAJECTORIES)
        readings, run_c, final = resume_runs(name, param, train_ds, val_ds, counts, expected, seed,
                                             tmp, worst_rtol)

        # 3. save, then load into a fresh trainer on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_c.save(1)
        save_s = time.perf_counter() - t0
        fresh = Trainer(param, seed=seed + 1, device="cuda", metrics_path=None, rollout_dir=None)
        fresh.init_state(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(final, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.load(final, map_location="cpu", weights_only=True)
        file_load_s = time.perf_counter() - t0
        saved = torch.load(final, map_location="cpu", weights_only=True)["model"]
        live = run_c.sim.state_dict()
        loaded = fresh.sim.state_dict()
        if saved.keys() != loaded.keys():
            raise AssertionError(f"{name}: checkpoint keys differ from the model's")
        for key, value in loaded.items():
            if not (torch.equal(value.cpu(), saved[key]) and torch.equal(value, live[key])):
                raise AssertionError(f"{name}: reloaded {key} differs from the saved one")
        buffers = sum(1 for k in loaded if "_normalizer." in k)

        # 4. predict on the card from the loaded checkpoint
        n_frames = val_ds.frames_per_trajectory
        t0 = time.perf_counter()
        stack_graphs([val_ds[i] for i in val_ds.trajectory_indices(0)])
        host_s = time.perf_counter() - t0
        fresh.predict(val_ds, save_dir=None, max_trajectories=1)  # warm-up
        torch.cuda.synchronize()
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        preds = fresh.predict(val_ds, save_dir=None, max_trajectories=1)[0]
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        predict_launches = {k: fn.launches for k, fn in counts.items()}
        want = {k: (blocks * n_frames if k == frame_kernel else 0) for k in counts}
        if predict_launches != want:
            raise AssertionError(f"{name}: predict launches {predict_launches}, expected {want}")
        width = param["index"]["output_index_end"] - param["index"]["output_index_start"]
        if preds.shape != (n_frames, val_ds.node_budget, width) or not np.isfinite(preds).all():
            raise AssertionError(f"{name}: bad predictions {preds.shape}")
        in_memory = run_c.predict(val_ds, save_dir=None, max_trajectories=1)[0]
        memory_diff = float(np.abs(preds - in_memory).max())
        if memory_diff != 0.0:
            raise AssertionError(f"{name}: loaded model predicts {memory_diff} off the trained one")
        cpu = Trainer(param, seed=seed + 1, device="cpu", metrics_path=None, rollout_dir=None)
        cpu.init_state(1)
        load_checkpoint(final, cpu.sim)
        preds_cpu = cpu.predict(val_ds, save_dir=None, max_trajectories=1)[0][:CPU_FRAMES]
        cpu_err = float(np.abs(preds[:CPU_FRAMES] - preds_cpu).max())
        if not np.allclose(preds[:CPU_FRAMES], preds_cpu, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL):
            raise AssertionError(f"{name}: card vs CPU predict max_abs_err {cpu_err}")
        size = os.path.getsize(final)
    return {
        **readings,
        "checkpoint_bytes": size,
        "save_s": save_s,
        "load_s": load_s,
        "load_file_s": file_load_s,
        "reload_bitwise": True,
        "reloaded_tensors": len(loaded),
        "reloaded_normalizer_buffers": buffers,
        "predict_frames": n_frames,
        "predict_launches": predict_launches,
        "predict_ms_per_frame": predict_s / n_frames * 1e3,
        "host_frames_ms_per_frame": host_s / n_frames * 1e3,
        "predict_vs_in_memory_max_abs_diff": memory_diff,
        "cpu_frames_checked": CPU_FRAMES,
        "cpu_max_abs_err": cpu_err,
        "cpu_rtol": ROLLOUT_RTOL,
        "cpu_atol": ROLLOUT_ATOL,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=50)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 2

    from graphphysics_torch.dataset import build_preprocessing
    from graphphysics_torch.ops import _native
    from graphphysics_torch.ops.csr_attention import (
        csr_attention,
        csr_attention_backward,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
    )
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_backward
    from graphphysics_torch.training import get_preprocessing
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    counts = {
        "csr_segment_sum": csr_segment_sum,
        "csr_segment_sum_backward": csr_segment_sum_backward,
        "csr_softmax_spmm": csr_softmax_spmm,
        "csr_softmax_spmm_backward": csr_softmax_spmm_backward,
        "csr_attention": csr_attention,
        "csr_attention_backward": csr_attention_backward,
    }

    # 1. environment and build ---------------------------------------------------
    t0 = time.perf_counter()
    build_s = _native.build()
    emit({
        "phase": "build",
        "nvidia_smi": smi,
        "device_name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_s": build_s,
        "build_wall_s": time.perf_counter() - t0,
        "libraries": [_native.library_path(s).name for s in _native.SOURCES],
        "tf32": False,
    })

    # host side of the two serving paths: trajectories of 2,048 nodes
    epd_frames, epd_sizes = trajectory_frames(
        cylinder_trajectory, args.frames, 2, build_preprocessing(), "sorted"
    )
    panels = load_config(PANELS_CONFIG)
    cylinder = load_config(CYLINDER_CONFIG)
    tf_frames, tf_sizes = trajectory_frames(
        panels_trajectory, args.frames, panels["index"]["node_type_index"],
        get_preprocessing(panels, use_edge_feature=False, remove_noise=True), "csr",
    )
    cyl_batch = flagship_batch(args.seed)
    tf_batch = panels_batch(args.seed + 200)
    aneurysm_epd = random_graph(66000, 520000, 66560, 524288, args.seed + 100)
    aneurysm_csr = random_csr_graph(66000, 520000, 66560, 524288, args.seed + 300)

    # 2, 7. kernels, forward and backward -------------------------------------------
    k1_shapes = [
        k1_case("serving_frame", epd_frames[0], args.seed),
        k1_case("flagship_batch_8x2048", cyl_batch, args.seed + 1),
        k1_case("aneurysm_epd_66560x524288", aneurysm_epd, args.seed + 2),
    ]
    for s in k1_shapes:
        emit({"phase": "kernel", "name": "csr_segment_sum", **s})
    for fn in counts.values():
        fn.launches = 0
    k2_shapes = [
        k2_case("transformer_serving_frame", tf_frames[0], HIDDEN, args.seed + 3),
        k2_case("panels_csr_batch_8x2048", tf_batch, HIDDEN, args.seed + 4),
        k2_case("aneurysm_csr_66560x524288", aneurysm_csr, 64, args.seed + 5),
    ]
    for s in k2_shapes:
        emit({"phase": "kernel", "name": "csr_softmax_spmm", **s})
    k1b_shapes = [
        k1b_case("serving_frame", epd_frames[0], args.seed + 6),
        k1b_case("flagship_batch_8x2048", cyl_batch, args.seed + 7),
        k1b_case("aneurysm_epd_66560x524288", aneurysm_epd, args.seed + 8),
    ]
    for s in k1b_shapes:
        emit({"phase": "kernel", "name": "csr_segment_sum_backward", **s})
    k3_shapes = [
        k3_case("transformer_serving_frame", tf_frames[0], HIDDEN, args.seed + 9),
        k3_case("panels_csr_batch_8x2048", tf_batch, HIDDEN, args.seed + 10),
        k3_case("aneurysm_csr_66560x524288", aneurysm_csr, 64, args.seed + 11),
    ]
    for s in k3_shapes:
        emit({"phase": "kernel", "name": "csr_softmax_spmm_backward", **s})
    # K2 and K3 run on no transformer path now: their launches are their
    # kernel phases' (the checks, and each captured call of a timing)
    phase_launches = {k: counts[k].launches for k in ("csr_softmax_spmm", "csr_softmax_spmm_backward")}
    fused = [
        fused_case("transformer_serving_frame", tf_frames[0], HIDDEN, args.seed + 12),
        fused_case("panels_csr_batch_8x2048", tf_batch, HIDDEN, args.seed + 13),
        fused_case("aneurysm_csr_66560x524288", aneurysm_csr, 64, args.seed + 14, library=False),
    ]
    fused_shapes, fused_bwd_shapes = [f for f, _ in fused], [b for _, b in fused]
    for s in fused_shapes:
        emit({"phase": "kernel", "name": "csr_attention", **s})
    for s in fused_bwd_shapes:
        emit({"phase": "kernel", "name": "csr_attention_backward", **s})
    del aneurysm_epd, aneurysm_csr

    # 3-4. EPD: serving rollout and batched forward --------------------------------
    epd, result, profile_line = serve(
        "epd_serving", build_epd, epd_frames, counts, {"csr_segment_sum": BLOCKS}, args.seed
    )
    emit({"phase": "serving", "model": f"EncodeProcessDecode {BLOCKS}x{HIDDEN}, cylinder",
          **epd_sizes, **result})
    emit({"phase": "serving_profile", "model": "EncodeProcessDecode", **profile_line})
    emit({"phase": "batched", "model": "EncodeProcessDecode", **batched_forward(
        "epd_batched", epd, cyl_batch.to("cuda"), counts, {"csr_segment_sum": BLOCKS})})
    del epd

    # 5-6. transformer: serving rollout and batched forward ------------------------
    blocks = panels["model"]["message_passing_num"]
    tf_model = (f"EncodeTransformDecode {blocks}x{panels['model']['hidden_size']}, "
                f"{panels['model']['num_heads']} heads, {PANELS_CONFIG}")
    tf, result, profile_line = serve(
        "transformer_serving", lambda seed, dev: build_transformer(panels, seed, dev),
        tf_frames, counts, {"csr_attention": blocks}, args.seed,
    )
    emit({"phase": "transformer_serving", "model": tf_model, **tf_sizes, **result})
    emit({"phase": "transformer_serving_profile", "model": "EncodeTransformDecode", **profile_line})
    emit({"phase": "transformer_batched", "model": "EncodeTransformDecode", **batched_forward(
        "transformer_batched", tf, tf_batch.to("cuda"), counts, {"csr_attention": blocks})})
    del tf

    # 8. training: the main path of this slice ---------------------------------------
    epd_blocks = cylinder["model"]["message_passing_num"]
    epd_train = train("epd_training", cylinder, cyl_batch, counts,
                      {"csr_segment_sum": epd_blocks, "csr_segment_sum_backward": epd_blocks},
                      args.seed, EPD_GRAD_RTOL)
    emit({"phase": "epd_training",
          "model": f"EncodeProcessDecode {epd_blocks}x{cylinder['model']['hidden_size']}, "
                   f"{CYLINDER_CONFIG}", **epd_train})
    tf_train = train("transformer_training", panels, tf_batch, counts,
                     {"csr_attention": blocks, "csr_attention_backward": blocks}, args.seed,
                     TRANSFORMER_GRAD_RTOL)
    emit({"phase": "transformer_training", "model": tf_model, **tf_train})

    # 9. training pipeline: dataset, loader, fit with validation --------------------
    emit({"phase": "epd_pipeline", **pipeline(
        "epd_pipeline", cylinder, cylinder_trajectory, counts,
        {"csr_segment_sum": (epd_blocks, epd_blocks), "csr_segment_sum_backward": (epd_blocks, 0)},
        args.seed)})
    emit({"phase": "transformer_pipeline", **pipeline(
        "transformer_pipeline", panels, panels_trajectory, counts,
        {"csr_attention": (blocks, blocks), "csr_attention_backward": (blocks, 0)},
        args.seed)})

    # 10. checkpoints, resume and predict on the card ------------------------------
    emit({"phase": "epd_checkpoint", **checkpoint_roundtrip(
        "epd_checkpoint", cylinder, cylinder_trajectory, counts,
        {"csr_segment_sum": (epd_blocks, epd_blocks), "csr_segment_sum_backward": (epd_blocks, 0)},
        "csr_segment_sum", args.seed, EPD_RESUME_WORST_RTOL)})
    emit({"phase": "transformer_checkpoint", **checkpoint_roundtrip(
        "transformer_checkpoint", panels, panels_trajectory, counts,
        {"csr_attention": (blocks, blocks), "csr_attention_backward": (blocks, 0)},
        "csr_attention", args.seed, TRANSFORMER_RESUME_WORST_RTOL)})

    def entry(name, source, replaces, launches, shapes, tolerance, **extra):
        main = shapes[1]  # the 8 x 2,048 batch: the training path's shape
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": main["max_abs_err"],
            "tolerance": tolerance,
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            **extra,
            "shapes": shapes,
        }

    launched = {k: v for r in (epd_train, tf_train) for k, v in r["launches"].items() if v}
    off_path = {"main_path_launches": 0,
                "launches_from": "its kernel phases: no transformer path runs it (the fused kernels do)"}
    kernels = {"kernels": [
        entry("csr_segment_sum", "graphphysics_torch/csrc/csr_segment_sum.cu",
              "graphphysics_tpu/ops/pallas_segment.py:148", launched["csr_segment_sum"], k1_shapes,
              KERNEL_ATOL),
        entry("csr_segment_sum_backward", "graphphysics_torch/csrc/csr_segment_sum.cu",
              "graphphysics_tpu/ops/pallas_segment.py:228", launched["csr_segment_sum_backward"],
              k1b_shapes, GATHER_ATOL),
        entry("csr_softmax_spmm", "graphphysics_torch/csrc/csr_softmax_spmm.cu",
              "graphphysics_tpu/ops/pallas_attention.py:255", phase_launches["csr_softmax_spmm"],
              k2_shapes, {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}, **off_path),
        entry("csr_softmax_spmm_backward", "graphphysics_torch/csrc/csr_softmax_spmm_bwd.cu",
              "graphphysics_tpu/ops/pallas_attention.py:398", phase_launches["csr_softmax_spmm_backward"],
              k3_shapes, {"rtol": K3_RTOL, "atol": K3_ATOL}, **off_path),
        entry("csr_attention", "graphphysics_torch/csrc/csr_attention.cu",
              "graphphysics_tpu/ops/pallas_attention.py:255", launched["csr_attention"], fused_shapes,
              {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}, replaced_ms=fused_shapes[1]["replaced_ms"],
              also_replaces="graphphysics_tpu/ops/pallas_attention.py:556 (csr_sparse_attention's "
                            "gathers and SDDMM)"),
        entry("csr_attention_backward", "graphphysics_torch/csrc/csr_attention_bwd.cu",
              "graphphysics_tpu/ops/pallas_attention.py:398", launched["csr_attention_backward"],
              fused_bwd_shapes, {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL},
              replaced_ms=fused_bwd_shapes[1]["replaced_ms"],
              also_replaces="the backward of csr_sparse_attention's gathers and SDDMM "
                            "(graphphysics_tpu/ops/pallas_attention.py:556)"),
    ]}
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
