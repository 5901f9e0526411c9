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
   width 64);
3. EPD serving: a synthetic cylinder trajectory rolled out by the 15 x 128
   EncodeProcessDecode simulator (random weights from the seed) on the card,
   checked against the same rollout on the CPU, with the launch counts;
4. EPD batched forward: one eval forward on the cylinder batch;
5. transformer serving: a synthetic panels trajectory rolled out by the
   15 x 128, 4-head EncodeTransformDecode simulator built from
   ``training_config/panels.json`` (random weights from the seed), checked
   the same way;
6. transformer batched forward: one eval forward on the panels_csr batch.

Every line but the last is a JSON object (one per phase), apart from the
card's ``nvidia-smi`` line; the ``{"kernels": [...]}`` line comes just before
the last line, ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, without a CUDA card or outside the repository. float32 matmuls run
without TF32 (``allow_tf32 = False`` for matmul and cuDNN): the CPU
comparison is float32.
"""

from __future__ import annotations

import argparse
import json
import math
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
# K2: online vs two-pass softmax in f32, a few ulps per edge of a row
SOFTMAX_ATOL = 1e-5
SOFTMAX_RTOL = 1e-5
# GPU vs CPU rollout, f32 without TF32, first frames
ROLLOUT_ATOL = 1e-4
ROLLOUT_RTOL = 1e-4
CPU_FRAMES = 3
PANELS_CONFIG = "training_config/panels.json"
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
    if "csr_segment_sum" in k:
        return "csr_segment_sum"
    if "softmax_spmm" in k:
        return "softmax_spmm"
    if "gemm" in k or "cutlass" in k or "sm90_" in k:
        return "gemm"
    if "indexselect" in k or "index_select" in k or "gather" in k:
        return "gather"
    if "cat" in k:
        return "cat"
    if "reduce" in k:
        return "reduce"
    return "elementwise_other"


def device_breakdown(fn, frames: int):
    """Device time of ``fn`` (a rollout of ``frames`` frames) by kernel, from
    torch.profiler's CUDA activity; None where the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [r for r in prof.key_averages() if r.device_type == DeviceType.CUDA]
    if not rows:
        return None

    def us(r):
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0.0)

    total_us = sum(us(r) for r in rows)
    groups = {}
    for r in rows:
        g = groups.setdefault(_category(r.key), {"ms_per_frame": 0.0, "kernels_per_frame": 0.0})
        g["ms_per_frame"] += us(r) / 1e3 / frames
        g["kernels_per_frame"] += r.count / frames
    top = sorted(rows, key=us, reverse=True)[:8]
    return {
        "device_ms_per_frame": total_us / 1e3 / frames,
        "kernels_per_frame": sum(r.count for r in rows) / frames,
        "by_category": groups,
        "top_kernels": [
            {"name": r.key[:90], "ms_per_frame": us(r) / 1e3 / frames, "count_per_frame": r.count / frames}
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
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm
    from graphphysics_torch.ops.csr_segment import csr_segment_sum
    from graphphysics_torch.training import get_preprocessing
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    counts = {"csr_segment_sum": csr_segment_sum, "csr_softmax_spmm": csr_softmax_spmm}

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
    with open(PANELS_CONFIG) as fp:
        panels = json.load(fp)
    tf_frames, tf_sizes = trajectory_frames(
        panels_trajectory, args.frames, panels["index"]["node_type_index"],
        get_preprocessing(panels, use_edge_feature=False, remove_noise=True), "csr",
    )

    # 2. kernels -------------------------------------------------------------------
    k1_shapes = [
        k1_case("serving_frame", epd_frames[0], args.seed),
        k1_case("flagship_batch_8x2048", flagship_batch(args.seed), args.seed + 1),
        k1_case("aneurysm_epd_66560x524288",
                random_graph(66000, 520000, 66560, 524288, args.seed + 100), args.seed + 2),
    ]
    for s in k1_shapes:
        emit({"phase": "kernel", "name": "csr_segment_sum", **s})
    k2_shapes = [
        k2_case("transformer_serving_frame", tf_frames[0], HIDDEN, args.seed + 3),
        k2_case("panels_csr_batch_8x2048", panels_batch(args.seed + 200), HIDDEN, args.seed + 4),
        k2_case("aneurysm_csr_66560x524288",
                random_csr_graph(66000, 520000, 66560, 524288, args.seed + 300), 64, args.seed + 5),
    ]
    for s in k2_shapes:
        emit({"phase": "kernel", "name": "csr_softmax_spmm", **s})

    # 3-4. EPD: serving rollout and batched forward --------------------------------
    epd, result, profile_line = serve(
        "epd_serving", build_epd, epd_frames, counts, {"csr_segment_sum": BLOCKS}, args.seed
    )
    epd_launches = result["launches"]["csr_segment_sum"]
    emit({"phase": "serving", "model": f"EncodeProcessDecode {BLOCKS}x{HIDDEN}, cylinder",
          **epd_sizes, **result})
    emit({"phase": "serving_profile", "model": "EncodeProcessDecode", **profile_line})
    emit({"phase": "batched", "model": "EncodeProcessDecode", **batched_forward(
        "epd_batched", epd, flagship_batch(args.seed).to("cuda"), counts,
        {"csr_segment_sum": BLOCKS})})
    del epd

    # 5-6. transformer: serving rollout and batched forward ------------------------
    blocks = panels["model"]["message_passing_num"]
    tf, result, profile_line = serve(
        "transformer_serving", lambda seed, dev: build_transformer(panels, seed, dev),
        tf_frames, counts, {"csr_softmax_spmm": blocks}, args.seed,
    )
    tf_launches = result["launches"]["csr_softmax_spmm"]
    emit({"phase": "transformer_serving",
          "model": f"EncodeTransformDecode {blocks}x{panels['model']['hidden_size']}, "
                   f"{panels['model']['num_heads']} heads, {PANELS_CONFIG}",
          **tf_sizes, **result})
    emit({"phase": "transformer_serving_profile", "model": "EncodeTransformDecode", **profile_line})
    emit({"phase": "transformer_batched", "model": "EncodeTransformDecode", **batched_forward(
        "transformer_batched", tf, panels_batch(args.seed + 200).to("cuda"), counts,
        {"csr_softmax_spmm": blocks})})

    def entry(name, source, replaces, launches, shapes, tolerance):
        first = shapes[0]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": first["max_abs_err"],
            "tolerance": tolerance,
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "shapes": shapes,
        }

    kernels = {"kernels": [
        entry("csr_segment_sum", "graphphysics_torch/csrc/csr_segment_sum.cu",
              "graphphysics_tpu/ops/pallas_segment.py:148", epd_launches, k1_shapes,
              KERNEL_ATOL),
        entry("csr_softmax_spmm", "graphphysics_torch/csrc/csr_softmax_spmm.cu",
              "graphphysics_tpu/ops/pallas_attention.py:255", tf_launches, k2_shapes,
              {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}),
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
