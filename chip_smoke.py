#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--frames 50]

Run from the root of the repository on a machine with an NVIDIA Hopper card
and the CUDA toolkit. Phases, each of which raises on failure:

1. environment and build: the card (``nvidia-smi``), torch and CUDA
   versions, and ``nvcc`` building the kernel of ``graphphysics_torch/csrc``;
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card at the shapes the serving path gives it, at the flagship training
   batch (8 graphs of 2,048 nodes / 12,288 edges) and at the aneurysm_epd
   scale (66,560 nodes / 524,288 edges), with device times, the memory
   bound and one PyTorch call as a yardstick;
3. serving: a synthetic cylinder trajectory rolled out by the 15 x 128
   EncodeProcessDecode simulator (random weights from the seed) on the card,
   checked against the same rollout on the CPU, with the kernel launch count;
4. batched forward: one eval forward on the flagship batch.

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
L2_BYTES = 50 * 2**20
HIDDEN = 128
BLOCKS = 15
# f32 sums of ~10 N(0,1) terms per row in another order than index_add_
KERNEL_ATOL = 1e-4
# GPU vs CPU rollout, f32 without TF32, first frames
ROLLOUT_ATOL = 1e-4
ROLLOUT_RTOL = 1e-4
CPU_FRAMES = 3

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


def _category(kernel: str) -> str:
    k = kernel.lower()
    if "csr_segment_sum" in k:
        return "csr_segment_sum"
    if "gemm" in k or "cutlass" in k or "sm90_" in k:
        return "gemm"
    if "indexselect" in k or "index_select" in k:
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


def flagship_batch(seed):
    """8 graphs padded to 2,048 nodes / 12,288 edges, concatenated. Graph 0
    has n_pad == n with padded edges on its real last node; graph 4 has no
    padding at all; the others pad both."""
    from graphphysics_torch.core import concat_graphs

    nodes = [2048, 2000, 1950, 1900, 2048, 1800, 1700, 1600]
    edges = [11906, 12000, 11500, 11000, 12288, 10500, 10000, 9500]
    return concat_graphs(
        [random_graph(n, e, 2048, 12288, seed + i) for i, (n, e) in enumerate(zip(nodes, edges))]
    )


def kernel_case(name, graph, seed):
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
        copies = max(1, math.ceil(2 * L2_BYTES / bytes_moved))
        datas = [data] + [data.clone() for _ in range(copies - 1)]
        libs = [lib_data] + [lib_data.clone() for _ in range(copies - 1)]
        kernel_t = device_ms(lambda d: csr_segment_sum(d, recv, bounds, mask), [(d,) for d in datas])
        plain_t = device_ms(lambda d: csr_segment_sum_reference(d, recv, n, mask), [(d,) for d in datas])
        library_t = device_ms(lambda d: library(d, recv), [(d,) for d in libs])
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_bound = real_edges * HIDDEN / 67e12 * 1e3  # f32 adds at the non-tensor-core peak
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


def build_simulator(seed, device):
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=50)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 2

    from graphphysics_torch.core import round_up
    from graphphysics_torch.dataset import build_preprocessing
    from graphphysics_torch.ops import _native
    from graphphysics_torch.ops.csr_segment import SOURCE as CSR_SOURCE
    from graphphysics_torch.ops.csr_segment import csr_segment_sum
    from graphphysics_torch.topology import face_to_edge
    from graphphysics_torch.training import rollout, rollout_rmse, stacked_trajectory
    from graphphysics_torch.utils.synthetic import cylinder_trajectory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()

    # 1. environment and build -------------------------------------------------
    t0 = time.perf_counter()
    _native.load(CSR_SOURCE)
    build_s = time.perf_counter() - t0
    emit({
        "phase": "build",
        "nvidia_smi": smi,
        "device_name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_s": build_s,
        "library": str(_native.library_path(CSR_SOURCE).name),
        "tf32": False,
    })

    # host side of the serving path: a cylinder trajectory of ~2k nodes
    traj, meta = cylinder_trajectory(steps=args.frames + 1, nx=64, ny=32, phase0=0.0)
    n_real = traj["mesh_pos"].shape[1]
    e_real = len(face_to_edge(traj["cells"][0])[0])
    n_pad = round_up(n_real, 128)
    e_pad = round_up(int(e_real * 1.15), 128)
    t0 = time.perf_counter()
    frames = stacked_trajectory(traj, meta, n_pad, e_pad, node_type_index=2,
                                preprocessing=build_preprocessing())
    host_s = time.perf_counter() - t0

    # 2. kernels ---------------------------------------------------------------
    first = frames[0]
    shapes = [
        kernel_case("serving_frame", first, args.seed),
        kernel_case("flagship_batch_8x2048", flagship_batch(args.seed), args.seed + 1),
        kernel_case(
            "aneurysm_epd_66560x524288",
            random_graph(66000, 520000, 66560, 524288, args.seed + 100),
            args.seed + 2,
        ),
    ]
    for s in shapes:
        emit({"phase": "kernel", "name": "csr_segment_sum", **s})

    # 3. serving: rollout of the 15 x 128 EPD on the card ---------------------
    sim = build_simulator(args.seed, "cuda")
    frames_dev = frames.to("cuda")
    n_frames = frames_dev.x.shape[0]
    for t in range(n_frames):
        sim.accumulate_stats(frames_dev[t])
    rollout(sim, frames_dev[:2], device="cuda")  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    csr_segment_sum.launches = 0
    t0 = time.perf_counter()
    preds, targets = rollout(sim, frames_dev, device="cuda")
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    serving_launches = csr_segment_sum.launches
    if serving_launches != BLOCKS * n_frames:
        raise AssertionError(
            f"serving: csr_segment_sum launched {serving_launches} times, "
            f"expected {BLOCKS} x {n_frames}"
        )
    if preds.shape != (n_frames, n_pad, 2) or not torch.isfinite(preds).all():
        raise AssertionError(f"serving: bad predictions {tuple(preds.shape)}")

    sim_cpu = build_simulator(args.seed, "cpu")
    sim_cpu.load_state_dict({k: v.cpu() for k, v in sim.state_dict().items()})
    preds_cpu, _ = rollout(sim_cpu, frames[:CPU_FRAMES], device="cpu")
    cpu_err = (preds[:CPU_FRAMES].cpu() - preds_cpu).abs().max().item()
    if not torch.allclose(preds[:CPU_FRAMES].cpu(), preds_cpu, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL):
        raise AssertionError(f"serving: GPU vs CPU rollout max_abs_err {cpu_err}")

    with torch.inference_mode():
        eager_forward = call_ms(lambda: sim(frames_dev[0]))
        graph_forward = device_ms(lambda g: sim(g), [(frames_dev[0],)], min_reps=5)
    rmse = rollout_rmse(preds, targets, frames_dev.node_mask[0]).item()
    profiled = 5
    breakdown = device_breakdown(lambda: rollout(sim, frames_dev[:profiled], device="cuda"), profiled)
    ms_per_frame = rollout_s / n_frames * 1e3
    emit({
        "phase": "serving",
        "model": f"EncodeProcessDecode {BLOCKS}x{HIDDEN}, cylinder",
        "frames": n_frames,
        "nodes": n_real,
        "edges": e_real,
        "n_pad": n_pad,
        "e_pad": e_pad,
        "ms_per_frame": ms_per_frame,
        "rollout_s": rollout_s,
        "forward_eager_ms": eager_forward,
        "forward_cuda_graph_ms": graph_forward,
        "host_frames_s": host_s,
        "csr_segment_sum_launches": serving_launches,
        "rollout_rmse": rmse,
        "cpu_frames_checked": CPU_FRAMES,
        "cpu_max_abs_err": cpu_err,
        "cpu_rtol": ROLLOUT_RTOL,
        "cpu_atol": ROLLOUT_ATOL,
    })
    emit({
        "phase": "serving_profile",
        "frames_profiled": profiled,
        "breakdown": breakdown if breakdown is not None else "not measured",
        "device_idle_share": (
            None if breakdown is None
            else 1.0 - breakdown["device_ms_per_frame"] / ms_per_frame
        ),
    })

    # 4. batched eval forward on the flagship batch -----------------------------
    batch = flagship_batch(args.seed).to("cuda")
    csr_segment_sum.launches = 0
    with torch.inference_mode():
        _, _, out = sim(batch)  # normalizer statistics from the trajectory
    torch.cuda.synchronize()
    batch_launches = csr_segment_sum.launches
    if batch_launches != BLOCKS:
        raise AssertionError(f"batched: csr_segment_sum launched {batch_launches} times")
    if out.shape != (batch.num_nodes, 2) or not torch.isfinite(out).all():
        raise AssertionError(f"batched: bad outputs {tuple(out.shape)}")
    with torch.inference_mode():
        batch_ms = call_ms(lambda: sim(batch), iters=10)
    emit({
        "phase": "batched",
        "graphs": 8,
        "nodes": batch.num_nodes,
        "edges": batch.num_edges,
        "forward_ms": batch_ms,
        "csr_segment_sum_launches": batch_launches,
    })

    serving = shapes[0]
    kernels = {
        "kernels": [
            {
                "name": "csr_segment_sum",
                "route": "cuda",
                "source": "graphphysics_torch/csrc/csr_segment_sum.cu",
                "replaces": "graphphysics_tpu/ops/pallas_segment.py:148",
                "launches": serving_launches,
                "max_abs_err": serving["max_abs_err"],
                "tolerance": KERNEL_ATOL,
                "ms": serving["ms"],
                "plain_ms": serving["plain_ms"],
                "bound_ms": serving["bound_ms"],
                "bound_by": serving["bound_by"],
                "library_ms": serving["library_ms"],
                "shapes": shapes,
            }
        ]
    }
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
