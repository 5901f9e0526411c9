#!/usr/bin/env python3
"""Time the fused attention kernels and the main path of one checkout of
this repository, to compare two commits on one card in one call:

    python3 chip_compare.py <checkout root> [label]

Runs ``chip_smoke.fused_case`` of that checkout (its own kernels, built from
its own ``graphphysics_torch/csrc``) on the panels batch at widths 128 and 64
with 4 heads in the model's layout, then the main path as ``chip_smoke.py``
times it: 20 ``Trainer`` steps (after 3 warm-up) of ``cylinder.json`` and
``panels.json`` on their 8 x 2,048 batches, wall and device ms a step, and
the eager eval forward of the 15 x 128 EPD and panels transformer on a
2,048-node frame. Prints one line ``COMPARE {json}``. Run it in turns on
the two checkouts (parent, change, change, parent). Needs one CUDA card.

    python3 chip_compare.py <checkout root> [label] --forward-host

measures instead where the host time of those eager forwards goes (their
kernels only are built): the CUDA-event ms of a forward (five reads), the
host's ms to enqueue one, the self CPU time a forward of every operator and
autograd function that ``torch.profiler`` records (CPU events only), and
the host's us a call of K1's and the fused attention's Python entry
(``csr_segment_sum``, ``csr_attention``) and of ``torch.add`` on a tiny
graph (64 nodes, 256 edges), where the call, not the kernel, sets the
time.
"""
import json
import os
import sys
import time


def main_path(cs, torch) -> dict:
    """ms a train step (wall, device) of both families on their batches and
    ms an eager serving forward on a frame."""
    from graphphysics_torch.training import Trainer

    cylinder, panels = cs.load_config(cs.CYLINDER_CONFIG), cs.load_config(cs.PANELS_CONFIG)
    out = {}
    for label, param, batch in (("epd", cylinder, cs.flagship_batch(0)),
                                ("transformer", panels, cs.panels_batch(200))):
        trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=0, device="cuda",
                          metrics_path=None, rollout_dir=None)
        trainer.init_state(1 + cs.WARMUP_STEPS + cs.TIMED_STEPS + cs.PROFILED_STEPS)
        dev_batch = batch.to("cuda")
        for _ in range(cs.WARMUP_STEPS):
            trainer.train_step(dev_batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.TIMED_STEPS):
            trainer.train_step(dev_batch)
        torch.cuda.synchronize()
        out[f"{label}_ms_per_step"] = (time.perf_counter() - t0) / cs.TIMED_STEPS * 1e3
        breakdown = cs.device_breakdown(
            lambda: [trainer.train_step(dev_batch) for _ in range(cs.PROFILED_STEPS)],
            cs.PROFILED_STEPS, unit="step")
        out[f"{label}_device_ms_per_step"] = breakdown and breakdown["device_ms_per_step"]
    for label, sim, frame in _serving_sims(cs):
        with torch.inference_mode():
            out[f"{label}_forward_eager_ms"] = cs.call_ms(lambda: sim(frame))
    return out


def _serving_sims(cs):
    """The 15 x 128 EPD and panels transformer with a 2,048-node frame each,
    on the card."""
    from graphphysics_torch.dataset import build_preprocessing
    from graphphysics_torch.training import get_preprocessing
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    panels = cs.load_config(cs.PANELS_CONFIG)
    epd_frames, _ = cs.trajectory_frames(cylinder_trajectory, 2, 2, build_preprocessing(), "sorted")
    tf_frames, _ = cs.trajectory_frames(
        panels_trajectory, 2, panels["index"]["node_type_index"],
        get_preprocessing(panels, use_edge_feature=False, remove_noise=True), "csr")
    return (("epd", cs.build_epd(0, "cuda"), epd_frames[0].to("cuda")),
            ("transformer", cs.build_transformer(panels, 0, "cuda"), tf_frames[0].to("cuda")))


def _per_call_us(torch, fn, calls=500, reads=5) -> float:
    """Median over ``reads`` of the wall us a call of ``fn`` over ``calls``
    back-to-back calls, synchronized at both ends."""
    fn()
    times = []
    for _ in range(reads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return sorted(times)[reads // 2]


def op_call_us(torch) -> dict:
    """Host us a call of the K1 and fused-attention entries and of
    ``torch.add`` on a 64-node, 256-edge graph, 128 wide (4 heads of 32)."""
    import numpy as np

    from graphphysics_torch.ops.csr_attention import csr_attention
    from graphphysics_torch.ops.csr_segment import compute_row_bounds, csr_segment_sum

    n, e, h, dh = 64, 256, 4, 32
    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, n, e)).astype(np.int32)
    bounds = torch.from_numpy(compute_row_bounds(seg, n)).cuda()
    seg_t = torch.from_numpy(seg).cuda()
    other = torch.from_numpy(rng.integers(0, n, e).astype(np.int32)).cuda()
    data = torch.randn(e, h * dh, device="cuda")
    q, k, v = (torch.randn(n, h, dh, device="cuda") for _ in range(3))
    with torch.inference_mode():
        return {
            "csr_segment_sum": _per_call_us(torch, lambda: csr_segment_sum(data, seg_t, bounds)),
            "csr_attention": _per_call_us(torch, lambda: csr_attention(q, k, v, seg_t, other, bounds)),
            "torch_add": _per_call_us(torch, lambda: torch.add(data, data)),
        }


def forward_host(cs, torch, forwards=10) -> dict:
    """Where the host time of the eager serving forwards goes (see the
    module's docstring)."""
    from torch.profiler import ProfilerActivity, profile

    out = {"op_call_us": op_call_us(torch)}
    for label, sim, frame in _serving_sims(cs):
        with torch.inference_mode():
            eager = [cs.call_ms(lambda: sim(frame)) for _ in range(5)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(forwards):
                sim(frame)
            enqueue_ms = (time.perf_counter() - t0) / forwards * 1e3
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for _ in range(forwards):
                    sim(frame)
                torch.cuda.synchronize()
        events = prof.key_averages()
        top = sorted(events, key=lambda ev: ev.self_cpu_time_total, reverse=True)[:25]
        entries = ("_SegmentSum", "_CsrAttention", "graphphysics_torch::csr_segment_sum",
                   "graphphysics_torch::csr_attention")
        out[label] = {
            "forward_eager_ms": eager,
            "forward_enqueue_ms": enqueue_ms,
            "profiled_self_cpu_ms_per_forward": sum(ev.self_cpu_time_total for ev in events) / forwards / 1e3,
            "events_per_forward": sum(ev.count for ev in events) / forwards,
            "top_self_cpu_us_per_forward": {ev.key: [ev.self_cpu_time_total / forwards, ev.count / forwards]
                                            for ev in top},
            "entry_cpu_us_per_call": {ev.key: ev.cpu_time_total / ev.count for ev in events
                                      if ev.key in entries},
        }
    return out


def main() -> int:
    root = os.path.abspath([a for a in sys.argv[1:] if not a.startswith("--")][0])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from graphphysics_torch.ops import _native

    if not _native.CSRC.is_relative_to(root):
        raise SystemExit(f"kernels would come from {_native.CSRC}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = "--forward-host" in sys.argv
    positional = [a for a in sys.argv[1:] if not a.startswith("--")]
    out = {"tree": positional[1] if len(positional) > 1 else root}
    if host:
        _native.build(("csr_segment_sum.cu", "csr_attention.cu"))
        out.update(forward_host(cs, torch))
        print("COMPARE " + json.dumps(out), flush=True)
        return 0
    _native.build(("csr_segment_sum.cu", "csr_attention.cu", "csr_attention_bwd.cu",
                   "csr_softmax_spmm.cu", "csr_softmax_spmm_bwd.cu"))
    batch = cs.panels_batch(200)
    for d in (128, 64):
        f, b = cs.fused_case(f"d{d}", batch, d, 13, library=False)
        out[f"fwd_ms_{d}"] = f["ms"]
        out[f"bwd_ms_{d}"] = b["ms"]
    out.update(main_path(cs, torch))
    print("COMPARE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
