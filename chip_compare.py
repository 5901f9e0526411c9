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

    python3 chip_compare.py <checkout root> [label] --stream

times instead that checkout's f32 and 16-bit K1 entries and K2's and K5's
bf16 stream entries (its ``chip_smoke.k1_case`` and ``chip_stream``'s
``k1_16bit_case``, ``k2_stream_case`` and ``k5_stream_case``, the stream
cases with the f32 entry on the same values beside them) at their three
shapes (seeds and graphs as ``chip_smoke.py`` makes them, the frames from
2-frame trajectories), with the seconds of the three sources' ``nvcc``
builds and a digest of each output on the cases' own seeded inputs, so
two commits' bits can be compared. It calls only functions that a parent
checkout's scripts have too (``k1_case``, ``k1_16bit_case``,
``k2_stream_case``, ``k5_stream_case``), so this script drives either.

    python3 chip_compare.py <checkout root> [label] --k2

times instead that checkout's f32 K2 (``csr_softmax_spmm``, its
``chip_smoke.k2_case``) at its four shapes: the transformer serving frame
(from a 2-frame trajectory), the panels batch, the aneurysm graph and part
0 of the unsplit 4-way cut of the 16,384-node mesh (its
``unsplit_part0``), seeds as ``chip_smoke.py`` makes them, with the
seconds of the ``nvcc`` builds of K2's, K3's and K5's sources and a
digest of each output and ``ml`` on the case's own seeded inputs; then a
digest of K3's gradients (``csr_softmax_spmm_backward``) on each K2 case's
inputs and outputs, and of K5's f32 forward and backward and bf16 stream
forward (``csr_softmax_spmm_pair``) on part 0 of the 4-way split-edge cut
of the mesh at D = 128 (its contiguous and 16-byte word geometries) and
D = 40 in 4 heads (its general geometry in f32 and bf16); last, where the
checkout's ``k2_case`` and ``k3_case`` take a head count, K2 and K3 at the
widths of their general geometry (``chip_smoke.GENERAL_WIDTHS`` on the
panels batch, 48 x 4 and 40 x 8 at part 0 of the unsplit mesh cut), with
the geometry, ms, bound, plain ms and a digest of each output. The rest
calls only ``k2_case``, ``unsplit_part0``, ``chip_partition.k5_inputs``
and ``mesh_graph``, which a parent checkout's scripts have too.

    python3 chip_compare.py <checkout root> [label] --width

times instead that checkout's fused f32 forward and backward
(``csr_attention``, ``csr_attention_backward``) on the panels batch at the
widths without a fast geometry in the model's layout (48 x 4, 96 x 3,
40 x 8; ``chip_smoke.GENERAL_WIDTHS``), in the model's (N, Dh, H) view and
contiguous, through ``chip_smoke.fused_case(..., heads=, view=)``: ms, ms
at each lane count the kernels take, bound, plain ms, the geometry and the
error; then the bf16 entries at the widths without their 16-byte geometry
(``BF16_WIDTH_CASES``, through ``chip_smoke.fused_bf16_case``: ms, plain
ms, the f32 entry's ms, bound, geometry, error); with the seconds of the
fused sources' ``nvcc`` builds and digests of outputs (``DIGEST_CASES``)
that must not change with the bf16 word geometry: every f32 geometry's
forward out and ml and backward dq (its dk and dv are atomic sums, whose
bits vary from run to run) and the bf16 16-byte geometry's out, ml, dq, dk
and dv at 128 x 4 and 64 x 4; and the bf16 48 x 4 in the model's view,
whose geometry the change replaces. It calls only ``fused_case``,
``fused_bf16_case`` and ``attention_inputs``, which a parent checkout's
``chip_smoke.py`` has too (the 8-byte-aligned bf16 view only where the
checkout's ``fused_bf16_case`` takes it).
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


STREAM_SOURCES = ("csr_segment_sum.cu", "csr_softmax_spmm.cu", "csr_softmax_spmm_pair.cu")


def _digest(torch, t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def stream_kernels(cs, torch) -> dict:
    """The f32 and 16-bit K1 (bf16, f16) and K2's and K5's bf16 streams at
    their three shapes: ms, the f32 entry's ms, bound, error and a digest
    of each output."""
    import chip_stream as st
    from chip_partition import k5_inputs, mesh_graph
    from graphphysics_torch.dataset import build_preprocessing
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import csr_segment_sum
    from graphphysics_torch.training import get_preprocessing
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    dev = torch.device("cuda")
    panels = cs.load_config(cs.PANELS_CONFIG)
    epd_frame = cs.trajectory_frames(cylinder_trajectory, 2, 2, build_preprocessing(), "sorted")[0][0]
    tf_frame = cs.trajectory_frames(
        panels_trajectory, 2, panels["index"]["node_type_index"],
        get_preprocessing(panels, use_edge_feature=False, remove_noise=True), "csr")[0][0]
    keep = ("ms", "f32_entry_ms", "bound_ms", "max_abs_err")
    out = {}
    k1 = (("serving_frame", epd_frame), ("flagship_batch_8x2048", cs.flagship_batch(0)),
          ("aneurysm_epd_66560x524288", cs.random_graph(*cs.ANEURYSM, 100)))
    for i, (label, graph) in enumerate(k1):
        seed = i  # chip_smoke.py's K1 seeds
        record = {k: v for k, v in cs.k1_case(label, graph, seed).items() if k in keep}
        # k1_case's data: the same generator, seed and draw
        recv = torch.as_tensor(graph.receivers).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        data = torch.randn((recv.shape[0], cs.HIDDEN), generator=gen, device=dev)
        with torch.no_grad():
            got = csr_segment_sum(data, recv, torch.as_tensor(graph.row_bounds).to(dev),
                                  torch.as_tensor(graph.edge_mask).to(dev))
        out[f"k1_f32_{label}"] = {**record, "digest": _digest(torch, got)}
    aneurysm_csr = cs.random_csr_graph(*cs.ANEURYSM, 300)
    k2 = (("transformer_serving_frame", tf_frame, cs.HIDDEN),
          ("panels_csr_batch_8x2048", cs.panels_batch(200), cs.HIDDEN),
          ("aneurysm_csr_66560x524288", aneurysm_csr, 64))
    for i, (label, graph, width) in enumerate(k2):
        seed = 80 + i
        record = {k: v for k, v in st.k2_stream_case(label, graph, width, seed).items() if k in keep}
        # k2_stream_case's inputs: the same generator, seed and draws
        seg = torch.as_tensor(graph.senders).to(dev)
        bounds = torch.as_tensor(graph.sender_bounds).to(dev)
        mask = torch.as_tensor(graph.edge_mask).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        scores = 3 * torch.randn((seg.shape[0], cs.HEADS), generator=gen, device=dev)
        scores = torch.where(mask[:, None], scores, torch.full((), ca.NEG, device=dev))
        values = torch.randn((seg.shape[0], width), generator=gen, device=dev)
        with torch.no_grad():
            got, ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask, stream_dtype="bf16")
        out[f"k2_stream_{label}"] = {**record, "digest": _digest(torch, got), "ml_digest": _digest(torch, ml)}
    for dt in (torch.bfloat16, torch.float16):
        for i, (label, graph) in enumerate(k1):
            seed = 70 + i
            record = {k: v for k, v in st.k1_16bit_case(label, graph, dt, seed)[0].items() if k in keep}
            # k1_16bit_case's data: the same generator, seed and draw
            recv = torch.as_tensor(graph.receivers).to(dev)
            gen = torch.Generator(device=dev).manual_seed(seed)
            data = torch.randn((recv.shape[0], cs.HIDDEN), generator=gen, device=dev).to(dt)
            with torch.no_grad():
                got = csr_segment_sum(data, recv, torch.as_tensor(graph.row_bounds).to(dev),
                                      torch.as_tensor(graph.edge_mask).to(dev))
            out[f"k1_{st.SHORT[dt]}_{label}"] = {**record, "digest": _digest(torch, got)}
    k5 = (("serving_frame_2048_part0_of_4", tf_frame, cs.HIDDEN),
          ("mesh_16384_part0_of_4", mesh_graph("csr", 671), cs.HIDDEN),
          ("aneurysm_csr_66560x524288_part0_of_4", aneurysm_csr, 64))
    for i, (label, graph, width) in enumerate(k5):
        seed = 83 + i
        record = {k: v for k, v in st.k5_stream_case(label, graph, width, seed).items() if k in keep}
        n, _, seg, masks, bounds, scores, values, _ = k5_inputs(graph, width, seed)
        with torch.no_grad():
            got, _ = ca.csr_softmax_spmm_pair(scores[0], values[0], seg[0], bounds[0], scores[1], values[1],
                                              seg[1], bounds[1], *masks, stream_dtype="bf16")
        out[f"k5_stream_{label}"] = {**record, "digest": _digest(torch, got)}
    return out


def k2_kernels(cs, torch) -> dict:
    """The f32 K2 at its four shapes: ms, bound, error, and a digest of
    each output and ``ml``."""
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.training import get_preprocessing
    from graphphysics_torch.utils.synthetic import panels_trajectory

    dev = torch.device("cuda")
    panels = cs.load_config(cs.PANELS_CONFIG)
    tf_frame = cs.trajectory_frames(
        panels_trajectory, 2, panels["index"]["node_type_index"],
        get_preprocessing(panels, use_edge_feature=False, remove_noise=True), "csr")[0][0]
    keep = ("ms", "plain_ms", "bound_ms", "max_abs_err", "ml_max_abs_err", "geometry")
    cases = (("transformer_serving_frame", tf_frame, cs.HIDDEN, 3),  # chip_smoke.py's K2 seeds
             ("panels_csr_batch_8x2048", cs.panels_batch(200), cs.HIDDEN, 4),
             ("aneurysm_csr_66560x524288", cs.random_csr_graph(*cs.ANEURYSM, 300), 64, 5),
             ("mesh_16384_part0_of_4_unsplit", cs.unsplit_part0(601), cs.HIDDEN, 81))
    out = {}
    for label, graph, width, seed in cases:
        record = {k: v for k, v in cs.k2_case(label, graph, width, seed).items() if k in keep}
        # k2_case's inputs: the same generator, seed and draws
        seg = torch.as_tensor(graph.senders).to(dev)
        bounds = torch.as_tensor(graph.sender_bounds).to(dev)
        mask = torch.as_tensor(graph.edge_mask).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        scores = 3 * torch.randn((seg.shape[0], cs.HEADS), generator=gen, device=dev)
        scores = torch.where(mask[:, None], scores, torch.full((), ca.NEG, device=dev))
        values = torch.randn((seg.shape[0], width), generator=gen, device=dev)
        with torch.no_grad():
            got, ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask)
            g = torch.randn((got.shape[0], width), generator=gen, device=dev)
            ds, dv = ca.csr_softmax_spmm_backward(scores, values, seg, bounds, ml, got, g, mask)
        out[f"k2_f32_{label}"] = {**record, "bound_share": record["bound_ms"] / record["ms"],
                                  "digest": _digest(torch, got), "ml_digest": _digest(torch, ml),
                                  "k3_digests": [_digest(torch, ds), _digest(torch, dv)]}
    out.update(k5_digests(cs, torch))
    return out


def k5_digests(cs, torch) -> dict:
    """Digests of K5's f32 forward and backward and bf16 stream forward on
    part 0 of the mesh's 4-way split-edge cut, at D = 128 and D = 40 (4
    heads)."""
    from chip_partition import k5_inputs, mesh_graph
    from graphphysics_torch.ops import csr_attention as ca

    graph = mesh_graph("csr", 601)
    out = {}
    for width in (128, 40):
        n, _, seg, masks, bounds, scores, values, g = k5_inputs(graph, width, 85)
        digests = {}
        with torch.no_grad():
            for stream in ("f32", "bf16"):
                got, ml = ca.csr_softmax_spmm_pair(scores[0], values[0], seg[0], bounds[0], scores[1], values[1],
                                                   seg[1], bounds[1], *masks, stream_dtype=stream)
                digests[f"forward_{stream}"] = [_digest(torch, got), _digest(torch, ml)]
                if stream == "f32":
                    grads = ca.csr_softmax_spmm_pair_backward(scores[0], values[0], seg[0], bounds[0], scores[1],
                                                              values[1], seg[1], bounds[1], ml, got, g, *masks)
                    digests["backward_f32"] = [_digest(torch, t) for t in grads]
        out[f"k5_mesh_16384_part0_of_4_d{width}"] = digests
    return out


def general_kernels(cs, torch) -> dict:
    """K2 and K3 at the general geometry's widths: ``k2_case`` and
    ``k3_case`` records (ms, bound, plain ms, geometry, digests); empty
    where the checkout's cases take no head count (a tree before the
    general geometry)."""
    import inspect

    if "heads" not in inspect.signature(cs.k2_case).parameters:
        return {}
    keep = ("ms", "plain_ms", "bound_ms", "max_abs_err", "geometry", "columns", "digest", "ml_digest")
    batch, part = cs.panels_batch(200), cs.unsplit_part0(601)
    cases = [(f"panels_csr_batch_8x2048_d{d}_h{h}", batch, d, h, 84 + i, 88 + i)
             for i, (d, h) in enumerate(cs.GENERAL_WIDTHS)]
    cases += [("mesh_16384_part0_of_4_unsplit_d48_h4", part, 48, 4, 87, 91),
              ("mesh_16384_part0_of_4_unsplit_d40_h8", part, 40, 8, 92, 93)]
    out = {}
    for label, graph, width, heads, k2_seed, k3_seed in cases:  # chip_smoke.py's seeds
        for name, case, seed in (("k2", cs.k2_case, k2_seed), ("k3", cs.k3_case, k3_seed)):
            record = case(label, graph, width, seed, heads=heads)
            out[f"{name}_{label}"] = {k: v for k, v in record.items() if k in keep}
    return out


WIDTH_SOURCES = ("csr_attention.cu", "csr_attention_bwd.cu", "csr_attention_bf16.cu",
                 "csr_attention_bwd_bf16.cu", "csr_attention_bf16_words.cu")
# the bf16 entries' cases at the widths without their 16-byte geometry
# (chip_smoke.BF16_WORD_CASES, whose seeds they take); the 8-byte-aligned
# view only where the checkout's fused_bf16_case takes it
BF16_WIDTH_CASES = ((48, 4, "model"), (96, 3, "model"), (40, 8, "model"), (96, 3, "contiguous"),
                    (48, 4, "contiguous"), (20, 4, "model"), (36, 4, "model"), (20, 1, "model"),
                    (48, 4, "model_8_byte"))
# (D, H, view, dtype) whose outputs' digests must not change with the bf16
# word geometry: every f32 geometry (fast at 128 x 4, 64 x 4 and the
# contiguous 48 x 4 and 40 x 8; words at the rest) and the bf16 16-byte
# geometry; the bf16 48 x 4 in the model's view changes by design
DIGEST_CASES = ((128, 4, "model", "f32"), (64, 4, "model", "f32"), (48, 4, "model", "f32"),
                (96, 3, "model", "f32"), (40, 8, "model", "f32"), (96, 3, "contiguous", "f32"),
                (48, 4, "contiguous", "f32"), (40, 8, "contiguous", "f32"), (128, 4, "model", "bf16"),
                (64, 4, "model", "bf16"), (48, 4, "model", "bf16"))


def width_kernels(cs, torch) -> dict:
    """The fused f32 forward and backward at ``GENERAL_WIDTHS`` in both
    views (``fused_case`` records), the bf16 entries at ``BF16_WIDTH_CASES``
    (``fused_bf16_case`` records), then the digests of ``DIGEST_CASES``'
    outputs."""
    from graphphysics_torch.ops import csr_attention as ca

    batch = cs.panels_batch(200)
    keep = ("ms", "ms_by_lanes", "plain_ms", "bound_ms", "max_abs_err", "geometry", "lanes_per_row")
    out = {}
    cases = [(w, v) for w in cs.GENERAL_WIDTHS for v in ("model", "contiguous")]
    for i, ((d, h), view) in enumerate(cases):  # chip_smoke.py's kernel_width seeds
        label = f"panels_csr_batch_8x2048_d{d}_h{h}_{view}"
        records = cs.fused_case(label, batch, d, 15 + i, library=False, heads=h, view=view, replaced=False)
        for name, record in zip(("fwd", "bwd"), records):
            out[f"{name}_{label}"] = {**{k: record[k] for k in keep},
                                      "bound_share": record["bound_ms"] / record["ms"]}
    keep16 = ("ms", "plain_ms", "f32_entry_ms", "bound_ms", "max_abs_err", "geometry", "lanes_per_row")
    for i, (d, h, view) in enumerate(BF16_WIDTH_CASES):  # chip_smoke.py's fused_bf16_kernels seeds
        if view == "model_8_byte" and not hasattr(cs, "eight_byte_view"):
            continue
        label = f"panels_csr_batch_8x2048_d{d}_h{h}_{view}"
        records = cs.fused_bf16_case(label, batch, d, 44 + i, heads=h, view=view, library=False)
        for name, record in zip(("bf16_fwd", "bf16_bwd"), records):
            out[f"{name}_{label}"] = {**{k: record[k] for k in keep16},
                                      "bound_share": record["bound_ms"] / record["ms"]}
    for d, h, view, dt in DIGEST_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        seg, gather, bounds, mask, qkvg = cs.attention_inputs(batch, d, 40 + d, h, view)
        q, k, v, g = (t.to(dtype) for t in qkvg)  # `to` keeps the layout
        scale = h ** -0.5
        with torch.no_grad():
            got, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale)
            tc = ca.gather_csr(seg, gather, bounds, mask) if dt == "bf16" else None
            grads = ca.csr_attention_backward(q, k, v, seg, gather, bounds, ml, got, g, mask, scale, tc)
        kept = grads if dt == "bf16" else grads[:1]
        interleaved = view == "model"
        out[f"digest_{dt}_d{d}_h{h}_{view}"] = {
            "geometry": (ca.bf16_geometry(d, h, interleaved)[1:] if dt == "bf16"
                         else f32_geometry(ca, d, h, interleaved)),
            "out": _digest(torch, got), "ml": _digest(torch, ml),
            "grads": [_digest(torch, t) for t in kept]}
    return out


def f32_geometry(ca, d, h, interleaved=True) -> list:
    """The f32 forward's and backward's geometry at width d in h heads, the
    model's layout (or contiguous)."""
    return [ca.geometry_kind(ca.lanes_per_row(d, h, interleaved, backward=b), d, h, interleaved)
            for b in (False, True)]


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
    if "--k2" in sys.argv:
        out["nvcc_s"] = _native.build(("csr_softmax_spmm.cu", "csr_softmax_spmm_bwd.cu", "csr_softmax_spmm_pair.cu"))
        out.update(k2_kernels(cs, torch))
        out.update(general_kernels(cs, torch))
        print("COMPARE " + json.dumps(out), flush=True)
        return 0
    if "--width" in sys.argv:
        out["nvcc_s"] = _native.build([x for x in WIDTH_SOURCES if (_native.CSRC / x).exists()])
        out.update(width_kernels(cs, torch))
        print("COMPARE " + json.dumps(out), flush=True)
        return 0
    if "--stream" in sys.argv:
        out["nvcc_s"] = _native.build(STREAM_SOURCES)
        out.update(stream_kernels(cs, torch))
        print("COMPARE " + json.dumps(out), flush=True)
        return 0
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
