"""The TPU kernels' two 16-bit stream modes on the card: ``chip_smoke.py``'s
``stream_dtypes`` phase, kept in a module of its own.

- K1 and K1b on bf16 and f16 data (the entries ``csr_segment_sum_bf16`` /
  ``_f16`` and ``csr_segment_sum_bwd_bf16`` / ``_f16`` of
  ``csrc/csr_segment_sum.cu``) at K1's three shapes: the forward within one
  unit in the last place of the output dtype of its plain version, the
  backward bit-equal, and a hub row of 4,096 unit edges that must read
  exactly 4,096. Timed beside the bound, the plain version, the f32 entry
  on the f32 data, the path they replace (``masked_segment_sum``'s upcast,
  the f32 K1 and the downcast) and ``index_add_`` into f32. Each record
  names the lane geometry that ran (``segment_sum_geometry``) and a digest
  of each output, so a run of another commit on the same seed shows
  whether the bits moved.
- ``stream_dtype="bf16"``: the stream entries of K2 (K2's three shapes), K5
  (K5's three shapes) and the fused forward on f32 and on bf16 q, k, v (the
  fused entries' three shapes), each against its plain version at the
  phase's tolerance, and each shown to differ from the same function
  without the stream by more than that tolerance (a kernel that skipped the
  rounding would pass the first check alone). Timed beside the bound, the
  plain version and the entry without the stream.
- Every lane geometry of the 16-bit K1 and of K2's and K5's stream
  entries, by width, heads and the data's alignment
  (``k1_geometry_cases``, ``k2_geometry_cases``, ``k5_geometry_cases``):
  each against its plain version at the limits above, each output the
  same bits on a second run, the 16-bit K1's geometries of one width the
  same bits as each other, and each stream farther than its tolerance
  from the f32 mode. K2's stream records carry their geometry and a
  digest too.
- The slice's path: ``masked_segment_sum`` on bf16 and f16 data and the
  three functions with ``stream_dtype="bf16"``, forward and backward,
  through the entry points a caller uses, with every counter set to 0
  just before and read just after: each new entry, and the existing
  backward entries the streams' gradients take, launched once, and
  nothing else (no f32 K1: no upcast on the 16-bit path). Its outputs and
  gradients are held against the plain versions afterwards.

Run through ``python3 chip_smoke.py``; ``stream_phase`` returns the records
of the kernels line and the path's launches."""

import hashlib
import math
import time

import numpy as np
import torch

K1_ULPS = 1  # the 16-bit K1 against its plain version: both sum in f32, round once
HUB_EDGES = 4096
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}  # explicit mantissa bits
SHORT = {torch.bfloat16: "bf16", torch.float16: "f16"}  # the entries' suffixes
# the geometry checks: data alignments in bytes (16-byte words where the
# width allows, 4-byte pairs, single columns), K1's widths, and K5's
# (width, heads, alignment of the bf16 values): 16-byte words at two and
# four rows a warp, 8-byte words (a 12-wide head; an 8-byte aligned view),
# and the general geometry (a 5-wide head; a 4-byte aligned view)
ALIGNMENTS = (16, 4, 2)
K1_WIDTHS = (128, 64, 48, 127)
K5_GEOMETRY_CASES = ((128, 4, 16), (64, 4, 16), (48, 4, 16), (128, 4, 8), (40, 8, 16), (128, 4, 4))
# K2's stream (width, heads, alignment of the bf16 values): 16-byte words at
# two, four and eight rows a warp, 8-byte words (heads of 4; an 8-byte
# aligned view; heads of 12), the kernel of V = D/32 columns a lane (a
# 4-byte aligned view at D = 64, whose 4-byte loads it takes; D = 512), and
# the general geometry's strided columns (heads of 5; a 4-byte view at
# D = 128, whose 8-byte loads the V columns would need; views of D = 512
# and 64 narrower than the V columns' loads, timed beside those)
K2_GEOMETRY_CASES = ((128, 4, 16), (64, 4, 16), (32, 4, 16), (32, 8, 16), (128, 4, 8), (64, 4, 4),
                     (512, 4, 16), (48, 4, 16), (40, 8, 16), (128, 4, 4), (512, 4, 4), (64, 4, 2))


def _cs():
    import chip_smoke

    return chip_smoke


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap between ``got`` and ``want`` (one 16-bit dtype) in
    units in the last place of ``want``'s values (below the least normal
    value, the subnormals' spacing)."""
    dtype = want.dtype
    mag = want.float().abs().clamp_min(torch.finfo(dtype).tiny)
    _, exp = torch.frexp(mag)  # mag = m * 2^exp, 0.5 <= m < 1
    unit = torch.exp2((exp - 1 - MANTISSA[dtype]).float())
    return ((got.float() - want.float()).abs() / unit).max().item()


def digest(t: torch.Tensor) -> str:
    """The first 16 hex digits of the sha256 of ``t``'s bytes: outputs of
    two runs or two commits on the same seed are bit-equal where these
    agree."""
    return hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def view_at(t: torch.Tensor, aligned: int) -> torch.Tensor:
    """A copy of ``t`` (contiguous) whose first element sits at an address
    that is ``aligned`` bytes aligned and no more: the views the kernels'
    narrower geometries take."""
    from graphphysics_torch.ops.csr_segment import alignment

    extra = 16 // t.element_size()
    flat = torch.empty(t.numel() + 2 * extra, dtype=t.dtype, device=t.device)
    offset = next(k for k in range(2 * extra) if alignment(flat[k:]) == aligned)
    out = flat[offset:offset + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _bound(bytes_, ops):
    cs = _cs()
    by_bytes, by_ops = bytes_ / cs.H100_BYTES_PER_S * 1e3, ops / cs.H100_F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": bytes_, "operations": ops}


def _copies(t, copies):
    return [t] + [tuple(x.clone() for x in t) for _ in range(copies - 1)]


# ---------------------------------------------------------------------------
# K1 and K1b on 16-bit data


def k1_16bit_case(name, graph, dtype, seed):
    """K1's and K1b's 16-bit entries on one receiver-sorted layout. Returns
    (forward record, backward record)."""
    from graphphysics_torch.ops.csr_segment import (
        alignment,
        csr_segment_sum,
        csr_segment_sum_backward,
        csr_segment_sum_backward_reference,
        csr_segment_sum_reference,
        segment_sum_geometry,
    )

    cs = _cs()
    dev, hidden = torch.device("cuda"), cs.HIDDEN
    recv = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.row_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n = recv.shape[0], bounds.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randn((e, hidden), generator=gen, device=dev).to(dtype)
    g = torch.randn((n, hidden), generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        got = csr_segment_sum(data, recv, bounds, mask)
        again = csr_segment_sum(data, recv, bounds, mask)
        want = csr_segment_sum_reference(data, recv, n, mask)
        got_b = csr_segment_sum_backward(g, recv, bounds, mask)
        again_b = csr_segment_sum_backward(g, recv, bounds, mask)
        want_b = csr_segment_sum_backward_reference(g, recv, bounds, mask)
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and torch.equal(got_b, again_b)):
            raise AssertionError(f"{name}: {dtype} K1 / K1b not bit-equal on a second run")
        if got.dtype != dtype or got_b.dtype != dtype:
            raise AssertionError(f"{name}: the {dtype} entries gave {got.dtype}, {got_b.dtype}")
        err_ulps = ulps(got, want)
        if not (torch.isfinite(got.float()).all() and err_ulps <= K1_ULPS):
            raise AssertionError(f"{name}: {dtype} K1 vs plain {err_ulps} ulps > {K1_ULPS}")
        if not torch.equal(got_b, want_b):
            raise AssertionError(f"{name}: {dtype} K1b differs from its plain version")
        err = (got.float() - want.float()).abs().max().item()

        real_edges = int(mask.sum().item())
        fwd_bytes = real_edges * (hidden * 2 + 1) + n * (8 + hidden * 2)
        bwd_bytes = e * hidden * 2 + e * (4 + 1) + n * (hidden * 2 + 8)
        copies = cs.copies_past_l2(fwd_bytes)
        d16 = _copies((data,), copies)
        d32 = [(t.float(),) for (t,) in d16]  # the f32 entry's data: the same values
        # the yardstick sums the same function into f32: masked rows zeroed
        # and the cast done beforehand, as the f32 row's
        lib = [(torch.where(mask[:, None], t, torch.zeros((), device=dev)),) for (t,) in d32]

        def k1(d):
            return csr_segment_sum(d, recv, bounds, mask)

        def replaced(d):  # masked_segment_sum's 16-bit path before: upcast, f32 K1, downcast
            return csr_segment_sum(d.to(torch.float32), recv, bounds, mask).to(d.dtype)

        def library(d):
            return torch.zeros((n, hidden), device=dev).index_add_(0, recv, d)

        fwd = {"ms": cs.device_ms(k1, d16),
               "plain_ms": cs.device_ms(lambda d: csr_segment_sum_reference(d, recv, n, mask), d16),
               "f32_entry_ms": cs.device_ms(k1, d32), "replaced_ms": cs.device_ms(replaced, d16),
               "library_ms": cs.device_ms(library, lib)}
        bcopies = cs.copies_past_l2(bwd_bytes)
        g16 = _copies((g,), bcopies)
        g32 = [(t.float(),) for (t,) in g16]

        def k1b(x):
            return csr_segment_sum_backward(x, recv, bounds, mask)

        def replaced_b(x):  # the same path's gradient: the casts' backward around the f32 K1b
            return csr_segment_sum_backward(x.to(torch.float32), recv, bounds, mask).to(x.dtype)

        bwd = {"ms": cs.device_ms(k1b, g16),
               "plain_ms": cs.device_ms(lambda x: csr_segment_sum_backward_reference(x, recv, bounds, mask), g16),
               "f32_entry_ms": cs.device_ms(k1b, g32), "replaced_ms": cs.device_ms(replaced_b, g16),
               "library_ms": cs.device_ms(lambda x: x.index_select(0, recv), g16)}
    common = {"shape": name, "dtype": str(dtype).replace("torch.", ""), "nodes": n, "edges": e,
              "real_edges": real_edges, "hidden": hidden}
    forward = {**common, "max_abs_err": err, "max_ulps": err_ulps, "tolerance": {"ulps": K1_ULPS},
               "geometry": segment_sum_geometry(hidden, dtype, alignment(data))._asdict(),
               "digest": digest(got), "inputs": f"torch.randn on the card, seed {seed}, cast to {dtype}",
               "bit_equal_twice": True, **fwd,
               "replaced_note": "masked_segment_sum's 16-bit path before: upcast to f32, the f32 K1, downcast",
               "library_note": "index_add_ into f32 of the masked f32 upcast (the cast outside the timing)",
               "input_copies": copies, **_bound(fwd_bytes, real_edges * hidden)}
    backward = {**common, "max_abs_err": 0.0, "tolerance": 0.0, "bit_equal": True, "bit_equal_twice": True,
                "digest": digest(got_b), **bwd,
                "replaced_note": "the gradient of that path: g upcast, the f32 K1b, ddata downcast",
                "library_note": "index_select(0, receivers) of the 16-bit g: the same gather without "
                                "zeroing masked and padded edges",
                "input_copies": bcopies, **_bound(bwd_bytes, 0)}
    return forward, backward


def hub_row(dtype) -> dict:
    """4,096 unit edges into node 0 and one into each other node, through
    the 16-bit K1 in each of its geometries (data 16-, 4- and 2-byte
    aligned): node 0 must read exactly 4,096 (a sum kept in bf16 stops at
    256, in f16 at 2,048), every other node 1."""
    from graphphysics_torch.ops.csr_segment import alignment, compute_row_bounds, csr_segment_sum, segment_sum_geometry

    dev, n, hidden = torch.device("cuda"), 64, _cs().HIDDEN
    recv_np = np.concatenate([np.zeros(HUB_EDGES, np.int32), np.arange(1, n, dtype=np.int32)])
    recv = torch.from_numpy(recv_np).to(dev)
    bounds = torch.from_numpy(compute_row_bounds(recv_np, n)).to(dev)
    read, kinds = [], []
    for aligned in ALIGNMENTS:
        data = view_at(torch.ones((len(recv_np), hidden), dtype=dtype, device=dev), aligned)
        with torch.no_grad():
            out = csr_segment_sum(data, recv, bounds)
        hub = out[0].float()
        kinds.append(segment_sum_geometry(hidden, dtype, alignment(data)).kind)
        if not (bool((hub == HUB_EDGES).all()) and bool((out[1:] == 1).all())):
            raise AssertionError(f"hub row in {dtype}, {kinds[-1]}: read {hub.min().item()}-{hub.max().item()}, "
                                 f"expected {HUB_EDGES}")
        read.append(hub.max().item())
    return {"dtype": str(dtype).replace("torch.", ""), "hub_edges": HUB_EDGES, "hub_row": min(read),
            "geometries": kinds}


def k1_geometry_cases(graph, seed) -> list:
    """The 16-bit K1 in every geometry its rule gives at the cylinder
    batch's layout: widths 128 and 64 (16-byte words, two and four rows a
    warp), 48 (16-byte words, two idle lanes of 8) and 127 (odd: single
    columns), each on data 16-, 4- and 2-byte aligned (words, pairs,
    single columns). Each within ``K1_ULPS`` of its plain version, the same
    bits twice, and the same bits in every geometry of a width (each adds
    a row's edges in edge order in f32)."""
    from graphphysics_torch.ops.csr_segment import (
        alignment,
        csr_segment_sum,
        csr_segment_sum_reference,
        segment_sum_geometry,
    )

    dev = torch.device("cuda")
    recv = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.row_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    n = bounds.shape[1]
    records = []
    for dtype in (torch.bfloat16, torch.float16):
        for width in K1_WIDTHS:
            gen = torch.Generator(device=dev).manual_seed(seed + width)
            data = torch.randn((recv.shape[0], width), generator=gen, device=dev).to(dtype)
            with torch.no_grad():
                want = csr_segment_sum_reference(data, recv, n, mask)
                outs, kinds, worst = [], [], 0.0
                for aligned in ALIGNMENTS:
                    d = view_at(data, aligned)
                    got, again = (csr_segment_sum(d, recv, bounds, mask) for _ in range(2))
                    torch.cuda.synchronize()
                    kinds.append(segment_sum_geometry(width, dtype, alignment(d)).kind)
                    worst = max(worst, ulps(got, want))
                    if not torch.equal(got, again) or worst > K1_ULPS:
                        raise AssertionError(f"{dtype} K1 at width {width}, {kinds[-1]}: {worst} ulps, "
                                             f"bit-equal twice {torch.equal(got, again)}")
                    outs.append(got)
            if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                raise AssertionError(f"{dtype} K1 at width {width}: geometries {kinds} give different bits")
            records.append({"entry": f"csr_segment_sum_{SHORT[dtype]}", "width": width, "aligned": ALIGNMENTS,
                            "geometries": kinds, "max_ulps": worst, "tolerance": {"ulps": K1_ULPS},
                            "bit_equal_twice": True, "bit_equal_across_geometries": True,
                            "digest": digest(outs[0])})
    return records


# ---------------------------------------------------------------------------
# stream_dtype="bf16"


def _differs(name, got, plain_f32, rtol, atol):
    """The stream's output against the same function without the stream:
    it must fail the phase's tolerance somewhere. Returns the gap and the
    share of elements outside the tolerance."""
    outside = ~torch.isclose(got.float(), plain_f32.float(), rtol=rtol, atol=atol)
    share = outside.float().mean().item()
    if not bool(outside.any()):
        raise AssertionError(f"{name}: the bf16 stream's output is within the tolerance of the f32 mode's")
    return {"f32_mode_max_abs_gap": (got.float() - plain_f32.float()).abs().max().item(),
            "f32_mode_share_outside_tolerance": share}


def k2_stream_case(name, graph, width, seed):
    """K2's bf16 stream entry (``csr_softmax_spmm_bf16_stream``) on one
    sender-sorted layout, scores masked as ``csr_sparse_attention`` masks
    them, in the geometry its rule (``stream_geometry``) gives the width
    and the casts' alignment."""
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import alignment

    cs = _cs()
    dev, h = torch.device("cuda"), cs.HEADS
    seg = torch.as_tensor(graph.senders).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    n = bounds.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = 3 * torch.randn((seg.shape[0], h), generator=gen, device=dev)
    scores = torch.where(mask[:, None], scores, torch.full((), ca.NEG, device=dev))
    values = torch.randn((seg.shape[0], width), generator=gen, device=dev)
    tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}

    def plain(s, v):
        return ca.csr_softmax_spmm_reference(ca.stream_round(s), ca.stream_round(v), seg, n, mask)

    with torch.no_grad():
        out, ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask, stream_dtype="bf16")
        again, again_ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask, stream_dtype="bf16")
        want_out, want_ml = plain(scores, values)
        f32_out, _ = ca.csr_softmax_spmm(scores, values, seg, bounds, mask)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(ml, again_ml)):
            raise AssertionError(f"{name}: K2 bf16 stream not bit-equal on a second run")
        errs = [(out - want_out).abs().max().item(), (ml - want_ml).abs().max().item()]
        if not (torch.isfinite(out).all() and torch.allclose(out, want_out, **tol)
                and torch.allclose(ml, want_ml, **tol)):
            raise AssertionError(f"{name}: K2 bf16 stream vs plain out/ml max_abs_err {errs}")
        gap = _differs(name, out, f32_out, **tol)
        real_edges = int(mask.sum().item())
        bytes_ = real_edges * (2 * h + 2 * width + 1) + n * (4 * width + 8 * h + 8)
        ops = real_edges * (2 * width + 3 * h) + n * width
        copies = cs.copies_past_l2(bytes_)
        f32s = _copies((scores, values), copies)
        b16s = [tuple(t.to(torch.bfloat16) for t in x) for x in f32s]
        geometry = ca.stream_geometry(width, h, alignment(b16s[0][1]))._asdict()
        times = {"ms": cs.device_ms(lambda s, v: ca._launch(s, v, bounds, mask), b16s),
                 "with_casts_ms": cs.device_ms(
                     lambda s, v: ca.csr_softmax_spmm(s, v, seg, bounds, mask, stream_dtype="bf16"), f32s),
                 "plain_ms": cs.device_ms(plain, f32s),
                 "f32_entry_ms": cs.device_ms(lambda s, v: ca.csr_softmax_spmm(s, v, seg, bounds, mask), f32s)}
    return {"shape": name, "nodes": n, "edges": seg.shape[0], "real_edges": real_edges, "width": width,
            "heads": h, "geometry": geometry, "bit_equal_twice": True, "digest": digest(out),
            "ml_digest": digest(ml), "max_abs_err": max(errs), "out_ml_max_abs_err": errs, "tolerance": tol,
            **gap, **times, "with_casts_note": "the public call: the two casts to bf16, then the kernel",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a segment softmax + SpMM",
            "input_copies": copies, **_bound(bytes_, ops)}


def k2_geometry_cases(graph, seed) -> list:
    """K2's bf16 stream entry in every geometry its rule gives, on one
    sender-sorted layout (``K2_GEOMETRY_CASES``: the bf16 values placed at
    the case's alignment and the entry launched on them): each against its
    plain version at the phase's tolerance, the same bits twice, and
    farther than that tolerance from the f32 mode; each timed beside its
    bound (``k2_stream_case``'s bytes)."""
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import alignment

    cs = _cs()
    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    n, e = bounds.shape[1], seg.shape[0]
    tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}
    records = []
    for i, (width, heads, aligned) in enumerate(K2_GEOMETRY_CASES):
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        scores = torch.where(mask[:, None], 3 * torch.randn((e, heads), generator=gen, device=dev),
                             torch.full((), ca.NEG, device=dev))
        values = torch.randn((e, width), generator=gen, device=dev)
        s16, v16 = scores.to(torch.bfloat16), view_at(values.to(torch.bfloat16), aligned)
        with torch.no_grad():
            out, ml = ca._launch(s16, v16, bounds, mask)
            again, again_ml = ca._launch(s16, v16, bounds, mask)
            want_out, want_ml = ca.csr_softmax_spmm_reference(s16.float(), v16.float(), seg, n, mask)
            f32_out, _ = ca.csr_softmax_spmm(scores, values, seg, bounds, mask)
            torch.cuda.synchronize()
        geometry = ca.stream_geometry(width, heads, alignment(v16))
        label = f"width {width}, {heads} heads, values {alignment(v16)}-byte aligned, {geometry.kind}"
        bytes_ = int(mask.sum().item()) * (2 * heads + 2 * width + 1) + n * (4 * width + 8 * heads + 8)
        errs = [(out - want_out).abs().max().item(), (ml - want_ml).abs().max().item()]
        if not (torch.equal(out, again) and torch.equal(ml, again_ml)):
            raise AssertionError(f"K2 bf16 stream at {label}: not bit-equal on a second run")
        if not (torch.isfinite(out).all() and torch.allclose(out, want_out, **tol)
                and torch.allclose(ml, want_ml, **tol)):
            raise AssertionError(f"K2 bf16 stream at {label} vs plain out/ml max_abs_err {errs}")
        records.append({"entry": "csr_softmax_spmm_bf16_stream", "width": width, "heads": heads,
                        "aligned": alignment(v16), "geometry": geometry._asdict(),
                        "columns": (ca.softmax_spmm_columns(width, heads, alignment(v16), 2)
                                    if geometry.kind == "general" else None),
                        "max_abs_err": max(errs),
                        "out_ml_max_abs_err": errs, "tolerance": tol, "bit_equal_twice": True,
                        "digest": digest(out), **_differs(label, out, f32_out, **tol),
                        "ms": cs.geometry_case_ms(lambda s, v: ca._launch(s, v, bounds, mask), s16, v16, aligned,
                                                  bytes_),
                        "bound_ms": bytes_ / cs.H100_BYTES_PER_S * 1e3})
    return records


def k5_stream_case(name, graph, width, seed):
    """K5's bf16 stream entry (``csr_softmax_spmm_pair_bf16_stream``) on
    part 0 of ``graph``'s 4-way split-edge partition, in the geometry its
    rule (``stream_geometry``) gives the width and the casts'
    alignment."""
    from chip_partition import k5_inputs
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import alignment

    cs = _cs()
    h = cs.HEADS
    n, el, seg, masks, bounds, scores, values, _ = k5_inputs(graph, width, seed)
    tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}

    def pair(sa, va, sb, vb, stream_dtype="f32"):
        return ca.csr_softmax_spmm_pair(sa, va, seg[0], bounds[0], sb, vb, seg[1], bounds[1], *masks,
                                        stream_dtype=stream_dtype)

    def plain(sa, va, sb, vb):
        sa, va, sb, vb = (ca.stream_round(t) for t in (sa, va, sb, vb))
        return ca.csr_softmax_spmm_pair_reference(sa, va, seg[0], sb, vb, seg[1], n, *masks)

    args = (scores[0], values[0], scores[1], values[1])
    with torch.no_grad():
        out, ml = pair(*args, stream_dtype="bf16")
        again, again_ml = pair(*args, stream_dtype="bf16")
        want_out, want_ml = plain(*args)
        f32_out, _ = pair(*args)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(ml, again_ml)):
            raise AssertionError(f"{name}: K5 bf16 stream not bit-equal on a second run")
        errs = [(out - want_out).abs().max().item(), (ml - want_ml).abs().max().item()]
        if not (torch.isfinite(out).all() and torch.allclose(out, want_out, **tol)
                and torch.allclose(ml, want_ml, **tol)):
            raise AssertionError(f"{name}: K5 bf16 stream vs plain out/ml max_abs_err {errs}")
        gap = _differs(name, out, f32_out, **tol)
        real = [int(m.sum().item()) for m in masks]
        real_edges = sum(real)
        bytes_ = real_edges * (2 * h + 2 * width + 1) + n * (16 + 4 * width + 8 * h)
        ops = real_edges * (2 * width + 3 * h) + n * width
        copies = cs.copies_past_l2(bytes_)
        f32s = _copies(args, copies)
        b16s = [tuple(t.to(torch.bfloat16) for t in x) for x in f32s]
        geometry = ca.stream_geometry(width, h, alignment(b16s[0][1], b16s[0][3]))._asdict()
        times = {"ms": cs.device_ms(lambda sa, va, sb, vb: ca._launch_pair(
                     sa, va, bounds[0], masks[0], sb, vb, bounds[1], masks[1]), b16s),
                 "with_casts_ms": cs.device_ms(lambda *a: pair(*a, stream_dtype="bf16"), f32s),
                 "plain_ms": cs.device_ms(plain, f32s), "f32_entry_ms": cs.device_ms(pair, f32s)}
    return {"shape": name, "rows": n, "local_slots": el, "halo_slots": int(masks[1].shape[0]),
            "local_edges": real[0], "halo_edges": real[1], "width": width, "heads": h,
            "geometry": geometry, "bit_equal_twice": True, "digest": digest(out),
            "max_abs_err": max(errs), "out_ml_max_abs_err": errs, "tolerance": tol, **gap, **times,
            "with_casts_note": "the public call: the four casts to bf16, then the kernel",
            "f32_entry_note": "the f32 entry's own geometry for the width (16-byte lanes at D = 32k)",
            "library_ms": None,
            "library_note": "no single PyTorch call computes a segment softmax + SpMM",
            "input_copies": copies, **_bound(bytes_, ops)}


def k5_geometry_cases(graph, seed) -> list:
    """K5's bf16 stream entry in every geometry its rule gives, on part 0
    of ``graph``'s 4-way split-edge partition (``K5_GEOMETRY_CASES``: the
    bf16 values placed at the case's alignment and the entry launched on
    them): each against its plain version at the phase's tolerance, the
    same bits twice, and farther than that tolerance from the f32 mode."""
    from chip_partition import k5_inputs
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import alignment

    cs = _cs()
    dev = torch.device("cuda")
    tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}
    records = []
    for i, (width, heads, aligned) in enumerate(K5_GEOMETRY_CASES):
        n, _, seg, masks, bounds, scores, values, _ = k5_inputs(graph, width, seed + i)
        if heads != cs.HEADS:
            gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
            scores = [torch.where(m[:, None], 3 * torch.randn((m.shape[0], heads), generator=gen, device=dev),
                                  torch.full((), ca.NEG, device=dev)) for m in masks]
        sa, sb = (t.to(torch.bfloat16) for t in scores)
        va, vb = (view_at(t.to(torch.bfloat16), aligned) for t in values)
        with torch.no_grad():
            out, ml = ca._launch_pair(sa, va, bounds[0], masks[0], sb, vb, bounds[1], masks[1])
            again, again_ml = ca._launch_pair(sa, va, bounds[0], masks[0], sb, vb, bounds[1], masks[1])
            want_out, want_ml = ca.csr_softmax_spmm_pair_reference(
                sa.float(), va.float(), seg[0], sb.float(), vb.float(), seg[1], n, *masks)
            f32_out, _ = ca.csr_softmax_spmm_pair(scores[0], values[0], seg[0], bounds[0], scores[1], values[1],
                                                  seg[1], bounds[1], *masks)
            torch.cuda.synchronize()
        geometry = ca.stream_geometry(width, heads, alignment(va, vb))
        label = f"width {width}, {heads} heads, values {alignment(va, vb)}-byte aligned, {geometry.kind}"
        errs = [(out - want_out).abs().max().item(), (ml - want_ml).abs().max().item()]
        if not (torch.equal(out, again) and torch.equal(ml, again_ml)):
            raise AssertionError(f"K5 bf16 stream at {label}: not bit-equal on a second run")
        if not (torch.isfinite(out).all() and torch.allclose(out, want_out, **tol)
                and torch.allclose(ml, want_ml, **tol)):
            raise AssertionError(f"K5 bf16 stream at {label} vs plain out/ml max_abs_err {errs}")
        records.append({"entry": "csr_softmax_spmm_pair_bf16_stream", "width": width, "heads": heads,
                        "aligned": alignment(va, vb), "geometry": geometry._asdict(), "max_abs_err": max(errs),
                        "out_ml_max_abs_err": errs, "tolerance": tol, "bit_equal_twice": True,
                        **_differs(label, out, f32_out, **tol)})
    return records


def grid_qk(q, k, interleaved):
    """q and k on a 1/16 grid in [-2, 2], in their layout: with a
    power-of-two scale every f32 score is then exact whatever the order of
    its sum, so the kernel and its plain version round the same score to
    bf16 (a score within an f32 ulp of a bf16 rounding boundary would
    otherwise round the other way on one side: a bf16 ulp, 2^-8 of the
    score, which no f32 tolerance holds)."""
    from graphphysics_torch.ops import csr_attention as ca

    return tuple(ca._in_layout((t * 16).round().clamp(-32, 32) / 16, interleaved) for t in (q, k))


def fused_stream_inputs(graph, width, seed, dtype):
    """``(seg, gather, bounds, mask, q, k, v, scale)`` of one sender-sorted
    layout: q, k, v of ``dtype`` in the model's (N, Dh, H) layout, q and k
    on the grid of ``grid_qk``, the model's scale H^-0.5 (a power of two at
    the phase's 4 heads)."""
    from graphphysics_torch.ops import csr_attention as ca

    cs = _cs()
    seg, gather, bounds, mask, (q, k, v, _) = cs.attention_inputs(graph, width, seed)
    scale = cs.HEADS ** -0.5
    if math.log2(scale) != round(math.log2(scale)):
        raise AssertionError(f"scale {scale} is not a power of two")
    q, k = grid_qk(q, k, ca._is_interleaved(q))
    q, k, v = (t.to(dtype) for t in (q, k, v))  # `to` keeps the layout
    return seg, gather, bounds, mask, q, k, v, scale


def fused_stream_case(name, graph, width, seed, dtype):
    """The fused forward's bf16 stream entry of ``dtype``'s q, k, v
    (``csr_attention_f32_stream`` or ``csr_attention_bf16_stream``) on one
    sender-sorted layout in the model's (N, Dh, H) layout."""
    from graphphysics_torch.ops import csr_attention as ca

    cs = _cs()
    seg, gather, bounds, mask, q, k, v, scale = fused_stream_inputs(graph, width, seed, dtype)
    n, h = bounds.shape[1], cs.HEADS
    bf16 = dtype == torch.bfloat16
    tol = ({"rtol": cs.BF16_KERNEL_RTOL, "atol": cs.BF16_KERNEL_ATOL} if bf16
           else {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL})

    def fused(a, b, c, stream_dtype="f32"):
        return ca.csr_attention(a, b, c, seg, gather, bounds, mask, scale, stream_dtype=stream_dtype)

    def plain(a, b, c):
        return ca.csr_attention_reference(a, b, c, seg, gather, n, mask, scale, stream_dtype="bf16")

    with torch.no_grad():
        out, ml = fused(q, k, v, "bf16")
        want_out, want_ml = plain(q, k, v)
        base, _ = fused(q, k, v)
        torch.cuda.synchronize()
        if out.dtype != dtype:
            raise AssertionError(f"{name}: the stream entry gave {out.dtype} for {dtype} q, k, v")
        errs = [(out.float() - want_out.float()).abs().max().item(), (ml - want_ml).abs().max().item()]
        share = (out != want_out).float().mean().item()
        if not (torch.isfinite(out.float()).all() and torch.allclose(out.float(), want_out.float(), **tol)
                and torch.allclose(ml, want_ml, rtol=cs.SOFTMAX_RTOL, atol=cs.SOFTMAX_ATOL)
                and (not bf16 or share <= cs.BF16_MISMATCH_SHARE)):
            raise AssertionError(f"{name}: fused {dtype} stream vs plain out/ml max_abs_err {errs}, "
                                 f"mismatch share {share}")
        gap = _differs(name, out, base, **tol)
        edges_read = int((bounds[1] - bounds[0]).clamp(min=0).sum().item())
        real_edges = int(mask.sum().item())
        row = (2 if bf16 else 4) * width
        # the f32 (bf16) entry's bytes and operations: the roundings move no byte
        bytes_ = n * 3 * row + edges_read * 5 + n * 8 + n * row + n * 8 * h
        ops = real_edges * (4 * width + 6 * h) + n * width
        copies = cs.copies_past_l2(bytes_)
        sets = _copies((q, k, v), copies)
        times = {"ms": cs.device_ms(lambda a, b, c: fused(a, b, c, "bf16"), sets),
                 "plain_ms": cs.device_ms(plain, sets), "without_stream_ms": cs.device_ms(fused, sets)}
    return {"shape": name, "nodes": n, "edges": seg.shape[0], "real_edges": real_edges, "width": width,
            "heads": h, "dtype": str(dtype).replace("torch.", ""), "scale": scale,
            "inputs": "q, k on a 1/16 grid in [-2, 2]; v normal", "max_abs_err": max(errs),
            "out_ml_max_abs_err": errs, "out_mismatch_share": share, "tolerance": tol, **gap, **times,
            "without_stream_note": f"csr_attention_{'bf16' if bf16 else 'f32'}, the same inputs",
            "library_ms": None,
            "library_note": "no PyTorch call rounds the scores to bf16 inside a softmax",
            "input_copies": copies, **_bound(bytes_, ops)}


# ---------------------------------------------------------------------------
# the slice's path


def driven_path(name, counts, cyl_batch, tf_batch, mesh, seed):
    """The public entry points on the 16-bit modes, forward and backward,
    with every counter set to 0 just before and read just after; then each
    output and gradient against its plain version. Returns the path's
    record (its ``launches`` among it)."""
    from chip_partition import k5_inputs
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import (
        csr_segment_sum_backward_reference,
        csr_segment_sum_reference,
    )
    from graphphysics_torch.ops.segment import masked_segment_sum

    cs = _cs()
    dev, h, hidden = torch.device("cuda"), cs.HEADS, cs.HIDDEN
    gen = torch.Generator(device=dev).manual_seed(seed)
    recv = torch.as_tensor(cyl_batch.receivers).to(dev)
    rb = torch.as_tensor(cyl_batch.row_bounds).to(dev)
    rmask = torch.as_tensor(cyl_batch.edge_mask).to(dev)
    nr = rb.shape[1]
    k1 = {dt: (torch.randn((recv.shape[0], hidden), generator=gen, device=dev).to(dt).requires_grad_(True),
               torch.randn((nr, hidden), generator=gen, device=dev).to(dt))
          for dt in (torch.bfloat16, torch.float16)}
    seg, gather, bounds, mask, (q, k, v, g) = cs.attention_inputs(tf_batch, hidden, seed + 1)
    n = bounds.shape[1]
    interleaved = ca._is_interleaved(q)
    q, k = grid_qk(q, k, interleaved)
    scale = h ** -0.5
    scores = 3 * torch.randn((seg.shape[0], h), generator=gen, device=dev)
    scores = torch.where(mask[:, None], scores, torch.full((), ca.NEG, device=dev))
    values = torch.randn((seg.shape[0], hidden), generator=gen, device=dev)
    g_k2 = torch.randn((n, hidden), generator=gen, device=dev)
    pn, _, pseg, pmasks, pbounds, pscores, pvalues, pg = k5_inputs(mesh, hidden, seed + 2)
    attn = {dt: tuple(t.detach().to(dt).requires_grad_(True) for t in (q, k, v))
            for dt in (torch.float32, torch.bfloat16)}
    k2_in = [t.clone().requires_grad_(True) for t in (scores, values)]
    k5_in = [t.clone().requires_grad_(True) for t in (pscores[0], pvalues[0], pscores[1], pvalues[1])]
    torch.cuda.synchronize()

    for fn in counts.values():
        fn.launches = 0
    results = {}
    for dt, (d, gk) in k1.items():
        out = masked_segment_sum(d, recv, nr, rmask, row_bounds=rb)
        (grad,) = torch.autograd.grad(out, d, gk)
        results[dt] = (out, grad)
    k2_out, k2_ml = ca.csr_softmax_spmm(*k2_in, seg, bounds, mask, stream_dtype="bf16")
    k2_grads = torch.autograd.grad(k2_out, k2_in, g_k2)
    k5_out, k5_ml = ca.csr_softmax_spmm_pair(k5_in[0], k5_in[1], pseg[0], pbounds[0], k5_in[2], k5_in[3],
                                             pseg[1], pbounds[1], *pmasks, stream_dtype="bf16")
    k5_grads = torch.autograd.grad(k5_out, k5_in, pg)
    fused = {}
    for dt, leaves in attn.items():
        tc = ca.gather_csr(seg, gather, bounds, mask) if dt == torch.bfloat16 else None
        out = ca.csr_sparse_attention(*leaves, seg, gather, bounds, mask, scale, tc, stream_dtype="bf16")
        fused[dt] = (out, torch.autograd.grad(out, leaves, g.to(dt)))
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in counts.items()}
    ones = ("csr_segment_sum_bf16", "csr_segment_sum_f16", "csr_segment_sum_backward_bf16",
            "csr_segment_sum_backward_f16", "csr_softmax_spmm_bf16_stream", "csr_softmax_spmm_backward",
            "csr_softmax_spmm_pair_bf16_stream", "csr_softmax_spmm_pair_backward", "csr_attention_f32_stream",
            "csr_attention_backward", "csr_attention_bf16_stream", "csr_attention_backward_bf16", "gather_csr")
    want = {key: int(key in ones) for key in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")

    # each output and gradient against its plain version (no launch)
    errs = {}
    with torch.no_grad():
        for dt, (out, grad) in results.items():
            d, gk = k1[dt]
            key = str(dt).replace("torch.", "")
            errs[f"k1_{key}_ulps"] = ulps(out, csr_segment_sum_reference(d, recv, nr, rmask))
            want_grad = csr_segment_sum_backward_reference(gk, recv, rb, rmask)
            if out.dtype != dt or not torch.equal(grad, want_grad) or errs[f"k1_{key}_ulps"] > K1_ULPS:
                raise AssertionError(f"{name}: masked_segment_sum on {dt} vs plain: "
                                     f"{errs[f'k1_{key}_ulps']} ulps, gradient bit-equal "
                                     f"{torch.equal(grad, want_grad)}")
        tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}
        gtol = {"rtol": cs.K3_GRAD_RTOL, "atol": cs.K3_GRAD_ATOL}
        checks = []
        s_r, v_r = (ca.stream_round(t) for t in (scores, values))
        want_out, want_ml = ca.csr_softmax_spmm_reference(s_r, v_r, seg, n, mask)
        checks += [("k2_out", k2_out, want_out, tol), ("k2_ml", k2_ml, want_ml, tol)]
        want_grads = ca.csr_softmax_spmm_backward_reference(scores, values, seg, k2_ml, k2_out, g_k2, mask)
        checks += [(f"k2_{x}", a, b, gtol) for x, a, b in zip(("dscores", "dvalues"), k2_grads, want_grads)]
        rounded = [ca.stream_round(t) for t in (pscores[0], pvalues[0], pscores[1], pvalues[1])]
        want_out, want_ml = ca.csr_softmax_spmm_pair_reference(rounded[0], rounded[1], pseg[0], rounded[2],
                                                               rounded[3], pseg[1], pn, *pmasks)
        checks += [("k5_out", k5_out, want_out, tol), ("k5_ml", k5_ml, want_ml, tol)]
        want_grads = ca.csr_softmax_spmm_pair_backward_reference(
            pscores[0], pvalues[0], pseg[0], pscores[1], pvalues[1], pseg[1], k5_ml, k5_out, pg, *pmasks)
        checks += [(f"k5_{x}", a, b, gtol) for x, a, b in zip(("dsa", "dva", "dsb", "dvb"), k5_grads, want_grads)]
        for dt, (out, grads) in fused.items():
            a, b, c = attn[dt]
            key = str(dt).replace("torch.", "")
            want_out, ml = ca.csr_attention_reference(a, b, c, seg, gather, n, mask, scale, stream_dtype="bf16")
            want_grads = ca.csr_attention_backward_reference(a, b, c, seg, gather, ml, out.detach(), g.to(dt),
                                                             mask, scale)
            if dt == torch.bfloat16:
                ftol = {"rtol": cs.BF16_KERNEL_RTOL, "atol": cs.BF16_KERNEL_ATOL}
                dv_atol = max(cs.BF16_KERNEL_ATOL, cs.BF16_DV_TERM * g.abs().max().item())
                gtols = (ftol, ftol, {"rtol": cs.BF16_KERNEL_RTOL, "atol": dv_atol})
            else:
                ftol, gtols = tol, (gtol,) * 3
            checks.append((f"fused_{key}_out", out, want_out, ftol))
            checks += [(f"fused_{key}_d{x}", p, r, t) for x, p, r, t in zip("qkv", grads, want_grads, gtols)]
        for label, got, want_t, t in checks:
            errs[label] = (got.float() - want_t.float()).abs().max().item()
            if not (torch.isfinite(got.float()).all()
                    and torch.allclose(got.float(), want_t.float(), **t)):
                raise AssertionError(f"{name}: {label} vs plain max_abs_err {errs[label]}")
    return {"launches": launches, "max_abs_err_vs_plain": errs,
            "shapes": {"masked_segment_sum": "flagship_batch_8x2048 (bf16 and f16)",
                       "csr_softmax_spmm": f"panels_csr_batch_8x2048, width {hidden}",
                       "csr_softmax_spmm_pair": f"mesh_16384_part0_of_4, width {hidden}",
                       "csr_sparse_attention": f"panels_csr_batch_8x2048, width {hidden} (f32 and bf16 q, k, v)"}}


def stream_phase(clock, counts, seed, epd_frame, cyl_batch, aneurysm_epd, tf_frame, tf_batch, aneurysm_csr):
    """Every check and timing of the phase, one line each, then the slice's
    path; returns ``({entry: [records]}, path record)``, the records in
    K1's, K2's, K5's and the fused entries' shape order (the 8 x 2,048
    batch, or K5's 16,384-node mesh, second)."""
    from chip_partition import mesh_graph

    cs = _cs()
    t0 = time.perf_counter()
    records = {}

    def emit(entry, record):
        records.setdefault(entry, []).append(record)
        clock.emit({"phase": "stream_dtypes", "name": entry, **record})

    for record in k1_geometry_cases(cyl_batch, seed + 30):
        clock.emit({"phase": "stream_dtypes", "name": "geometry", **record})
    for dt in (torch.bfloat16, torch.float16):
        key = SHORT[dt]
        hub = hub_row(dt)
        for i, (label, graph) in enumerate((("serving_frame", epd_frame), ("flagship_batch_8x2048", cyl_batch),
                                            ("aneurysm_epd_66560x524288", aneurysm_epd))):
            f, b = k1_16bit_case(label, graph, dt, seed + i)
            emit(f"csr_segment_sum_{key}", {**f, "hub_row": hub})
            emit(f"csr_segment_sum_bwd_{key}", b)
    for i, (label, graph, width) in enumerate((("transformer_serving_frame", tf_frame, cs.HIDDEN),
                                               ("panels_csr_batch_8x2048", tf_batch, cs.HIDDEN),
                                               ("aneurysm_csr_66560x524288", aneurysm_csr, 64))):
        emit("csr_softmax_spmm_bf16_stream", k2_stream_case(label, graph, width, seed + 10 + i))
    for record in k2_geometry_cases(tf_batch, seed + 50):
        clock.emit({"phase": "stream_dtypes", "name": "geometry", **record})
    mesh = mesh_graph("csr", seed + 601)
    for i, (label, graph, width) in enumerate((("serving_frame_2048_part0_of_4", tf_frame, cs.HIDDEN),
                                               ("mesh_16384_part0_of_4", mesh, cs.HIDDEN),
                                               ("aneurysm_csr_66560x524288_part0_of_4", aneurysm_csr, 64))):
        emit("csr_softmax_spmm_pair_bf16_stream", k5_stream_case(label, graph, width, seed + 13 + i))
    for record in k5_geometry_cases(mesh, seed + 40):
        clock.emit({"phase": "stream_dtypes", "name": "geometry", **record})
    for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for i, (label, graph, width) in enumerate((("transformer_serving_frame", tf_frame, cs.HIDDEN),
                                                   ("panels_csr_batch_8x2048", tf_batch, cs.HIDDEN),
                                                   ("aneurysm_csr_66560x524288", aneurysm_csr, 64))):
            emit(f"csr_attention_{key}_stream", fused_stream_case(label, graph, width, seed + 16 + i, dt))
    path = driven_path("stream_dtypes", counts, cyl_batch, tf_batch, mesh, seed + 20)
    clock.emit({"phase": "stream_dtypes", "name": "path", **path,
                "stream_dtypes_s": time.perf_counter() - t0})
    return records, path
