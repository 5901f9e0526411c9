"""Sparse graph attention over a sender-sorted (CSR) edge list: the
counterpart of ``graphphysics_tpu/ops/pallas_attention.py``.

``csr_sparse_attention`` (the JAX function of that name) is, per sender row
``n`` and head ``h`` over the real unmasked edges of ``n``'s range, the
softmax of ``scale * <q[n, h], k[j, h]>`` (``j = gather_idx[e]``) and its
weighted sum of ``v[j, h]``. It goes through ``csr_attention``, a
``torch.autograd.Function`` whose backward is ``csr_attention_backward``.
For CUDA tensors the two launch the hand-written Hopper kernels
``csrc/csr_attention.cu`` and ``csrc/csr_attention_bwd.cu`` (built with
``nvcc`` at first use): the gathers, the per-edge scores, the softmax and
the weighted sum in one pass, reading q, k and v as node rows, with no
edge-sized intermediate; the backward adds into ``dk`` and ``dv`` with
atomics. For CPU tensors they take ``csr_attention_reference`` (the gathers
and per-head dot as PyTorch ops, then ``csr_softmax_spmm_reference``) and
``csr_attention_backward_reference``. The kernels take q, k and v either as
contiguous ``[N, H, Dh]`` or as the ``(N, Dh, H)`` views the model's
``Attention`` passes (strides ``(D, 1, H)``), and give out and the
gradients in the same layout.

``csr_softmax_spmm`` is the TPU kernel's own function, the softmax + SpMM
of given per-edge ``scores [E, H]`` and ``values [E, D]``, plus the
online-softmax statistics ``ml = [m; l]`` (``[2H, N]``). Its backward is
``csr_softmax_spmm_backward`` (the JAX ``_bwd``: per node the
flash-attention ``delta = <out, g>`` per head, then per-edge math against
the saved ``(m, l)``). On CUDA they launch ``csrc/csr_softmax_spmm.cu`` and
``csrc/csr_softmax_spmm_bwd.cu``; on the CPU they take
``csr_softmax_spmm_reference`` and ``csr_softmax_spmm_backward_reference``.
No attention path of the models runs them: they are kept for split-edge
partitioned attention, whose scores span a local and a halo edge set.
Nothing but a tensor's device selects between a kernel and its plain
version.

The kernels read per-node ``[start, end)`` ranges of real edges
(``Graph.sender_bounds``, ``compute_row_bounds`` of the sorted senders)
instead of the TPU kernel's per-128-node block ranges;
``compute_block_bounds`` and ``compute_max_chunks_bounds`` are kept so tests
can hold the host helpers against the JAX ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from graphphysics_torch.ops import _native
from graphphysics_torch.ops.csr_segment import (
    accumulation_dtype,
    check_in_range,
    csr_segment_sum_reference,
)
from graphphysics_torch.ops.segment import segment_softmax

# Block sizes of the TPU kernel, kept for its host helpers (and the CSR
# padding's node multiple).
BLOCK_NODES = 128
BLOCK_EDGES = 512
SOURCE = "csr_softmax_spmm.cu"
BACKWARD_SOURCE = "csr_softmax_spmm_bwd.cu"
ATTENTION_SOURCE = "csr_attention.cu"
ATTENTION_BACKWARD_SOURCE = "csr_attention_bwd.cu"
# lanes serving one sender row in the fused kernels, in order of preference:
# the first whose geometry the kernels take for a width, head count and
# layout is used. On an H100 at the model's shapes (chip_smoke.py, PERF.md)
# the forward ran fastest with 8 or 16 lanes a row (fewer butterfly levels,
# and fewer lanes computing each head's exponentials), the backward with 32
# (its float4 atomics and registers grow with the columns a lane holds).
FORWARD_LANES = (8, 16, 32)
BACKWARD_LANES = (32, 16, 8)
EPS = 1e-16  # the epsilon of the forward's normalization
NEG = -1e30  # finite -inf stand-in, as the TPU kernel
MAX_WIDTH = 512  # the widest D the TPU kernel's defaults were tuned for


def compute_block_bounds(
    segments_sorted: np.ndarray,
    num_nodes: int,
    num_real_edges: Optional[int] = None,
    block_nodes: int = BLOCK_NODES,
) -> np.ndarray:
    """Per-node-block ``[start, end)`` edge ranges as ``[2, NB]`` int32,
    ends clamped to ``num_real_edges`` so trailing padding falls outside."""
    segments_sorted = np.asarray(segments_sorted)
    num_blocks = -(-num_nodes // block_nodes)
    bounds = np.arange(num_blocks + 1) * block_nodes
    offsets = np.searchsorted(segments_sorted, bounds[1:], side="left")
    starts = np.concatenate([[0], offsets[:-1]])
    ends = offsets
    if num_real_edges is not None:
        starts = np.minimum(starts, num_real_edges)
        ends = np.minimum(ends, num_real_edges)
    return np.stack([starts, ends]).astype(np.int32)


def compute_max_chunks_bounds(bounds: np.ndarray, block_edges: int = BLOCK_EDGES) -> int:
    """``block_edges``-aligned windows the busiest block's range needs."""
    starts, ends = np.asarray(bounds, np.int64)
    first = starts // block_edges
    last = -(-np.maximum(ends, starts + 1) // block_edges)
    return int(np.maximum(last - first, 1).max())


def csr_softmax_spmm_reference(
    scores: torch.Tensor,
    values: torch.Tensor,
    segments: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csr_softmax_spmm``, in f32 (f64 for f64
    inputs): the attention weights from ``segment_softmax``, their
    head-blocked products with ``values`` summed by a masked ``index_add_``,
    and the statistics of the unmasked scores. Rows without such edges give
    out 0, ``m = -1e30`` and ``l = 0``. Returns ``(out [N, D] in values'
    dtype, ml [2H, N])``. Differentiable by autograd in scores and values."""
    e, h = scores.shape
    d = values.shape[1]
    acc = accumulation_dtype(scores.dtype)
    s32 = scores.to(acc)
    attn = segment_softmax(s32, segments, num_nodes, mask=mask)  # [E, H]
    weighted = (values.to(acc).reshape(e, h, d // h) * attn[:, :, None]).reshape(e, d)
    out = csr_segment_sum_reference(weighted, segments, num_nodes, mask)
    seg = segments.to(torch.int64)
    s32 = s32.detach()
    if mask is not None:
        s32 = torch.where(mask[:, None], s32, torch.full((), NEG, dtype=acc, device=s32.device))
    m = torch.full((num_nodes, h), NEG, dtype=acc, device=s32.device)
    m = m.scatter_reduce(0, seg[:, None].expand(e, h), s32, "amax", include_self=True)
    p = torch.exp(s32 - m.index_select(0, seg))
    if mask is not None:
        p = torch.where(mask[:, None], p, torch.zeros((), dtype=acc, device=p.device))
    l = torch.zeros((num_nodes, h), dtype=acc, device=p.device).index_add_(0, seg, p)
    return out.to(values.dtype), torch.cat([m.t(), l.t()], dim=0).contiguous()


def csr_softmax_spmm_backward_reference(
    scores: torch.Tensor,
    values: torch.Tensor,
    segments: torch.Tensor,
    ml: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csr_softmax_spmm``'s backward, line by line
    the JAX ``_pack_node_side`` and ``_edge_grads``: per node the packed
    ``[m | l | delta | g]`` with ``delta = <out, g>`` per head, plus an
    all-zero row; per edge that row's gather (masked edges take the zero row
    and score -1e30, as ``csr_sparse_attention`` hands them to the JAX
    kernel), ``attn = exp(s - m) / (l + 1e-16)``,
    ``dvalues = attn * g`` and ``dscores = attn * (<values, g>_head - delta)``.
    Returns ``(dscores [E, H], dvalues [E, D])``, exactly 0 on masked edges."""
    e, h = scores.shape
    n, d = out.shape
    dh = d // h
    acc = accumulation_dtype(scores.dtype)
    g32 = g.to(acc)
    delta = (out.to(acc) * g32).reshape(n, h, dh).sum(-1)
    ml = ml.to(acc)
    pack = torch.cat([ml[:h].t(), ml[h:].t(), delta, g32], dim=1)
    pack = torch.cat([pack, pack.new_zeros((1, 3 * h + d))], dim=0)
    s = scores.to(acc)
    seg = segments.to(torch.int64)
    if mask is not None:
        s = torch.where(mask[:, None], s, torch.full((), NEG, dtype=acc, device=s.device))
        seg = torch.where(mask, seg, torch.full((), n, dtype=seg.dtype, device=seg.device))
    rows = pack.index_select(0, torch.clamp(seg, max=n))  # [E, 3H + D]
    m_e, l_e, delta_e, g_e = rows[:, :h], rows[:, h : 2 * h], rows[:, 2 * h : 3 * h], rows[:, 3 * h :]
    attn = torch.exp(s - m_e) / (l_e + EPS)  # [E, H]
    dvalues = (attn.repeat_interleave(dh, dim=1) * g_e).to(values.dtype)
    dattn = (values.to(acc) * g_e).reshape(e, h, dh).sum(-1)
    dscores = (attn * (dattn - delta_e)).to(scores.dtype)
    return dscores, dvalues


def _check_cuda_args(op, scores, values, segments, bounds, mask) -> None:
    def fail(msg):
        raise ValueError(f"{op}: {msg}")

    for name, t in (("scores", scores), ("values", values)):
        if t.dtype != torch.float32:
            fail(f"the CUDA kernel takes float32 {name}, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            fail(f"{name} must be a contiguous 2-D tensor, got {tuple(t.shape)}")
    e, h = scores.shape
    d = values.shape[1]
    if values.shape[0] != e:
        fail(f"values has {values.shape[0]} rows, scores {e}")
    if d == 0 or d % 32 or d > MAX_WIDTH:
        fail(f"width D={d} must be a positive multiple of 32, at most {MAX_WIDTH}")
    if h == 0 or d % h or (d // h) % (d // 32):
        fail(f"head_dim D/H = {d}/{h} must be a multiple of D/32 = {d // 32}")
    if values.data_ptr() % 16:
        fail("values must be 16-byte aligned")
    if segments.shape != (e,):
        fail(f"segments must be [{e}], got {tuple(segments.shape)}")
    if bounds.dim() != 2 or bounds.shape[0] != 2:
        fail(f"sender_bounds must be [2, N], got {tuple(bounds.shape)}")
    if bounds.dtype != torch.int32 or not bounds.is_contiguous():
        fail("sender_bounds must be contiguous int32")
    if mask is not None and (
        mask.shape != (e,) or mask.dtype != torch.bool or not mask.is_contiguous()
    ):
        fail(f"mask must be a contiguous bool [{e}] tensor")
    for name, t in (("values", values), ("segments", segments), ("sender_bounds", bounds), ("mask", mask)):
        if t is not None and t.device != scores.device:
            fail(f"{name} is on {t.device}, scores on {scores.device}")


def _launch(scores, values, bounds, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    fn = _native.function(SOURCE, "csr_softmax_spmm_f32", 6,
                          (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int))
    e, h = scores.shape
    d = values.shape[1]
    n = bounds.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=scores.device)
    ml = torch.empty((2 * h, n), dtype=torch.float32, device=scores.device)
    if n == 0:
        return out, ml
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = fn(
            scores.data_ptr(),
            values.data_ptr(),
            bounds.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(),
            ml.data_ptr(),
            n,
            e,
            h,
            d,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_softmax_spmm kernel launch failed: CUDA error {err}")
    csr_softmax_spmm.launches += 1
    return out, ml


def _launch_backward(scores, values, bounds, mask, ml, out, g) -> Tuple[torch.Tensor, torch.Tensor]:
    fn = _native.function(BACKWARD_SOURCE, "csr_softmax_spmm_bwd_f32", 9,
                          (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int))
    e, h = scores.shape
    d = values.shape[1]
    n = bounds.shape[1]
    dscores = torch.empty((e, h), dtype=torch.float32, device=scores.device)
    dvalues = torch.empty((e, d), dtype=torch.float32, device=scores.device)
    if e == 0:
        return dscores, dvalues
    if n == 0:
        return dscores.zero_(), dvalues.zero_()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = fn(
            scores.data_ptr(),
            values.data_ptr(),
            bounds.data_ptr(),
            None if mask is None else mask.data_ptr(),
            ml.data_ptr(),
            out.data_ptr(),
            g.data_ptr(),
            dscores.data_ptr(),
            dvalues.data_ptr(),
            n,
            e,
            h,
            d,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_softmax_spmm backward kernel launch failed: CUDA error {err}")
    csr_softmax_spmm_backward.launches += 1
    return dscores, dvalues


class _SoftmaxSpmm(torch.autograd.Function):
    """K2 forward, K3 backward (CUDA) or their plain versions (CPU)."""

    @staticmethod
    def forward(ctx, scores, values, segments, sender_bounds, mask):
        if scores.is_cuda:
            out, ml = _launch(scores, values, sender_bounds, mask)
        else:
            out, ml = csr_softmax_spmm_reference(
                scores, values, segments, sender_bounds.shape[1], mask
            )
        ctx.mark_non_differentiable(ml)
        ctx.save_for_backward(scores, values, segments, sender_bounds, mask, ml, out)
        return out, ml

    @staticmethod
    def backward(ctx, g, _g_ml):
        scores, values, segments, sender_bounds, mask, ml, out = ctx.saved_tensors
        dscores, dvalues = csr_softmax_spmm_backward(
            scores, values, segments, sender_bounds, ml, out, g, mask
        )
        return dscores, dvalues, None, None, None


def csr_softmax_spmm(
    scores: torch.Tensor,
    values: torch.Tensor,
    segments: torch.Tensor,
    sender_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment softmax of ``scores`` ([E, H]) and the weighted segment sum of
    the head-blocked ``values`` ([E, D], column c in head ``c // (D/H)``) by
    sender-sorted ``segments``, over ``N = sender_bounds.shape[1]`` rows;
    ``mask`` ([E] bool) drops edges anywhere. Returns
    ``(out [N, D], ml [2H, N])`` with ``ml = [m; l]``, the per-head running
    max and sum of exponentials (``-1e30`` and 0 for a row without edges,
    whose output is 0). Differentiable in ``scores`` and ``values`` through
    ``out`` (``ml`` is not differentiable): the backward is
    ``csr_softmax_spmm_backward``.

    The kernels read only the row ranges ``sender_bounds`` (per node,
    ``compute_row_bounds`` of the senders; ``Graph.sender_bounds``), so every
    unmasked edge must lie in its segment's range. A CUDA tensor launches the
    Hopper kernel (float32, D a multiple of 32 up to 512 with a head_dim that
    is a multiple of D/32) and adds one to ``csr_softmax_spmm.launches``; it
    trusts the layout (build graphs with ``pad_graph_csr_np``). A CPU tensor
    checks that precondition and takes ``csr_softmax_spmm_reference``."""
    if scores.is_cuda:
        _check_cuda_args("csr_softmax_spmm", scores, values, segments, sender_bounds, mask)
    else:
        check_in_range("csr_softmax_spmm", "sender", segments, sender_bounds, mask)
    return _SoftmaxSpmm.apply(scores, values, segments, sender_bounds, mask)


csr_softmax_spmm.launches = 0


def csr_softmax_spmm_backward(
    scores: torch.Tensor,
    values: torch.Tensor,
    segments: torch.Tensor,
    sender_bounds: torch.Tensor,
    ml: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dscores [E, H], dvalues [E, D])`` of
    ``csr_softmax_spmm``'s ``out`` with respect to its scores and values,
    from the forward's ``ml`` and ``out`` and the gradient ``g`` ([N, D]) of
    ``out``. Masked edges, edges outside every range and the edges of empty
    rows get exactly 0. A CUDA tensor launches the Hopper kernel (float32,
    the forward's widths; every edge row is written, which needs the ranges
    ascending and disjoint, as the padding lays them out) and adds one to
    ``csr_softmax_spmm_backward.launches``; a CPU tensor takes
    ``csr_softmax_spmm_backward_reference``."""
    if not scores.is_cuda:
        return csr_softmax_spmm_backward_reference(scores, values, segments, ml, out, g, mask)
    op = "csr_softmax_spmm_backward"
    _check_cuda_args(op, scores, values, segments, sender_bounds, mask)
    g = g.contiguous()
    n, h, d = sender_bounds.shape[1], scores.shape[1], values.shape[1]
    for name, t, shape in (("out", out, (n, d)), ("g", g, (n, d)), ("ml", ml, (2 * h, n))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != scores.device or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned on {scores.device}")
    return _launch_backward(scores, values, sender_bounds, mask, ml, out, g)


csr_softmax_spmm_backward.launches = 0


def csr_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csr_attention``: q gathered at
    ``segments``, k and v at ``gather_idx``, the per-head dot times ``scale``
    in f32 (f64 for f64 inputs), masked edges at score ``-1e30``, then
    ``csr_softmax_spmm_reference``. Returns ``(out [N, H, Dh] contiguous in
    q's dtype, ml [2H, N])``. Differentiable by autograd in q, k and v."""
    n, h, dh = q.shape
    d = h * dh
    acc = accumulation_dtype(q.dtype)
    q_e = q.reshape(n, d).index_select(0, segments)
    k_e = k.reshape(n, d).index_select(0, gather_idx)
    v_e = v.reshape(n, d).index_select(0, gather_idx)
    e = q_e.shape[0]
    scores = (q_e.to(acc) * k_e.to(acc)).reshape(e, h, dh).sum(dim=-1) * scale
    if mask is not None:
        scores = torch.where(mask[:, None], scores, torch.full((), NEG, dtype=acc, device=scores.device))
    out, ml = csr_softmax_spmm_reference(scores, v_e.to(acc), segments, num_nodes, mask)
    return out.reshape(n, h, dh).to(q.dtype), ml


def csr_attention_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    ml: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csr_attention``'s backward, formula by
    formula the kernel's: per node ``delta = <out, g>`` per head; per real
    unmasked edge ``e`` (node ``n = segments[e]``, ``j = gather_idx[e]``) the
    score ``s = scale * <q[n], k[j]>``, ``attn = exp(s - m[n]) / (l[n] +
    1e-16)`` and ``ds = attn * (<v[j], g[n]> - delta[n])``; then ``dq[n] +=
    ds * scale * k[j]``, ``dk[j] += ds * scale * q[n]`` and ``dv[j] += attn *
    g[n]`` by ``index_add_`` in f32 (f64 for f64 inputs). Masked edges add
    nothing. Returns ``(dq, dk, dv)``, ``[N, H, Dh]`` in q's dtype."""
    n, h, dh = q.shape
    acc = accumulation_dtype(q.dtype)
    q32, k32, v32, o32, g32 = (t.to(acc) for t in (q, k, v, out, g))
    delta = (o32 * g32).sum(dim=-1)  # [N, H]
    seg = segments.to(torch.int64)
    idx = gather_idx.to(torch.int64)
    q_e, g_e = q32.index_select(0, seg), g32.index_select(0, seg)  # [E, H, Dh]
    k_e, v_e = k32.index_select(0, idx), v32.index_select(0, idx)
    s = (q_e * k_e).sum(dim=-1) * scale  # [E, H]
    ml = ml.to(acc)
    m_e, l_e = ml[:h].t().index_select(0, seg), ml[h:].t().index_select(0, seg)
    attn = torch.exp(s - m_e) / (l_e + EPS)
    if mask is not None:
        attn = torch.where(mask[:, None], attn, torch.zeros((), dtype=acc, device=attn.device))
    ds = attn * ((v_e * g_e).sum(dim=-1) - delta.index_select(0, seg))
    zeros = torch.zeros((n, h, dh), dtype=acc, device=q.device)
    dq = zeros.clone().index_add_(0, seg, ds[:, :, None] * scale * k_e)
    dk = zeros.clone().index_add_(0, idx, ds[:, :, None] * scale * q_e)
    dv = zeros.index_add_(0, idx, attn[:, :, None] * g_e)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _is_interleaved(t: torch.Tensor) -> Optional[bool]:
    """False for a contiguous ``[N, H, Dh]`` tensor, True for the transpose
    of a contiguous ``(N, Dh, H)`` one (strides ``(D, 1, H)``), None for any
    other layout."""
    if t.is_contiguous():
        return False
    if t.transpose(1, 2).is_contiguous():
        return True
    return None


def _in_layout(t: torch.Tensor, interleaved: bool) -> torch.Tensor:
    """``t`` with the memory layout the kernels were given (a copy only if
    it has another)."""
    if interleaved:
        return t if t.transpose(1, 2).is_contiguous() else t.transpose(1, 2).contiguous().transpose(1, 2)
    return t.contiguous()


def _as_heads(flat: torch.Tensor, h: int, interleaved: bool) -> torch.Tensor:
    """``[N, D]`` node rows as ``[N, H, Dh]`` in the kernels' layout."""
    n, d = flat.shape
    return flat.view(n, d // h, h).transpose(1, 2) if interleaved else flat.view(n, h, d // h)


def _geometry_ok(lanes: int, width: int, heads: int, interleaved: bool) -> bool:
    """Whether the fused kernels take ``lanes`` lanes a row for this width,
    head count and layout: ``make_geometry`` in ``csrc/csr_attention.cuh``."""
    def pow2(x):
        return x > 0 and x & (x - 1) == 0

    if width % lanes or width % heads:
        return False
    cols, head_dim = width // lanes, width // heads
    if cols > 16:
        return False
    if not interleaved:
        return head_dim % cols == 0 and pow2(head_dim // cols)
    if cols % heads == 0:
        return pow2(heads)
    if heads % cols == 0:
        return pow2(cols) and pow2(heads // cols) and heads // cols <= lanes
    return False


def lanes_per_row(width: int, heads: int, interleaved: bool, backward: bool = False) -> Optional[int]:
    """The lanes a sender row gets in the fused forward (or ``backward``)
    kernel: the first of ``FORWARD_LANES`` (``BACKWARD_LANES``) whose
    geometry it takes, None if none is."""
    order = BACKWARD_LANES if backward else FORWARD_LANES
    return next((g for g in order if _geometry_ok(g, width, heads, interleaved)), None)


def _check_attention_args(op, q, k, v, gather_idx, bounds, mask) -> bool:
    """Raise on what the fused kernels do not take; returns the layout
    (True: interleaved)."""
    def fail(msg):
        raise ValueError(f"{op}: {msg}")

    if q.dim() != 3:
        fail(f"q must be [N, H, Dh], got {tuple(q.shape)}")
    n, h, dh = q.shape
    d = h * dh
    layouts = set()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            fail(f"the CUDA kernel takes float32 {name}, got {t.dtype}")
        if t.shape != q.shape:
            fail(f"{name} is {tuple(t.shape)}, q {tuple(q.shape)}")
        if t.device != q.device:
            fail(f"{name} is on {t.device}, q on {q.device}")
        layout = _is_interleaved(t)
        if layout is None:
            fail(f"{name} must be a contiguous [N, H, Dh] tensor or the [N, H, Dh] transpose of a "
                 f"contiguous (N, Dh, H) one, got strides {t.stride()}")
        layouts.add(layout)
        if t.data_ptr() % 16:
            fail(f"{name} must be 16-byte aligned")
    if len(layouts) != 1:
        fail("q, k and v must share one layout")
    if d == 0 or d % 32 or d > MAX_WIDTH:
        fail(f"width D={d} must be a positive multiple of 32, at most {MAX_WIDTH}")
    if dh % (d // 32):
        fail(f"head_dim D/H = {d}/{h} must be a multiple of D/32 = {d // 32}")
    interleaved = layouts.pop()
    if lanes_per_row(d, h, interleaved) is None:
        fail(f"no lane geometry takes {h} heads of {dh} in this layout")
    e = gather_idx.shape[0]
    if gather_idx.dim() != 1 or gather_idx.dtype != torch.int32 or not gather_idx.is_contiguous():
        fail("gather_idx must be a contiguous int32 [E] tensor")
    if bounds.dim() != 2 or bounds.shape != (2, n):
        fail(f"sender_bounds must be [2, {n}], got {tuple(bounds.shape)}")
    if bounds.dtype != torch.int32 or not bounds.is_contiguous():
        fail("sender_bounds must be contiguous int32")
    if mask is not None and (
        mask.shape != (e,) or mask.dtype != torch.bool or not mask.is_contiguous()
    ):
        fail(f"mask must be a contiguous bool [{e}] tensor")
    for name, t in (("gather_idx", gather_idx), ("sender_bounds", bounds), ("mask", mask)):
        if t is not None and t.device != q.device:
            fail(f"{name} is on {t.device}, q on {q.device}")
    return interleaved


def _launch_attention(q, k, v, gather_idx, bounds, mask, scale, interleaved, lanes=None):
    fn = _native.function(ATTENTION_SOURCE, "csr_attention_f32", 8,
                          (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float))
    n, h, dh = q.shape
    d = h * dh
    lanes = lanes_per_row(d, h, interleaved) if lanes is None else lanes
    out = _as_heads(torch.empty((n, d), dtype=torch.float32, device=q.device), h, interleaved)
    ml = torch.empty((2 * h, n), dtype=torch.float32, device=q.device)
    if n == 0:
        return out, ml
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gather_idx.data_ptr(), bounds.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), ml.data_ptr(),
            n, gather_idx.shape[0], h, d, int(interleaved), lanes, scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_attention kernel launch failed: CUDA error {err}")
    csr_attention.launches += 1
    return out, ml


def _launch_attention_backward(q, k, v, gather_idx, bounds, mask, ml, out, g, scale, interleaved,
                               lanes=None):
    fn = _native.function(ATTENTION_BACKWARD_SOURCE, "csr_attention_bwd_f32", 12,
                          (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float))
    n, h, dh = q.shape
    d = h * dh
    lanes = lanes_per_row(d, h, interleaved, backward=True) if lanes is None else lanes
    dq = _as_heads(torch.empty((n, d), dtype=torch.float32, device=q.device), h, interleaved)
    dkv = torch.zeros((2, n, d), dtype=torch.float32, device=q.device)  # one memset for both
    dk, dv = (_as_heads(t, h, interleaved) for t in dkv.unbind(0))
    if n == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gather_idx.data_ptr(), bounds.data_ptr(),
            None if mask is None else mask.data_ptr(), ml.data_ptr(), out.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            n, gather_idx.shape[0], h, d, int(interleaved), lanes, scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_attention backward kernel launch failed: CUDA error {err}")
    csr_attention_backward.launches += 1
    return dq, dk, dv


class _CsrAttention(torch.autograd.Function):
    """The fused attention forward and backward kernels (CUDA) or their
    plain versions (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, segments, gather_idx, sender_bounds, mask, scale):
        if q.is_cuda:
            interleaved = _check_attention_args("csr_attention", q, k, v, gather_idx, sender_bounds, mask)
            out, ml = _launch_attention(q, k, v, gather_idx, sender_bounds, mask, scale, interleaved)
        else:
            out, ml = csr_attention_reference(q, k, v, segments, gather_idx, sender_bounds.shape[1],
                                              mask, scale)
        ctx.mark_non_differentiable(ml)
        ctx.save_for_backward(q, k, v, segments, gather_idx, sender_bounds, mask, ml, out)
        ctx.scale = scale
        return out, ml

    @staticmethod
    def backward(ctx, g, _g_ml):
        q, k, v, segments, gather_idx, sender_bounds, mask, ml, out = ctx.saved_tensors
        grads = csr_attention_backward(q, k, v, segments, gather_idx, sender_bounds, ml, out, g,
                                       mask, ctx.scale)
        return (*grads, None, None, None, None, None)


def csr_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    sender_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse attention of ``csr_sparse_attention``, also returning the
    online-softmax statistics: ``(out [N, H, Dh], ml [2H, N])`` with ``ml =
    [m; l]`` per head (``-1e30`` and 0 for a row without edges, whose output
    is 0). Differentiable in q, k and v through ``out``; the backward is
    ``csr_attention_backward``.

    A CUDA tensor launches the Hopper kernel and adds one to
    ``csr_attention.launches``: float32 q, k, v of one layout (contiguous
    ``[N, H, Dh]``, or the transpose of a contiguous ``(N, Dh, H)``; out
    comes in the same layout), D a multiple of 32 up to 512 with a head_dim
    that is a multiple of D/32, 16-byte aligned, int32 ``gather_idx`` and
    ``sender_bounds``; it raises on anything else and trusts the edge layout
    (every unmasked edge in its sender's range, gather indices in
    ``[0, N)``: build graphs with ``pad_graph_csr_np``). The segment ids are
    not read on the card: the ranges carry them. A CPU tensor checks the
    layout and takes ``csr_attention_reference``."""
    if not q.is_cuda:
        check_in_range("csr_attention", "sender", segments, sender_bounds, mask)
    return _CsrAttention.apply(q, k, v, segments, gather_idx, sender_bounds, mask, float(scale))


csr_attention.launches = 0


def csr_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    sender_bounds: torch.Tensor,
    ml: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of ``csr_attention``'s ``out`` from
    the forward's ``ml`` and ``out`` and the gradient ``g`` of ``out``.
    Masked edges and rows without edges add nothing. A CUDA tensor launches
    the Hopper kernel (the forward's arguments; ``g`` is brought into their
    layout, ``dk`` and ``dv`` are summed with atomics, so their order of
    summation varies from run to run) and adds one to
    ``csr_attention_backward.launches``; a CPU tensor takes
    ``csr_attention_backward_reference``."""
    if not q.is_cuda:
        return csr_attention_backward_reference(q, k, v, segments, gather_idx, ml, out, g, mask, scale)
    op = "csr_attention_backward"
    interleaved = _check_attention_args(op, q, k, v, gather_idx, sender_bounds, mask)
    n, h, _ = q.shape
    g = _in_layout(g, interleaved)
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != torch.float32 or _is_interleaved(t) is not interleaved:
            raise ValueError(f"{op}: {name} must be float32 {tuple(q.shape)} in q's layout, got "
                             f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
        if t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned on {q.device}")
    if ml.shape != (2 * h, n) or ml.dtype != torch.float32 or not ml.is_contiguous():
        raise ValueError(f"{op}: ml must be a contiguous float32 {(2 * h, n)}")
    return _launch_attention_backward(q, k, v, gather_idx, sender_bounds, mask, ml, out, g,
                                      float(scale), interleaved)


csr_attention_backward.launches = 0


def csr_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    sender_bounds: torch.Tensor,
    edge_mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """Sparse graph attention on a CSR edge list: queries at ``segments``
    (ascending; the softmax side), keys and values at ``gather_idx``. With
    edges sorted by sender this is the reference's COO convention. ``q``,
    ``k``, ``v`` are ``[N, H, Dh]``; returns ``[N, H, Dh]`` in q's dtype.

    The gathers, the per-head dot times ``scale``, the softmax and the
    weighted sum are ``csr_attention``: on CUDA one fused kernel forward and
    one backward, reading q, k and v in the layout given (contiguous, or the
    ``(N, Dh, H)`` views of the model's ``Attention``; out comes in the same
    one). Masked edges drop out. Differentiable in q, k and v."""
    out, _ = csr_attention(q, k, v, segments, gather_idx, sender_bounds, edge_mask, scale)
    return out
