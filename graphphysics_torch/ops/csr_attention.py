"""Sparse graph attention over a sender-sorted (CSR) edge list: the
counterpart of ``graphphysics_tpu/ops/pallas_attention.py``.

``csr_sparse_attention`` (the JAX function of that name) is, per sender row
``n`` and head ``h`` over the real unmasked edges of ``n``'s range, the
softmax of ``scale * <q[n, h], k[j, h]>`` (``j = gather_idx[e]``) and its
weighted sum of ``v[j, h]``. It goes through ``csr_attention``, whose
backward is ``csr_attention_backward``. Every kernel entry of this module
is a ``torch.library`` op of the ``graphphysics_torch`` namespace
(``torch.ops.graphphysics_torch.csr_attention`` and so on) with a CUDA
implementation (the kernel), a CPU one (the plain version) and a fake one
(shapes and dtypes, which ``torch.export`` traces through); a
``torch.autograd.Function`` calls each forward op and, for its gradient,
the backward op.
For CUDA tensors the two launch hand-written Hopper kernels (built with
``nvcc`` at first use): the gathers, the per-edge scores, the softmax and
the weighted sum in one pass, reading q, k and v as node rows, with no
edge-sized intermediate. float32 q, k, v take ``csrc/csr_attention.cu`` and
``csrc/csr_attention_bwd.cu`` (entries ``csr_attention_f32``,
``csr_attention_bwd_f32``; the backward adds into ``dk`` and ``dv`` with
atomics). They take every width ``D <= MAX_WIDTH`` and head count ``H``
dividing it: the widths a lane count splits into power-of-two head partials
take the fast lane geometries, every other one the word geometry
(``word_geometry``, ``csrc/attention_words.cuh``: one word of columns a
lane, per-head partials reduced by shuffles to one head a lane, which
computes that head's softmax) where its lanes hold the row, else the general
geometry (a masked column tail and per-head sums through shared memory),
another instantiation of the same kernels; the f32 entries count their
launches by geometry on ``csr_attention.geometries`` and
``csr_attention_backward.geometries``. bfloat16 q, k, v (the bf16 model's) take
``csrc/csr_attention_bf16.cu`` and ``csrc/csr_attention_bwd_bf16.cu``
(``csr_attention_bf16``, ``csr_attention_bwd_bf16``), kernels of their own:
16-byte lanes of 8 bf16 columns where the width and alignment allow
(``bf16_geometry``), else the word geometry of
``csrc/csr_attention_bf16_words.cu`` (``bf16_word_geometry``: one word of 8
or 4 bf16 columns a lane, ``attention_words.cuh``'s head sums) where its
lanes hold the row, else the general geometry; the launches count by
geometry on ``csr_attention.bf16.geometries`` (and the stream's) and
``csr_attention_backward.bf16.geometries``. The bf16 backward has no
atomics, in two parts, by sender rows (dq and each edge's softmax
weight and score gradient) and by gather rows over the transposed CSR of
``gather_csr`` (dk and dv summed in a fixed order: the same bits every
run). bf16 rows are read as bf16, computed on in f32 and the outputs
rounded to bf16 once, each dv term rounded to bf16 before it is summed;
``ml`` stays f32. For CPU tensors they take ``csr_attention_reference``
(the gathers and per-head dot as PyTorch ops, then
``csr_softmax_spmm_reference``) and ``csr_attention_backward_reference``,
which round at the same places, the JAX package's. The kernels take q, k
and v either as contiguous ``[N, H, Dh]`` or as the ``(N, Dh, H)`` views
the model's ``Attention`` passes (strides ``(D, 1, H)``), and give out and
the gradients in the same layout.

``csr_softmax_spmm`` is the TPU kernel's own function, the softmax + SpMM
of given per-edge ``scores [E, H]`` and ``values [E, D]``, plus the
online-softmax statistics ``ml = [m; l]`` (``[2H, N]``). Its backward is
``csr_softmax_spmm_backward`` (the JAX ``_bwd``: per node the
flash-attention ``delta = <out, g>`` per head, then per-edge math against
the saved ``(m, l)``). On CUDA they launch ``csrc/csr_softmax_spmm.cu``
and ``csrc/csr_softmax_spmm_bwd.cu`` at every ``D <= MAX_WIDTH`` with
``D % H == 0``: the forward in 16-byte words of 4 columns of one head a
lane, 8 edges in flight, where a head is 4k wide and D <= 128
(``softmax_spmm_geometry``), else both in D/32 adjacent columns a lane
where the width and alignment allow, else in the general geometry of
``csrc/softmax_general.cuh``, K5's, lane j the columns j, j + 32, ...
(``softmax_spmm_columns``); on the CPU they take
``csr_softmax_spmm_reference`` and ``csr_softmax_spmm_backward_reference``.
The unsplit partitioned attention runs them, segmenting by receivers
(``ops.attention``). ``csr_softmax_spmm_pair`` (K5) is the same function
over the union of two edge sets that share the rows, each with its own
ranges: split-edge partitioned attention's local and halo edges. On CUDA
it is one hand-written kernel forward and one backward
(``csrc/csr_softmax_spmm_pair.cu``), which walk each row's two ranges in
turn; on the CPU ``csr_softmax_spmm_pair_reference`` and
``csr_softmax_spmm_pair_backward_reference``, line by line the JAX
``_pair_impl`` (two softmax + SpMM partials and the merge of their
``(m, l)``) and ``_pair_bwd``. Nothing but a tensor's device selects
between a kernel and its plain version.

``csr_softmax_spmm``, ``csr_softmax_spmm_pair``, ``csr_attention`` and
``csr_sparse_attention`` take JAX's ``stream_dtype``: ``"f32"`` (the
default), or ``"bf16"``, the TPU kernel's bf16 stream, whose result is the
f32 function of scores and values rounded to bf16 (``stream_round``). On
CUDA each launches a stream entry of its kernel (``*_bf16_stream``,
``csr_attention_{f32,bf16}_stream``) counted apart; the gradients are the
existing backward entries' on the unrounded inputs with the stream pass's
``ml`` and ``out``, which is JAX's.

The kernels read per-node ``[start, end)`` ranges of real edges
(``compute_row_bounds`` of the sorted segment ids: ``Graph.sender_bounds``
for the models' attention, a partitioned part's ``row_bounds`` and
``halo_row_bounds`` for the partitioned one)
instead of the TPU kernel's per-128-node block ranges;
``compute_block_bounds`` and ``compute_max_chunks_bounds`` are kept so tests
can hold the host helpers against the JAX ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from graphphysics_torch.ops import _native
from graphphysics_torch.ops.csr_segment import (
    EDGE_GROUP,
    F32_WORD_COLUMNS,
    WARP,
    LaunchCount,
    SumGeometry,
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
PAIR_SOURCE = "csr_softmax_spmm_pair.cu"
ATTENTION_SOURCE = "csr_attention.cu"
ATTENTION_BACKWARD_SOURCE = "csr_attention_bwd.cu"
BF16_ATTENTION_SOURCE = "csr_attention_bf16.cu"
BF16_ATTENTION_BACKWARD_SOURCE = "csr_attention_bwd_bf16.cu"
BF16_WORDS_SOURCE = "csr_attention_bf16_words.cu"  # the bf16 entries' word geometry, both directions
# lanes serving one sender row in the fused kernels' fast geometries, in
# order of preference: the first whose fast geometry the kernels take for a
# width, head count and layout is used. On an H100 at the model's shapes
# (chip_smoke.py, PERF.md) the forward ran fastest with 8 or 16 lanes a row
# (fewer butterfly levels, and fewer lanes computing each head's
# exponentials), the backward with 32 (its float4 atomics and registers grow
# with the columns a lane holds).
FORWARD_LANES = (8, 16, 32)
BACKWARD_LANES = (32, 16, 8)
MAX_COLUMNS = 16  # the most columns a lane holds (csrc/csr_attention.cuh)
# a width without a fast geometry takes the word geometry where it applies
# (word_geometry, csrc/attention_words.cuh): W consecutive columns a lane,
# one word of the first of WORD_COLUMNS dividing D; a row's lanes D / W
# rounded up to a power of two and to the power of two at least H, at most
# WARP; at most MAX_PARTIALS heads.
WORD_COLUMNS = (4, 2, 1)
MAX_PARTIALS = 16
# any other width takes the general geometry with the fewest lanes that give
# each at most this many columns (32 lanes past 96 wide). On an H100 at the
# panels batch both general kernels ran fastest with 3 columns a lane: each
# column is a shared-memory write per edge and its own exponentials
# (chip_smoke.py kernel-width phases, PERF.md).
GENERAL_COLUMNS = 3
# the bf16 kernels' 16-byte geometry: bf16 columns a lane (one or two
# 16-byte loads a row), in order of preference, and the lane counts it
# takes. The forward prefers 8 columns a lane (16 lanes a row at D = 128),
# the backward 16 (8 lanes): its parts do more per edge, and half the
# lanes a row halve the threads the rows take (chosen from trial builds on
# an H100).
BF16_COLUMNS = (8, 16)
BF16_BACKWARD_COLUMNS = (16, 8)
BF16_LANES = (4, 8, 16, 32)
# a width without the 16-byte geometry takes the bf16 word geometry where
# its lanes hold the row (bf16_word_geometry, csrc/attention_words.cuh): one
# word of 8 bf16 columns (16 bytes) where D % 8 == 0 and every row base is
# VECTOR_ALIGNMENT-byte aligned, else of 4 (8 bytes; bf16 rows are 8-byte
# aligned, D % 4 == 0); any other width keeps the general geometry
BF16_WORD_COLUMNS = (8, 4)
VECTOR_ALIGNMENT = 16  # bytes of a row base the 16-byte geometry needs
EPS = 1e-16  # the epsilon of the forward's normalization
NEG = -1e30  # finite -inf stand-in, as the TPU kernel
MAX_WIDTH = 512  # the widest D the TPU kernel's defaults were tuned for
# the TPU kernel's stream modes: "f32", or "bf16" (scores and values rounded
# to bf16 before the softmax + SpMM, which computes in f32 from them)
STREAM_DTYPES = ("f32", "bf16")


def check_stream_dtype(stream_dtype: str) -> bool:
    """Raise ``ValueError`` (JAX's message) on an unknown stream mode;
    returns whether it is the bf16 stream."""
    if stream_dtype not in STREAM_DTYPES:
        raise ValueError(f"unknown stream_dtype {stream_dtype!r}")
    return stream_dtype == "bf16"


def stream_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even) and back to its dtype: what
    the bf16 stream's kernels read, as the plain versions see it."""
    return t.to(torch.bfloat16).to(t.dtype)


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
    if h == 0 or d == 0 or d > MAX_WIDTH or d % h:
        fail(f"width D={d} must be at most {MAX_WIDTH} and a multiple of H={h}")
    if segments.shape != (e,):
        fail(f"segments must be [{e}], got {tuple(segments.shape)}")
    if bounds.dim() != 2 or bounds.shape[0] != 2:
        fail(f"bounds must be [2, N], got {tuple(bounds.shape)}")
    if bounds.dtype != torch.int32 or not bounds.is_contiguous():
        fail("bounds must be contiguous int32")
    if mask is not None and (
        mask.shape != (e,) or mask.dtype != torch.bool or not mask.is_contiguous()
    ):
        fail(f"mask must be a contiguous bool [{e}] tensor")
    for name, t in (("values", values), ("segments", segments), ("bounds", bounds), ("mask", mask)):
        if t is not None and t.device != scores.device:
            fail(f"{name} is on {t.device}, scores on {scores.device}")


def _launch(scores, values, bounds, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's entry of the inputs' dtype: float32, or bfloat16, the bf16
    stream's entry (scores and values rounded by the caller)."""
    bf16 = scores.dtype == torch.bfloat16
    entry, counter = (("csr_softmax_spmm_bf16_stream", csr_softmax_spmm.bf16_stream) if bf16
                      else ("csr_softmax_spmm_f32", csr_softmax_spmm))
    fn = _native.function(SOURCE, entry, 6,
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
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    counter.launches += 1
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


def _softmax_spmm_cpu(scores, values, segments, bounds, mask, stream_dtype="f32"):
    if check_stream_dtype(stream_dtype):
        scores, values = stream_round(scores), stream_round(values)
    check_in_range("csr_softmax_spmm", "sender", segments, bounds, mask)
    return csr_softmax_spmm_reference(scores, values, segments, bounds.shape[1], mask)


def _softmax_spmm_cuda(scores, values, segments, bounds, mask, stream_dtype="f32"):
    bf16_stream = check_stream_dtype(stream_dtype)
    _check_cuda_args("csr_softmax_spmm", scores, values, segments, bounds, mask)
    if bf16_stream:  # one cast each, as JAX's packing (pallas_attention.py:287-302)
        scores, values = scores.to(torch.bfloat16), values.to(torch.bfloat16)
    return _launch(scores, values, bounds, mask)


def _softmax_spmm_fake(scores, values, segments, bounds, mask, stream_dtype="f32"):
    n, h = bounds.shape[1], scores.shape[1]
    return (values.new_empty((n, values.shape[1])),
            scores.new_empty((2 * h, n), dtype=accumulation_dtype(scores.dtype)))


def _softmax_spmm_backward_cpu(scores, values, segments, bounds, ml, out, g, mask):
    return csr_softmax_spmm_backward_reference(scores, values, segments, ml, out, g, mask)


def _softmax_spmm_backward_cuda(scores, values, segments, bounds, ml, out, g, mask):
    op = "csr_softmax_spmm_backward"
    _check_cuda_args(op, scores, values, segments, bounds, mask)
    g = g.contiguous()
    n, h, d = bounds.shape[1], scores.shape[1], values.shape[1]
    for name, t, shape in (("out", out, (n, d)), ("g", g, (n, d)), ("ml", ml, (2 * h, n))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != scores.device or t.data_ptr() % 16:
            raise ValueError(f"{op}: {name} must be 16-byte aligned on {scores.device}")
    return _launch_backward(scores, values, bounds, mask, ml, out, g)


def _softmax_spmm_backward_fake(scores, values, segments, bounds, ml, out, g, mask):
    return torch.empty_like(scores), torch.empty_like(values)


_softmax_spmm_op = _native.register_op(
    "csr_softmax_spmm",
    "(Tensor scores, Tensor values, Tensor segments, Tensor bounds, Tensor? mask, "
    "str stream_dtype=\"f32\") -> (Tensor, Tensor)",
    _softmax_spmm_cpu, _softmax_spmm_cuda, _softmax_spmm_fake)
_softmax_spmm_backward_op = _native.register_op(
    "csr_softmax_spmm_backward",
    "(Tensor scores, Tensor values, Tensor segments, Tensor bounds, Tensor ml, Tensor out, Tensor g, "
    "Tensor? mask) -> (Tensor, Tensor)",
    _softmax_spmm_backward_cpu, _softmax_spmm_backward_cuda, _softmax_spmm_backward_fake)


class _SoftmaxSpmm(torch.autograd.Function):
    """K2 forward, K3 backward, through their operators."""

    @staticmethod
    def forward(ctx, scores, values, segments, bounds, mask, stream_dtype):
        out, ml = _softmax_spmm_op(scores, values, segments, bounds, mask, stream_dtype)
        ctx.mark_non_differentiable(ml)
        # the unrounded inputs, with the stream pass's ml and out: JAX's _fwd
        ctx.save_for_backward(scores, values, segments, bounds, mask, ml, out)
        return out, ml

    @staticmethod
    def backward(ctx, g, _g_ml):
        scores, values, segments, bounds, mask, ml, out = ctx.saved_tensors
        dscores, dvalues = csr_softmax_spmm_backward(scores, values, segments, bounds, ml, out, g, mask)
        return dscores, dvalues, None, None, None, None


def csr_softmax_spmm(
    scores: torch.Tensor,
    values: torch.Tensor,
    segments: torch.Tensor,
    bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    stream_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment softmax of ``scores`` ([E, H]) and the weighted segment sum of
    the head-blocked ``values`` ([E, D], column c in head ``c // (D/H)``) by
    sorted ``segments``, over ``N = bounds.shape[1]`` rows;
    ``mask`` ([E] bool) drops edges anywhere. Returns
    ``(out [N, D], ml [2H, N])`` with ``ml = [m; l]``, the per-head running
    max and sum of exponentials (``-1e30`` and 0 for a row without edges,
    whose output is 0). Differentiable in ``scores`` and ``values`` through
    ``out`` (``ml`` is not differentiable): the backward is
    ``csr_softmax_spmm_backward``. The op
    ``torch.ops.graphphysics_torch.csr_softmax_spmm``.

    The kernels read only the row ranges ``bounds`` (per node,
    ``compute_row_bounds`` of the sorted ``segments``: the senders'
    ``Graph.sender_bounds``, or a partitioned part's receiver-sorted
    ``row_bounds``), so every unmasked edge must lie in its segment's
    range. A CUDA tensor launches the
    Hopper kernel (float32, D up to 512 and a multiple of H, any alignment;
    in the geometry ``softmax_spmm_geometry`` and ``softmax_spmm_columns``
    give) and adds one to
    ``csr_softmax_spmm.launches``; it trusts the layout (build graphs with
    ``pad_graph_csr_np``). A CPU tensor
    checks that precondition and takes ``csr_softmax_spmm_reference``.

    ``stream_dtype="bf16"`` is the TPU kernel's bf16 stream: the scores and
    values are rounded to bf16 (one cast each) and the softmax + SpMM
    computes in f32 from the rounded values; ``out`` keeps the values'
    dtype and ``ml`` is f32. On CUDA it launches the stream entry (same
    shapes, float32 inputs) and adds one to
    ``csr_softmax_spmm.bf16_stream.launches``; on the CPU the plain version
    takes the rounded inputs. The gradient is the f32 backward's on the
    unrounded inputs with the stream pass's ``ml`` and ``out``, as JAX's.
    Any other ``stream_dtype`` raises ``ValueError``."""
    return _SoftmaxSpmm.apply(scores, values, segments, bounds, mask, stream_dtype)


csr_softmax_spmm.launches = 0
csr_softmax_spmm.bf16_stream = LaunchCount()


def csr_softmax_spmm_backward(
    scores: torch.Tensor,
    values: torch.Tensor,
    segments: torch.Tensor,
    bounds: torch.Tensor,
    ml: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dscores [E, H], dvalues [E, D])`` of
    ``csr_softmax_spmm``'s ``out`` with respect to its scores and values,
    from the forward's ``ml`` and ``out`` and the gradient ``g`` ([N, D]) of
    ``out``. Masked edges, edges outside every range and the edges of empty
    rows get exactly 0. The op
    ``torch.ops.graphphysics_torch.csr_softmax_spmm_backward``: a CUDA
    tensor launches the Hopper kernel (float32, the forward's widths; every
    edge row is written, which needs the ranges ascending and disjoint, as
    the padding lays them out) and adds one to
    ``csr_softmax_spmm_backward.launches``; a CPU tensor takes
    ``csr_softmax_spmm_backward_reference``."""
    return _softmax_spmm_backward_op(scores, values, segments, bounds, ml, out, g, mask)


csr_softmax_spmm_backward.launches = 0


def _merge_partials(out_a, ml_a, out_b, ml_b, h):
    """The online-softmax merge of two partials' ``(out, ml)``, the JAX
    ``_pair_impl``'s: ``m = max(m_a, m_b)``, each side's weight
    ``w = exp(m_side - m)``, ``l = w_a l_a + w_b l_b`` and
    ``out = (w_a (l_a + eps) out_a + w_b (l_b + eps) out_b) / (l + eps)``
    with each node statistic repeated over its head's columns. A side's
    empty rows (``m = -1e30``, ``l = 0``) drop out; a row empty on both
    gives 0."""
    dh = out_a.shape[1] // h
    m_a, l_a, m_b, l_b = ml_a[:h], ml_a[h:], ml_b[:h], ml_b[h:]

    def heads(a):  # [H, N] -> [N, H*dh] head-blocked columns
        return a.t().repeat_interleave(dh, dim=1)

    m = torch.maximum(m_a, m_b)
    wa, wb = torch.exp(m_a - m), torch.exp(m_b - m)
    l = wa * l_a + wb * l_b
    acc = heads(wa * (l_a + EPS)) * out_a.to(m.dtype) + heads(wb * (l_b + EPS)) * out_b.to(m.dtype)
    return acc / (heads(l) + EPS), torch.cat([m, l], dim=0)


def csr_softmax_spmm_pair_reference(
    scores_a: torch.Tensor,
    values_a: torch.Tensor,
    seg_a: torch.Tensor,
    scores_b: torch.Tensor,
    values_b: torch.Tensor,
    seg_b: torch.Tensor,
    num_nodes: int,
    mask_a: Optional[torch.Tensor] = None,
    mask_b: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csr_softmax_spmm_pair``, line by line the
    JAX ``_pair_impl``: ``csr_softmax_spmm_reference`` of each set, then
    the merge of their ``(m, l)`` (``_merge_partials``). Returns ``(out
    [N, D] in values_a's dtype, ml [2H, N])``, the merged statistics."""
    h = scores_a.shape[1]
    out_a, ml_a = csr_softmax_spmm_reference(scores_a, values_a, seg_a, num_nodes, mask_a)
    out_b, ml_b = csr_softmax_spmm_reference(scores_b, values_b, seg_b, num_nodes, mask_b)
    out, ml = _merge_partials(out_a, ml_a, out_b, ml_b, h)
    return out.to(values_a.dtype), ml


def csr_softmax_spmm_pair_backward_reference(
    scores_a, values_a, seg_a, scores_b, values_b, seg_b, ml, out, g, mask_a=None, mask_b=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csr_softmax_spmm_pair``'s backward, the
    JAX ``_pair_bwd``: ``_pack_node_side`` and ``_edge_grads`` of each set
    against the merged ``ml`` and ``out``
    (``csr_softmax_spmm_backward_reference``). Returns ``(dscores_a,
    dvalues_a, dscores_b, dvalues_b)``."""
    dsa, dva = csr_softmax_spmm_backward_reference(scores_a, values_a, seg_a, ml, out, g, mask_a)
    dsb, dvb = csr_softmax_spmm_backward_reference(scores_b, values_b, seg_b, ml, out, g, mask_b)
    return dsa, dva, dsb, dvb


def _check_pair_args(op, scores, values, segments, bounds, mask, n, h, d) -> None:
    def fail(msg):
        raise ValueError(f"{op}: {msg}")

    for name, t in (("scores", scores), ("values", values)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            fail(f"the CUDA kernel takes contiguous 2-D float32 {name}, got {t.dtype} "
                 f"{tuple(t.shape)}")
    e = scores.shape[0]
    if scores.shape[1] != h or values.shape != (e, d):
        fail(f"scores {tuple(scores.shape)} and values {tuple(values.shape)} must be [E, {h}] "
             f"and [E, {d}]")
    if segments.shape != (e,):
        fail(f"segments must be [{e}], got {tuple(segments.shape)}")
    if bounds.shape != (2, n) or bounds.dtype != torch.int32 or not bounds.is_contiguous():
        fail(f"bounds must be contiguous int32 [2, {n}], got {bounds.dtype} {tuple(bounds.shape)}")
    if mask is not None and (mask.shape != (e,) or mask.dtype != torch.bool
                             or not mask.is_contiguous()):
        fail(f"mask must be a contiguous bool [{e}] tensor")
    for name, t in (("values", values), ("segments", segments), ("bounds", bounds), ("mask", mask)):
        if t is not None and t.device != scores.device:
            fail(f"{name} is on {t.device}, scores on {scores.device}")


def _check_pair(op, sa, va, ga, ba, ma, sb, vb, gb, bb, mb) -> Tuple[int, int, int]:
    n, h, d = ba.shape[-1], sa.shape[1], va.shape[1]
    if h == 0 or d == 0 or d > MAX_WIDTH or d % h:
        raise ValueError(f"{op}: width D={d} must be at most {MAX_WIDTH} and a multiple of H={h}")
    _check_pair_args(op, sa, va, ga, ba, ma, n, h, d)
    _check_pair_args(op, sb, vb, gb, bb, mb, n, h, d)
    return n, h, d


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_pair(sa, va, ba, ma, sb, vb, bb, mb) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's entry of the inputs' dtype: float32, or bfloat16, the bf16
    stream's entry (both sets' scores and values rounded by the caller)."""
    bf16 = sa.dtype == torch.bfloat16
    entry, counter = (("csr_softmax_spmm_pair_bf16_stream", csr_softmax_spmm_pair.bf16_stream) if bf16
                      else ("csr_softmax_spmm_pair_f32", csr_softmax_spmm_pair))
    fn = _native.function(PAIR_SOURCE, entry, 10, (ctypes.c_longlong,) * 3 + (ctypes.c_int,) * 2)
    n, h, d = ba.shape[1], sa.shape[1], va.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=sa.device)
    ml = torch.empty((2 * h, n), dtype=torch.float32, device=sa.device)
    if n == 0:
        return out, ml
    with torch.cuda.device(sa.device):
        stream = torch.cuda.current_stream(sa.device).cuda_stream
        err = fn(sa.data_ptr(), va.data_ptr(), ba.data_ptr(), _ptr(ma), sb.data_ptr(),
                 vb.data_ptr(), bb.data_ptr(), _ptr(mb), out.data_ptr(), ml.data_ptr(),
                 n, sa.shape[0], sb.shape[0], h, d, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    counter.launches += 1
    return out, ml


def _launch_pair_backward(sa, va, ba, ma, sb, vb, bb, mb, ml, out, g):
    fn = _native.function(PAIR_SOURCE, "csr_softmax_spmm_pair_bwd_f32", 15,
                          (ctypes.c_longlong,) * 3 + (ctypes.c_int,) * 2)
    n, h, d = ba.shape[1], sa.shape[1], va.shape[1]
    # zeroed: masked edges and edges outside every range keep 0
    grads = [torch.zeros_like(sa), torch.zeros_like(va), torch.zeros_like(sb), torch.zeros_like(vb)]
    if n == 0:
        return tuple(grads)
    with torch.cuda.device(sa.device):
        stream = torch.cuda.current_stream(sa.device).cuda_stream
        err = fn(sa.data_ptr(), va.data_ptr(), ba.data_ptr(), _ptr(ma), sb.data_ptr(),
                 vb.data_ptr(), bb.data_ptr(), _ptr(mb), ml.data_ptr(), out.data_ptr(),
                 g.data_ptr(), *(t.data_ptr() for t in grads), n, sa.shape[0], sb.shape[0], h,
                 d, stream)
    if err != 0:
        raise RuntimeError(f"csr_softmax_spmm_pair backward kernel launch failed: CUDA error {err}")
    csr_softmax_spmm_pair_backward.launches += 1
    return tuple(grads)


def _pair_cpu(sa, va, ga, ba, ma, sb, vb, gb, bb, mb, stream_dtype="f32"):
    if check_stream_dtype(stream_dtype):
        sa, va, sb, vb = (stream_round(t) for t in (sa, va, sb, vb))
    check_in_range("csr_softmax_spmm_pair", "receiver", ga, ba, ma)
    check_in_range("csr_softmax_spmm_pair", "receiver", gb, bb, mb)
    return csr_softmax_spmm_pair_reference(sa, va, ga, sb, vb, gb, ba.shape[1], ma, mb)


def _pair_cuda(sa, va, ga, ba, ma, sb, vb, gb, bb, mb, stream_dtype="f32"):
    bf16_stream = check_stream_dtype(stream_dtype)
    _check_pair("csr_softmax_spmm_pair", sa, va, ga, ba, ma, sb, vb, gb, bb, mb)
    if bf16_stream:  # one cast each
        sa, va, sb, vb = (t.to(torch.bfloat16) for t in (sa, va, sb, vb))
    return _launch_pair(sa, va, ba, ma, sb, vb, bb, mb)


def _pair_fake(sa, va, ga, ba, ma, sb, vb, gb, bb, mb, stream_dtype="f32"):
    n, h = ba.shape[1], sa.shape[1]
    return (va.new_empty((n, va.shape[1])),
            sa.new_empty((2 * h, n), dtype=accumulation_dtype(sa.dtype)))


def _pair_backward_cpu(sa, va, ga, ba, sb, vb, gb, bb, ml, out, g, ma, mb):
    return csr_softmax_spmm_pair_backward_reference(sa, va, ga, sb, vb, gb, ml, out, g, ma, mb)


def _pair_backward_cuda(sa, va, ga, ba, sb, vb, gb, bb, ml, out, g, ma, mb):
    op = "csr_softmax_spmm_pair_backward"
    n, h, d = _check_pair(op, sa, va, ga, ba, ma, sb, vb, gb, bb, mb)
    g = g.contiguous()
    for name, t, shape in (("out", out, (n, d)), ("g", g, (n, d)), ("ml", ml, (2 * h, n))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be a contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return _launch_pair_backward(sa, va, ba, ma, sb, vb, bb, mb, ml, out, g)


def _pair_backward_fake(sa, va, ga, ba, sb, vb, gb, bb, ml, out, g, ma, mb):
    return tuple(torch.empty_like(t) for t in (sa, va, sb, vb))


_pair_op = _native.register_op(
    "csr_softmax_spmm_pair",
    "(Tensor scores_a, Tensor values_a, Tensor seg_a, Tensor bounds_a, Tensor? mask_a, Tensor scores_b, "
    "Tensor values_b, Tensor seg_b, Tensor bounds_b, Tensor? mask_b, str stream_dtype=\"f32\") "
    "-> (Tensor, Tensor)",
    _pair_cpu, _pair_cuda, _pair_fake)
_pair_backward_op = _native.register_op(
    "csr_softmax_spmm_pair_backward",
    "(Tensor scores_a, Tensor values_a, Tensor seg_a, Tensor bounds_a, Tensor scores_b, Tensor values_b, "
    "Tensor seg_b, Tensor bounds_b, Tensor ml, Tensor out, Tensor g, Tensor? mask_a, Tensor? mask_b) "
    "-> (Tensor, Tensor, Tensor, Tensor)",
    _pair_backward_cpu, _pair_backward_cuda, _pair_backward_fake)


class _SoftmaxSpmmPair(torch.autograd.Function):
    """K5 forward and backward, through their operators."""

    @staticmethod
    def forward(ctx, sa, va, ga, ba, ma, sb, vb, gb, bb, mb, stream_dtype):
        out, ml = _pair_op(sa, va, ga, ba, ma, sb, vb, gb, bb, mb, stream_dtype)
        ctx.mark_non_differentiable(ml)
        # the unrounded inputs, with the merged ml and out: JAX's _pair_fwd
        ctx.save_for_backward(sa, va, ga, ba, ma, sb, vb, gb, bb, mb, ml, out)
        return out, ml

    @staticmethod
    def backward(ctx, g, _g_ml):
        sa, va, ga, ba, ma, sb, vb, gb, bb, mb, ml, out = ctx.saved_tensors
        dsa, dva, dsb, dvb = csr_softmax_spmm_pair_backward(
            sa, va, ga, ba, sb, vb, gb, bb, ml, out, g, ma, mb)
        return dsa, dva, None, None, None, dsb, dvb, None, None, None, None


def csr_softmax_spmm_pair(
    scores_a: torch.Tensor,
    values_a: torch.Tensor,
    seg_a: torch.Tensor,
    bounds_a: torch.Tensor,
    scores_b: torch.Tensor,
    values_b: torch.Tensor,
    seg_b: torch.Tensor,
    bounds_b: torch.Tensor,
    mask_a: Optional[torch.Tensor] = None,
    mask_b: Optional[torch.Tensor] = None,
    stream_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csr_softmax_spmm`` over the union of two edge sets ``a`` and ``b``
    that share the ``N = bounds_a.shape[1]`` rows: each set's scores
    ``[E_s, H]``, head-blocked values ``[E_s, D]``, sorted segment ids,
    per-row ranges ``[2, N]`` and optional mask. Returns ``(out [N, D],
    ml [2H, N])``, ``ml`` the merged statistics (not differentiable); the
    backward (``csr_softmax_spmm_pair_backward``) gives both sets' score
    and value gradients against them. The op
    ``torch.ops.graphphysics_torch.csr_softmax_spmm_pair``.

    A CUDA tensor launches the Hopper kernel (float32, any D <= 512 with
    D % H == 0) and adds one to ``csr_softmax_spmm_pair.launches``; it
    trusts that every unmasked edge lies in its row's range of its set. A
    CPU tensor checks that and takes ``csr_softmax_spmm_pair_reference``.
    ``stream_dtype="bf16"`` rounds both sets' scores and values to bf16
    first, as ``csr_softmax_spmm``'s (on CUDA the stream entry, counted on
    ``csr_softmax_spmm_pair.bf16_stream.launches``; the backward is the f32
    one against the merged statistics)."""
    return _SoftmaxSpmmPair.apply(scores_a, values_a, seg_a, bounds_a, mask_a,
                                  scores_b, values_b, seg_b, bounds_b, mask_b, stream_dtype)


csr_softmax_spmm_pair.launches = 0
csr_softmax_spmm_pair.bf16_stream = LaunchCount()


def csr_softmax_spmm_pair_backward(
    scores_a, values_a, seg_a, bounds_a, scores_b, values_b, seg_b, bounds_b, ml, out, g,
    mask_a=None, mask_b=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dscores_a, dvalues_a, dscores_b, dvalues_b)`` of
    ``csr_softmax_spmm_pair``'s ``out`` from its merged ``ml``, ``out`` and
    the gradient ``g`` ([N, D]) of ``out``. Masked edges and edges outside
    every range get exactly 0. The op
    ``torch.ops.graphphysics_torch.csr_softmax_spmm_pair_backward``: a CUDA
    tensor launches the Hopper kernel (each edge written by its own row's
    warp only: no atomics, the same result every run) and adds one to
    ``csr_softmax_spmm_pair_backward.launches``; a CPU tensor takes
    ``csr_softmax_spmm_pair_backward_reference``."""
    return _pair_backward_op(scores_a, values_a, seg_a, bounds_a, scores_b, values_b, seg_b,
                             bounds_b, ml, out, g, mask_a, mask_b)


csr_softmax_spmm_pair_backward.launches = 0


def csr_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
    stream_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``csr_attention``: q gathered at
    ``segments``, k and v at ``gather_idx``, the per-head dot times ``scale``
    in f32 (f64 for f64 inputs), masked edges at score ``-1e30``, then
    ``csr_softmax_spmm_reference`` on the values in f32. With
    ``stream_dtype="bf16"`` the scores and the gathered values are rounded
    to bf16 first (``stream_round``), as JAX's ``csr_sparse_attention``
    streams them. Returns ``(out [N, H, Dh] contiguous in q's dtype, rounded
    once, as the JAX K2 rounds to the values' dtype; ml [2H, N] in f32)``.
    Differentiable by autograd in q, k and v."""
    bf16_stream = check_stream_dtype(stream_dtype)
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
    v_e = v_e.to(acc)
    if bf16_stream:
        scores, v_e = stream_round(scores), stream_round(v_e)
    out, ml = csr_softmax_spmm_reference(scores, v_e, segments, num_nodes, mask)
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
    dv_e = (attn[:, :, None] * g_e).to(q.dtype).to(acc)
    dv = zeros.index_add_(0, idx, dv_e)
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
    """Whether ``lanes`` lanes a row give the fused kernels a fast geometry
    for this width, head count and layout: a butterfly of power-of-two head
    partials (``make_geometry`` in ``csrc/csr_attention.cuh``)."""
    def pow2(x):
        return x > 0 and x & (x - 1) == 0

    if width % lanes or width % heads:
        return False
    cols, head_dim = width // lanes, width // heads
    if cols > MAX_COLUMNS:
        return False
    if not interleaved:
        return head_dim % cols == 0 and pow2(head_dim // cols)
    if cols % heads == 0:
        return pow2(heads)
    if heads % cols == 0:
        return pow2(cols) and pow2(heads // cols) and heads // cols <= lanes
    return False


class WordGeometry(NamedTuple):
    """The word geometry of the fused f32 kernels (``word_geometry``)."""

    cols: int  # W, consecutive columns a lane: one word
    lanes: int  # L, lanes a row
    partials: int  # P, head partials a lane
    aligned: bool  # column i in partial i % P (else a select by the column's head)
    lo: int  # xor offsets of a head's reduction: lo, 2 lo, ... < hi
    hi: int


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@functools.lru_cache(maxsize=None)
def word_geometry(width: int, heads: int, interleaved: bool) -> Optional[WordGeometry]:
    """The word geometry of the fused f32 kernels for a width, head count
    and layout (``make_word_geometry`` in ``csrc/attention_words.cuh``): a
    lane owns W consecutive columns, one word of the first of
    ``WORD_COLUMNS`` dividing D (so no word is cut by the row's end); a row
    takes ``D / W`` lanes rounded up to a power of two and to the power of
    two at least H. Each lane adds its columns into P per-head partials,
    reduce-scattered over the xor offsets ``lo .. lo P / 2`` and
    butterflied up to ``hi`` to one head a lane: "aligned" (column i in
    partial ``i % P``) where a lane's heads follow from the column index,
    as in the fast geometries (H = 1; interleaved rows with H dividing W,
    P = H; interleaved rows with H / W a power of two, P = W, ``lo = H /
    W``; blocked rows with Dh / W a power of two, P = 1, ``hi = Dh / W``),
    else a select of each column's head with P the power of two at least H.
    None where H does not divide D, past ``MAX_PARTIALS`` heads or past
    ``WARP`` lanes: those widths keep the general geometry."""
    return _word_geometry(width, heads, interleaved, WORD_COLUMNS)


@functools.lru_cache(maxsize=None)
def bf16_word_geometry(width: int, heads: int, interleaved: bool,
                       aligned: bool = True) -> Optional[WordGeometry]:
    """The word geometry of the fused bf16 kernels
    (``csrc/csr_attention_bf16_words.cu``; ``make_word_geometry`` with
    16-byte words where ``aligned``): ``word_geometry``'s rule with words of
    the first of ``BF16_WORD_COLUMNS`` dividing D, 8 columns (16 bytes) only
    where every row base is ``VECTOR_ALIGNMENT``-byte ``aligned``. None where
    D % 4 (bf16 rows are read 8-byte aligned), past ``MAX_PARTIALS`` heads or
    past ``WARP`` lanes (D > 256 on 16-byte words, 128 on 8-byte ones): those
    widths keep the general geometry."""
    if width % BF16_WORD_COLUMNS[-1]:
        return None
    return _word_geometry(width, heads, interleaved, BF16_WORD_COLUMNS if aligned else BF16_WORD_COLUMNS[1:])


def _word_geometry(width: int, heads: int, interleaved: bool, columns: tuple) -> Optional[WordGeometry]:
    """The word geometry with words of the first of ``columns`` dividing D."""
    if not 0 < width <= MAX_WIDTH or heads <= 0 or width % heads:
        return None
    cols = next(c for c in columns if width % c == 0)
    head_dim = width // heads
    select = _pow2_at_least(heads)
    lanes = max(_pow2_at_least(width // cols), select)
    if select > MAX_PARTIALS or lanes > WARP:
        return None

    def pow2(x):
        return x > 0 and x & (x - 1) == 0

    if heads == 1:
        mode = (1, True, 1, lanes)
    elif interleaved and cols % heads == 0:
        mode = (heads, True, 1, lanes)
    elif interleaved and heads % cols == 0 and pow2(heads // cols):
        mode = (cols, True, heads // cols, lanes)
    elif not interleaved and head_dim % cols == 0 and pow2(head_dim // cols):
        mode = (1, True, 1, head_dim // cols)
    else:
        mode = (select, False, 1, lanes)
    return WordGeometry(cols, lanes, *mode)


@functools.lru_cache(maxsize=None)
def geometry_kind(lanes: int, width: int, heads: int, interleaved: bool) -> Optional[str]:
    """The geometry the fused f32 kernels take with ``lanes`` lanes a row,
    as ``csr_attention.cu`` and ``csr_attention_bwd.cu`` choose it: "fast",
    else "words" where ``lanes`` is the word geometry's, else "general"
    (``ceil(D / lanes)`` strided columns a lane with a masked tail, per-head
    sums through shared memory), None if none; the fast and general
    geometries take 8, 16 or 32 lanes. Cached: the launches count by it."""
    if width <= 0 or heads <= 0 or width % heads:
        return None
    if lanes in FORWARD_LANES and _geometry_ok(lanes, width, heads, interleaved):
        return "fast"
    words = word_geometry(width, heads, interleaved)
    if words is not None and words.lanes == lanes:
        return "words"
    return "general" if lanes in FORWARD_LANES and -(-width // lanes) <= MAX_COLUMNS else None


@functools.lru_cache(maxsize=None)
def lanes_per_row(width: int, heads: int, interleaved: bool, backward: bool = False) -> Optional[int]:
    """The lanes a sender row gets in the fused f32 forward (or
    ``backward``) kernel: the first of ``FORWARD_LANES`` (``BACKWARD_LANES``)
    with a fast geometry, else the word geometry's (``word_geometry``),
    else the general geometry's fewest lanes with at most
    ``GENERAL_COLUMNS`` columns each (32 for wider rows); None where the
    kernels take none (past ``MAX_WIDTH``, or H not dividing D). Cached:
    every launch asks it."""
    if not 0 < width <= MAX_WIDTH or heads <= 0 or width % heads:
        return None
    order = BACKWARD_LANES if backward else FORWARD_LANES
    fast = next((g for g in order if _geometry_ok(g, width, heads, interleaved)), None)
    if fast is not None:
        return fast
    words = word_geometry(width, heads, interleaved)
    if words is not None:
        return words.lanes
    return next((g for g in (8, 16) if -(-width // g) <= GENERAL_COLUMNS), 32)


BF16_KINDS = ("fast", "words", "general")  # the bf16 kernels' geometries, in order of preference


def bf16_geometries(width: int, heads: int, interleaved: bool, aligned: bool = True,
                    backward: bool = False) -> list:
    """The ``(lanes, kind)`` geometries the bf16 kernels take for a width,
    head count and layout, the preferred first: "fast", the 16-byte
    geometry (``lanes = D / c`` for ``c`` in ``BF16_COLUMNS``, or with
    ``backward`` ``BF16_BACKWARD_COLUMNS``; lanes in ``BF16_LANES``, a
    power-of-two head split; only with ``aligned`` row bases,
    ``VECTOR_ALIGNMENT`` bytes); then "words", the word geometry
    (``bf16_word_geometry``'s lanes, the same both ways); then "general",
    the general geometry with ``lanes_per_row``'s lanes, which takes
    every width; empty where none (past ``MAX_WIDTH``, H not dividing D)."""
    if not 0 < width <= MAX_WIDTH or heads <= 0 or width % heads:
        return []
    fast = [(width // c, "fast") for c in (BF16_BACKWARD_COLUMNS if backward else BF16_COLUMNS)
            if aligned and width % c == 0 and width // c in BF16_LANES
            and _geometry_ok(width // c, width, heads, interleaved)]
    words = bf16_word_geometry(width, heads, interleaved, aligned)
    words = [] if words is None else [(words.lanes, "words")]
    return fast + words + [(next((g for g in (8, 16) if -(-width // g) <= GENERAL_COLUMNS), 32), "general")]


def bf16_geometry(width: int, heads: int, interleaved: bool, aligned: bool = True,
                  backward: bool = False):
    """The ``(lanes, kind)`` geometry the bf16 forward (or ``backward``)
    runs a width, head count and layout with (the first of
    ``bf16_geometries``: the 16-byte geometry, else the word geometry, else
    the general one), or None."""
    found = bf16_geometries(width, heads, interleaved, aligned, backward)
    return found[0] if found else None


def stream_geometry(width: int, heads: int, aligned: int) -> Optional[SumGeometry]:
    """The geometry a bf16 stream entry runs ``width`` columns in ``heads``
    heads with, where the bf16 value arrays are ``aligned``-byte aligned
    (``csr_segment.alignment``; ``out`` is the wrapper's own, 16-byte
    aligned): K5's (``csr_softmax_spmm_pair_bf16_stream``) and K2's
    (``csr_softmax_spmm_bf16_stream``) alike, as ``csrc/csr_softmax_spmm_pair.cu``
    and ``csrc/csr_softmax_spmm.cu`` choose it. "words16" (8 bf16 columns of
    one head a lane, one 16-byte word) where the head width is a multiple
    of 8, D <= 256 and the values 16-byte aligned; else "words8" (4
    columns, 8-byte words) where the head width is a multiple of 4,
    D <= 128 and the values 8-byte aligned; a row takes ``D / columns``
    lanes rounded up to a power of two, 32 / lanes rows a warp, 8 edges in
    flight. Else "general", a warp a row, one edge at a time, ``ceil(D /
    32)`` columns a lane: lane j the columns j, j + 32, ... (K5, and K2
    where ``softmax_spmm_columns`` says "strided"), or K2's V adjacent
    ones ("adjacent"). None past ``MAX_WIDTH`` or where H does not divide D."""
    if not 0 < width <= MAX_WIDTH or heads <= 0 or width % heads:
        return None
    head_dim = width // heads
    for cols, kind in ((8, "words16"), (4, "words8")):
        if head_dim % cols or width > WARP * cols or aligned % (2 * cols):
            continue
        lanes = 1
        while lanes * cols < width:
            lanes *= 2
        return SumGeometry(kind, cols, lanes, WARP // lanes, EDGE_GROUP)
    return SumGeometry("general", -(-width // WARP), WARP, 1, 1)


def softmax_spmm_geometry(width: int, heads: int, aligned: int = VECTOR_ALIGNMENT) -> Optional[SumGeometry]:
    """The geometry K2's f32 entry (``csr_softmax_spmm_f32``) runs ``width``
    columns in ``heads`` heads with, where the values are ``aligned``-byte
    aligned (``out`` is the wrapper's own, 16-byte aligned), as
    ``csrc/csr_softmax_spmm.cu`` chooses it: "words16" (4 f32 columns of one
    head a lane, one 16-byte word) where the head width is a multiple of 4,
    D <= 128 and the values 16-byte aligned, a row taking ``D / 4`` lanes
    rounded up to a power of two, 32 / lanes rows a warp, 8 edges in flight;
    else "general", a warp a row, one edge at a time, ``ceil(D / 32)``
    columns a lane, adjacent or strided as ``softmax_spmm_columns`` says.
    None past ``MAX_WIDTH`` or where H does not divide D."""
    if not 0 < width <= MAX_WIDTH or heads <= 0 or width % heads:
        return None
    if (width // heads) % F32_WORD_COLUMNS == 0 and width <= WARP * F32_WORD_COLUMNS and aligned % 16 == 0:
        lanes = 1
        while lanes * F32_WORD_COLUMNS < width:
            lanes *= 2
        return SumGeometry("words16", F32_WORD_COLUMNS, lanes, WARP // lanes, EDGE_GROUP)
    return SumGeometry("general", -(-width // WARP), WARP, 1, 1)


def softmax_spmm_columns(width: int, heads: int, aligned: int, itemsize: int = 4) -> str:
    """Which kernel a "general" geometry of K2 (f32, ``itemsize`` 4, or the
    bf16 stream, 2) or of K3 (f32) is, for values ``aligned``-byte aligned,
    as ``csrc/csr_softmax_spmm.cu`` and ``csr_softmax_spmm_bwd.cu`` choose
    it: "adjacent", the V-column kernel (``V = D / 32`` contiguous
    columns of one head a lane, vector loads), where D = 32 V, a head is
    whole V-column lanes and the values aligned to those loads
    (``itemsize * min(16 / itemsize, V & -V)`` bytes); else "strided", the
    general geometry (``csrc/softmax_general.cuh``, K5's on one edge set:
    lane j the columns j, j + 32, ..., a scalar load each), which takes
    every D <= ``MAX_WIDTH`` with D % H == 0 and any alignment. K3's other
    arrays (out, g: 16-byte aligned, the wrapper checks; dvalues its own)
    take every load."""
    v = width // WARP
    if width % WARP or (width // heads) % v:
        return "strided"
    return "adjacent" if aligned % (itemsize * min(16 // itemsize, v & -v)) == 0 else "strided"


# the fused kernels' entries by element type, and the byte alignment each
# needs of a row base (float4 loads for f32; bf16: 8 bytes, and
# VECTOR_ALIGNMENT for the 16-byte geometry, chosen where every row base
# has it)
ENTRIES = {torch.float32: "f32", torch.bfloat16: "bf16"}
ALIGNMENT = {torch.float32: 16, torch.bfloat16: 8}


class GatherCsr(NamedTuple):
    """The transposed CSR of a sender-sorted graph's real unmasked edges, by
    gather row (``gather_csr``): node ``j``'s slots ``[bounds[0, j],
    bounds[1, j])`` hold the edges with ``gather_idx[e] == j`` in ascending
    edge id (``order``) and their sender rows (``senders``); the slots past
    the last end are unused. All int32, on the graph's device."""

    bounds: torch.Tensor  # [2, N]
    order: torch.Tensor  # [E]
    senders: torch.Tensor  # [E]


def gather_csr(
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    sender_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> GatherCsr:
    """The transposed CSR the bf16 backward sums dk and dv over: the real
    edges (``e`` in its sender's range of ``sender_bounds``) that ``mask``
    keeps, stably sorted by ``gather_idx``, with per-node ranges from their
    counts. It depends only on the graph: the transformer builds it once per
    forward with grad on a CUDA bf16 CSR graph and hands it to every block.
    Index preparation in PyTorch ops (a stable sort and a binary search
    for the ranges), deterministic on either device and without a host
    sync; adds one to ``gather_csr.launches``."""
    n, e = sender_bounds.shape[1], gather_idx.shape[0]
    dev = gather_idx.device
    seg = segments.to(torch.int64)
    ids = torch.arange(e, device=dev)
    row = seg.clamp(0, max(n - 1, 0))
    starts, ends = sender_bounds.to(torch.int64).unbind(0)
    valid = (seg >= 0) & (seg < n)
    if n:
        valid &= (ids >= starts[row]) & (ids < ends[row])
    if mask is not None:
        valid &= mask
    key = torch.where(valid, gather_idx.to(torch.int32), torch.full((), n, dtype=torch.int32, device=dev))
    ordered, order = torch.sort(key, stable=True)  # 32-bit keys: half the radix passes of 64
    firsts = torch.searchsorted(ordered, torch.arange(n + 1, dtype=torch.int32, device=dev),
                                out_int32=True)
    gather_csr.launches += 1
    return GatherCsr(torch.stack([firsts[:-1], firsts[1:]]), order.to(torch.int32),
                     segments.index_select(0, order).to(torch.int32))


gather_csr.launches = 0


def _check_attention_args(op, q, k, v, gather_idx, bounds, mask) -> bool:
    """Raise on what the fused kernels do not take; returns the layout
    (True: interleaved)."""
    def fail(msg):
        raise ValueError(f"{op}: {msg}")

    if q.dim() != 3:
        fail(f"q must be [N, H, Dh], got {tuple(q.shape)}")
    n, h, dh = q.shape
    d = h * dh
    if q.dtype not in ENTRIES:
        fail(f"the CUDA kernels take float32 or bfloat16 q, k, v, got {q.dtype}")
    if q.dtype == torch.bfloat16 and d % 4:
        fail(f"bfloat16 rows are read in groups of 4: width D={d} must be a multiple of 4")
    align = ALIGNMENT[q.dtype]
    layouts = set()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            fail(f"q, k and v must share one dtype: {name} is {t.dtype}, q {q.dtype}")
        if t.shape != q.shape:
            fail(f"{name} is {tuple(t.shape)}, q {tuple(q.shape)}")
        if t.device != q.device:
            fail(f"{name} is on {t.device}, q on {q.device}")
        layout = _is_interleaved(t)
        if layout is None:
            fail(f"{name} must be a contiguous [N, H, Dh] tensor or the [N, H, Dh] transpose of a "
                 f"contiguous (N, Dh, H) one, got strides {t.stride()}")
        layouts.add(layout)
        if t.data_ptr() % align:
            fail(f"{name} must be {align}-byte aligned")
    if len(layouts) != 1:
        fail("q, k and v must share one layout")
    if d == 0 or d > MAX_WIDTH:
        fail(f"width D={d} must be positive and at most {MAX_WIDTH}")
    interleaved = layouts.pop()
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


def _aligned(*tensors) -> bool:
    """Whether every row base of ``tensors`` has ``VECTOR_ALIGNMENT`` bytes
    (the 16-byte bf16 geometry)."""
    return all(t.data_ptr() % VECTOR_ALIGNMENT == 0 for t in tensors)


def _bf16_geometry(q, others, interleaved, lanes, kind, backward=False):
    """The bf16 launch's ``(lanes, kind)``: the given one, else
    ``bf16_geometry`` of the shape and of the rows' alignment."""
    n, h, dh = q.shape
    if lanes is None:
        lanes, kind = bf16_geometry(h * dh, h, interleaved, _aligned(q, *others), backward)
    if kind not in BF16_KINDS:
        raise ValueError(f"bf16 geometry kind must be one of {BF16_KINDS}, got {kind!r}")
    return lanes, kind


def _as_pair_heads(flat: torch.Tensor, h: int, interleaved: bool) -> torch.Tensor:
    """``[2, N, D]`` node rows (dk and dv in one buffer) as ``[2, N, H, Dh]``
    in the kernels' layout."""
    _, n, d = flat.shape
    return flat.view(2, n, d // h, h).transpose(2, 3) if interleaved else flat.view(2, n, h, d // h)


def _layout_of(q: torch.Tensor) -> bool:
    """The layout the ops give their outputs in: q's when the kernels take
    it (True: interleaved), else contiguous (a CPU tensor of any strides)."""
    return bool(_is_interleaved(q))


def _launch_attention(q, k, v, gather_idx, bounds, mask, scale, interleaved, lanes=None,
                      kind=None, bf16_stream=False):
    """The fused forward entry of q's dtype, or with ``bf16_stream`` its
    stream twin (the same arguments and geometry, every score, and in f32
    every gathered v element, rounded to bf16 before use). bf16: the
    geometry ``(lanes, kind)`` given, else ``bf16_geometry``'s."""
    bf16 = q.dtype == torch.bfloat16
    entry = ENTRIES[q.dtype] + ("_stream" if bf16_stream else "")
    n, h, dh = q.shape
    d = h * dh
    out = _as_heads(torch.empty((n, d), dtype=q.dtype, device=q.device), h, interleaved)
    ml = torch.empty((2 * h, n), dtype=torch.float32, device=q.device)
    if bf16:
        lanes, kind = _bf16_geometry(q, (k, v, out), interleaved, lanes, kind)
        words = kind == "words"
        name = "csr_attention_bf16_words" + entry[4:] if words else f"csr_attention_{entry}"
        fn = _native.function(BF16_WORDS_SOURCE if words else BF16_ATTENTION_SOURCE, name, 8,
                              (ctypes.c_longlong, ctypes.c_longlong) + (ctypes.c_int,) * 5
                              + (ctypes.c_float,))
        # the word geometry's 16-byte words need every row base aligned;
        # the others' last int is whether the general geometry runs
        tail = (int(_aligned(q, k, v, out)) if words else int(kind == "general"), scale)
    else:
        lanes = lanes_per_row(d, h, interleaved) if lanes is None else lanes
        fn = _native.function(ATTENTION_SOURCE, f"csr_attention_{entry}", 8,
                              (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float))
        tail = (scale,)
    if n == 0:
        return out, ml
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gather_idx.data_ptr(), bounds.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), ml.data_ptr(),
            n, gather_idx.shape[0], h, d, int(interleaved), lanes, *tail, stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_attention_{entry} kernel launch failed"
                           f"{f' ({kind} geometry)' if bf16 else ''}: CUDA error {err}")
    LAUNCHES[f"csr_attention_{entry}"].launches += 1
    if entry == "f32":
        csr_attention.geometries[geometry_kind(lanes, d, h, interleaved)] += 1
    elif bf16:
        LAUNCHES[f"csr_attention_{entry}"].geometries[kind] += 1
    return out, ml


def _launch_attention_backward(q, k, v, gather_idx, bounds, mask, ml, out, g, scale, interleaved,
                               lanes=None, kind=None, gather=None):
    if q.dtype == torch.bfloat16:
        return _launch_bf16_backward(q, k, v, gather_idx, bounds, mask, ml, out, g, scale,
                                     interleaved, lanes, kind, gather)
    fn = _native.function(ATTENTION_BACKWARD_SOURCE, "csr_attention_bwd_f32", 12,
                          (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float))
    n, h, dh = q.shape
    d = h * dh
    lanes = lanes_per_row(d, h, interleaved, backward=True) if lanes is None else lanes
    dq = _as_heads(torch.empty((n, d), dtype=q.dtype, device=q.device), h, interleaved)
    # dk and dv summed by atomics into zeroed rows (one memset for both)
    dkv = torch.zeros((2, n, d), dtype=torch.float32, device=q.device)
    grads = (dq, _as_pair_heads(dkv, h, interleaved))
    if n == 0:
        return grads
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gather_idx.data_ptr(), bounds.data_ptr(),
            None if mask is None else mask.data_ptr(), ml.data_ptr(), out.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dkv[0].data_ptr(), dkv[1].data_ptr(),
            n, gather_idx.shape[0], h, d, int(interleaved), lanes, scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_attention_bwd_f32 kernel launch failed: CUDA error {err}")
    csr_attention_backward.launches += 1
    csr_attention_backward.geometries[geometry_kind(lanes, d, h, interleaved)] += 1
    return grads


def _launch_bf16_backward(q, k, v, gather_idx, bounds, mask, ml, out, g, scale, interleaved, lanes,
                          kind, gather):
    """The bf16 backward: part A by sender rows, part B by gather rows over
    ``gather`` (a ``GatherCsr``), both kernels of one entry (of the word
    geometry's source where ``kind`` is "words"); dq, dk and dv written in
    bf16, every row, without a zeroed buffer or a cast. Returns ``(dq,
    dkv)`` as ``_launch_attention_backward``."""
    n, h, dh = q.shape
    d, e = h * dh, gather_idx.shape[0]
    dq = _as_heads(torch.empty((n, d), dtype=q.dtype, device=q.device), h, interleaved)
    dkv = torch.empty((2, n, d), dtype=q.dtype, device=q.device)
    grads = (dq, *(_as_heads(t, h, interleaved) for t in dkv.unbind(0)))
    lanes, kind = _bf16_geometry(q, (k, v, out, g), interleaved, lanes, kind, backward=True)
    words = kind == "words"
    fn = _native.function(BF16_WORDS_SOURCE if words else BF16_ATTENTION_BACKWARD_SOURCE,
                          "csr_attention_bwd_bf16_words" if words else "csr_attention_bwd_bf16", 16,
                          (ctypes.c_longlong, ctypes.c_longlong) + (ctypes.c_int,) * 5
                          + (ctypes.c_float,))
    last = int(_aligned(q, k, v, out, g, dq, dkv)) if words else int(kind == "general")
    attn_ds = torch.empty((e, h, 2), dtype=torch.float32, device=q.device)  # part A -> part B
    result = (dq, _as_pair_heads(dkv, h, interleaved))
    if n == 0:
        return result
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), gather_idx.data_ptr(), bounds.data_ptr(),
            None if mask is None else mask.data_ptr(), ml.data_ptr(), out.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in gather), attn_ds.data_ptr(), *(t.data_ptr() for t in grads),
            n, e, h, d, int(interleaved), lanes, last, scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_attention_bwd_bf16 kernel launch failed ({kind} geometry): "
                           f"CUDA error {err}")
    csr_attention_backward.bf16.launches += 1
    csr_attention_backward.bf16.geometries[kind] += 1
    return result


def _attention_cpu(q, k, v, segments, gather_idx, sender_bounds, mask, scale, gather_bounds,
                   gather_order, gather_senders, stream_dtype="f32"):
    # the transposed CSR rides along for the backward only (the autograd
    # formula saves it); the forward reads none of it
    check_in_range("csr_attention", "sender", segments, sender_bounds, mask)
    out, ml = csr_attention_reference(q, k, v, segments, gather_idx, sender_bounds.shape[1], mask,
                                      scale, stream_dtype)
    return _in_layout(out, _layout_of(q)), ml


def _attention_cuda(q, k, v, segments, gather_idx, sender_bounds, mask, scale, gather_bounds,
                    gather_order, gather_senders, stream_dtype="f32"):
    bf16_stream = check_stream_dtype(stream_dtype)
    interleaved = _check_attention_args("csr_attention", q, k, v, gather_idx, sender_bounds, mask)
    return _launch_attention(q, k, v, gather_idx, sender_bounds, mask, scale, interleaved,
                             bf16_stream=bf16_stream)


def _attention_fake(q, k, v, segments, gather_idx, sender_bounds, mask, scale, gather_bounds,
                    gather_order, gather_senders, stream_dtype="f32"):
    n, h, dh = q.shape
    return (_as_heads(q.new_empty((n, h * dh)), h, _layout_of(q)),
            q.new_empty((2 * h, n), dtype=accumulation_dtype(q.dtype)))


def _attention_backward_cpu(q, k, v, segments, gather_idx, sender_bounds, ml, out, g, mask, scale,
                            gather_bounds, gather_order, gather_senders):
    dq, dk, dv = csr_attention_backward_reference(q, k, v, segments, gather_idx, ml, out, g, mask,
                                                  scale)
    interleaved = _layout_of(q)
    n, h, dh = q.shape
    dkv = _as_pair_heads(q.new_empty((2, n, h * dh)), h, interleaved)
    dkv[0].copy_(dk)
    dkv[1].copy_(dv)
    return _in_layout(dq, interleaved), dkv


def _attention_backward_cuda(q, k, v, segments, gather_idx, sender_bounds, ml, out, g, mask, scale,
                             gather_bounds, gather_order, gather_senders):
    op = "csr_attention_backward"
    interleaved = _check_attention_args(op, q, k, v, gather_idx, sender_bounds, mask)
    n, h, _ = q.shape
    gather = None
    if q.dtype == torch.bfloat16:
        if gather_bounds is not None:
            gather = GatherCsr(gather_bounds, gather_order, gather_senders)
        _check_gather(op, gather, n, gather_idx.shape[0], q.device)
    g = _in_layout(g.to(q.dtype), interleaved)
    align = ALIGNMENT[q.dtype]
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or _is_interleaved(t) is not interleaved:
            raise ValueError(f"{op}: {name} must be {q.dtype} {tuple(q.shape)} in q's layout, got "
                             f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
        if t.device != q.device or t.data_ptr() % align:
            raise ValueError(f"{op}: {name} must be {align}-byte aligned on {q.device}")
    if ml.shape != (2 * h, n) or ml.dtype != torch.float32 or not ml.is_contiguous():
        raise ValueError(f"{op}: ml must be a contiguous float32 {(2 * h, n)}")
    return _launch_attention_backward(q, k, v, gather_idx, sender_bounds, mask, ml, out, g,
                                      float(scale), interleaved, gather=gather)


def _attention_backward_fake(q, k, v, segments, gather_idx, sender_bounds, ml, out, g, mask, scale,
                             gather_bounds, gather_order, gather_senders):
    n, h, dh = q.shape
    interleaved = _layout_of(q)
    return (_as_heads(q.new_empty((n, h * dh)), h, interleaved),
            _as_pair_heads(q.new_empty((2, n, h * dh)), h, interleaved))


_attention_op = _native.register_op(
    "csr_attention",
    "(Tensor q, Tensor k, Tensor v, Tensor segments, Tensor gather_idx, Tensor sender_bounds, Tensor? mask, "
    "float scale, Tensor? gather_bounds, Tensor? gather_order, Tensor? gather_senders, "
    "str stream_dtype=\"f32\") -> (Tensor, Tensor)",
    _attention_cpu, _attention_cuda, _attention_fake)
_attention_backward_op = _native.register_op(
    "csr_attention_backward",
    "(Tensor q, Tensor k, Tensor v, Tensor segments, Tensor gather_idx, Tensor sender_bounds, Tensor ml, "
    "Tensor out, Tensor g, Tensor? mask, float scale, Tensor? gather_bounds, Tensor? gather_order, "
    "Tensor? gather_senders) -> (Tensor, Tensor)",
    _attention_backward_cpu, _attention_backward_cuda, _attention_backward_fake)


class _CsrAttention(torch.autograd.Function):
    """The fused attention forward and backward, through their operators."""

    @staticmethod
    def forward(ctx, q, k, v, segments, gather_idx, sender_bounds, mask, scale, stream_dtype, *gather):
        out, ml = _attention_op(q, k, v, segments, gather_idx, sender_bounds, mask, scale, *gather,
                                stream_dtype)
        ctx.mark_non_differentiable(ml)
        ctx.save_for_backward(q, k, v, segments, gather_idx, sender_bounds, mask, ml, out, *gather)
        ctx.scale = scale
        return out, ml

    @staticmethod
    def backward(ctx, g, _g_ml):
        q, k, v, segments, gather_idx, sender_bounds, mask, ml, out, *gather = ctx.saved_tensors
        dq, dkv = _attention_backward_op(q, k, v, segments, gather_idx, sender_bounds, ml, out, g,
                                         mask, ctx.scale, *gather)
        return (dq, *dkv.unbind(0)) + (None,) * 9


def csr_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    sender_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
    gather: Optional[GatherCsr] = None,
    stream_dtype: str = "f32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused sparse attention of ``csr_sparse_attention``, also returning the
    online-softmax statistics: ``(out [N, H, Dh], ml [2H, N])`` with ``ml =
    [m; l]`` per head (``-1e30`` and 0 for a row without edges, whose output
    is 0). Differentiable in q, k and v through ``out``; the backward is
    ``csr_attention_backward``, which on CUDA bf16 needs ``gather``, the
    graph's ``gather_csr``. The op ``torch.ops.graphphysics_torch.csr_attention``
    (``gather`` rides along as three optional tensors, for the backward).

    A CUDA tensor launches the Hopper kernel and adds one to
    ``csr_attention.launches`` (the float32 entry) or
    ``csr_attention.bf16.launches`` (the bfloat16 one): q, k, v all float32
    or all bfloat16, of one layout (contiguous ``[N, H, Dh]``, or the
    transpose of a contiguous ``(N, Dh, H)``; out comes in the same layout
    and dtype), any width D = H * Dh up to ``MAX_WIDTH`` (bf16: a multiple
    of 4), 16-byte aligned (bf16: 8-byte; the 16-byte geometry where the
    width and every row base allow, else the word geometry where its lanes
    hold the row, else the general one, ``bf16_geometry``; counted by the
    geometry that ran on ``csr_attention.bf16.geometries``), int32
    ``gather_idx`` and ``sender_bounds``; it raises on anything else and
    trusts the edge layout (every unmasked edge in its sender's range,
    gather indices in ``[0, N)``: build graphs with ``pad_graph_csr_np``).
    The segment ids are not read on the card: the ranges carry them. A CPU
    tensor checks the layout and takes ``csr_attention_reference``; out
    comes in q's layout there too (contiguous for any other strides).

    ``stream_dtype="bf16"`` (the op's argument too) is JAX's bf16 stream:
    every edge's scores, and the gathered values, rounded to bf16 before
    the softmax and the weighted sum, which stay f32. On CUDA it launches
    the stream twin of the dtype's entry (``csr_attention.f32_stream`` /
    ``csr_attention.bf16_stream`` count them); the backward is the
    dtype's backward entry, which recomputes the unrounded scores, with the
    stream pass's ``ml`` and ``out``, as JAX's. Any other value raises
    ``ValueError``."""
    return _CsrAttention.apply(q, k, v, segments, gather_idx, sender_bounds, mask, float(scale),
                               stream_dtype, *_gather_args(gather))


csr_attention.launches = 0
# the f32 entry's launches by the geometry that ran (geometry_kind), so a
# run can show which one its path took
csr_attention.geometries = {"fast": 0, "words": 0, "general": 0}


def _gather_args(gather: Optional[GatherCsr]) -> tuple:
    """A ``GatherCsr`` as the ops' three optional tensor arguments."""
    return (None, None, None) if gather is None else tuple(gather)


def _check_gather(op, gather, n, e, device) -> None:
    if gather is None:
        raise ValueError(f"{op}: the bf16 backward on CUDA sums dk and dv by gather rows: pass "
                         f"the graph's transposed CSR (gather_csr)")
    for name, t, shape in (("bounds", gather.bounds, (2, n)), ("order", gather.order, (e,)),
                           ("senders", gather.senders, (e,))):
        if (t.shape != shape or t.dtype != torch.int32 or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{op}: gather_csr {name} must be a contiguous int32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


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
    gather: Optional[GatherCsr] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of ``csr_attention``'s ``out`` from
    the forward's ``ml`` and ``out`` and the gradient ``g`` of ``out``.
    Masked edges and rows without edges add nothing. The op
    ``torch.ops.graphphysics_torch.csr_attention_backward``, which returns
    ``(dq, dkv)`` with dk and dv in one ``[2, N, H, Dh]`` buffer (an op's
    outputs may not alias). A CUDA tensor launches
    the Hopper kernel (the forward's arguments; ``g`` is brought into their
    layout) and adds one to ``csr_attention_backward.launches`` (float32:
    ``dk`` and ``dv`` summed with atomics, in an order that varies from run
    to run) or ``csr_attention_backward.bf16.launches`` (bfloat16: sender
    rows, then gather rows over ``gather``, the graph's ``gather_csr``,
    which it needs; no atomics, the same bits every run; by geometry on
    ``csr_attention_backward.bf16.geometries``); a CPU tensor takes
    ``csr_attention_backward_reference``."""
    dq, dkv = _attention_backward_op(q, k, v, segments, gather_idx, sender_bounds, ml, out, g, mask,
                                     float(scale), *_gather_args(gather))
    return (dq, *dkv.unbind(0))


csr_attention_backward.launches = 0
csr_attention_backward.geometries = {"fast": 0, "words": 0, "general": 0}


# the bf16 entries, and the bf16 stream's, count apart from the f32 ones,
# so a run shows which ran
csr_attention.bf16 = LaunchCount()
csr_attention.f32_stream = LaunchCount()
csr_attention.bf16_stream = LaunchCount()
csr_attention_backward.bf16 = LaunchCount()
# the bf16 entries' launches by the geometry that ran (BF16_KINDS), as the
# f32 entries' on csr_attention.geometries
for _counter in (csr_attention.bf16, csr_attention.bf16_stream, csr_attention_backward.bf16):
    _counter.geometries = dict.fromkeys(BF16_KINDS, 0)
LAUNCHES = {
    "csr_attention_f32": csr_attention,
    "csr_attention_bf16": csr_attention.bf16,
    "csr_attention_f32_stream": csr_attention.f32_stream,
    "csr_attention_bf16_stream": csr_attention.bf16_stream,
    "csr_attention_bwd_f32": csr_attention_backward,
    "csr_attention_bwd_bf16": csr_attention_backward.bf16,
}


def csr_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    segments: torch.Tensor,
    gather_idx: torch.Tensor,
    sender_bounds: torch.Tensor,
    edge_mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
    gather: Optional[GatherCsr] = None,
    stream_dtype: str = "f32",
) -> torch.Tensor:
    """Sparse graph attention on a CSR edge list: queries at ``segments``
    (ascending; the softmax side), keys and values at ``gather_idx``. With
    edges sorted by sender this is the reference's COO convention. ``q``,
    ``k``, ``v`` are ``[N, H, Dh]``; returns ``[N, H, Dh]`` in q's dtype.

    The gathers, the per-head dot times ``scale``, the softmax and the
    weighted sum are ``csr_attention``: on CUDA one fused kernel forward and
    one backward, reading q, k and v in the layout given (contiguous, or the
    ``(N, Dh, H)`` views of the model's ``Attention``; out comes in the same
    one). Masked edges drop out. Differentiable in q, k and v; the bf16
    backward on CUDA needs ``gather``, the graph's ``gather_csr``.
    ``stream_dtype`` is JAX's: ``"f32"``, or ``"bf16"`` with the scores and
    values rounded to bf16 before the softmax and the weighted sum
    (``csr_attention``)."""
    out, _ = csr_attention(q, k, v, segments, gather_idx, sender_bounds, edge_mask, scale, gather,
                           stream_dtype)
    return out
