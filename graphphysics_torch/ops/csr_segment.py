"""Segment sum over a receiver-sorted (CSR) edge list: the counterpart of
``graphphysics_tpu/ops/pallas_segment.py``.

``csr_segment_sum`` computes ``out[n] = sum of data[e] over the real edges e
with receivers[e] == n``, and ``csr_segment_sum_backward`` its gradient:
``ddata[e] = g[receivers[e]]`` on the real unmasked edges and 0 elsewhere.
Each is a ``torch.library`` op of the ``graphphysics_torch`` namespace
(``torch.ops.graphphysics_torch.csr_segment_sum``), so ``torch.export``
traces through them; a ``torch.autograd.Function`` calls the forward op
and, for its gradient, the backward op. The ops' CUDA implementations
launch hand-written Hopper kernels of ``csrc/csr_segment_sum.cu`` (built
with ``nvcc`` at first use; an entry per element type: float32, bfloat16
and float16, the 16-bit ones summing in f32 and rounding once, counted
apart on ``.bf16`` and ``.f16``) or raise; their CPU implementations are
``csr_segment_sum_reference`` and ``csr_segment_sum_backward_reference``,
the plain PyTorch versions; their fake implementations give shapes and
dtypes only. Nothing but the tensors' device selects between the two.

Every entry takes a lane geometry chosen before the launch by width and
alignment (16-byte words where they fit, else the 16-bit entries' column
pairs, else single columns); ``segment_sum_geometry`` is that rule, kept
beside the kernels so the CPU tests and the card's records can read it.
The f32 entry counts its launches by geometry on
``csr_segment_sum.geometries``, so a run can show which one its path took.

The kernel reads per-node ``[start, end)`` ranges of real edges
(``compute_row_bounds``, built on the host with the padding) instead of the
TPU kernel's per-256-row block offsets; ``compute_block_offsets`` and
``compute_max_chunks`` are kept so tests can hold the host helpers against
the JAX ones.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from graphphysics_torch.ops import _native

# Block sizes of the TPU kernel, kept for its host helpers.
BLOCK_NODES = 256
BLOCK_EDGES = 512
SOURCE = "csr_segment_sum.cu"


def compute_block_offsets(
    receivers_sorted: np.ndarray, num_nodes: int, block_nodes: int = BLOCK_NODES
) -> np.ndarray:
    """For each node block b, the first edge index whose receiver is
    >= b*block_nodes; length ``num_blocks + 1``."""
    num_blocks = -(-num_nodes // block_nodes)
    bounds = np.arange(1, num_blocks + 1) * block_nodes
    offsets = np.searchsorted(receivers_sorted, bounds, side="left")
    return np.concatenate([[0], offsets]).astype(np.int32)


def compute_max_chunks(offsets: np.ndarray, block_edges: int = BLOCK_EDGES) -> int:
    """Number of block_edges-aligned windows the busiest block needs."""
    offsets = np.asarray(offsets, np.int64)
    first = offsets[:-1] // block_edges
    last = -(-(offsets[1:] + 1) // block_edges)
    return int(np.maximum(last - first, 1).max())


def compute_row_bounds(
    receivers_sorted: np.ndarray,
    num_nodes: int,
    num_real_edges: Optional[int] = None,
) -> np.ndarray:
    """``[2, num_nodes]`` int32: node n's real edges are
    ``[bounds[0, n], bounds[1, n])``. Only the first ``num_real_edges``
    entries count (default: all), so trailing padding edges fall outside
    every range. ``receivers_sorted`` (or senders, for the sender-sorted
    layout) must be ascending over those entries."""
    recv = np.asarray(receivers_sorted)[:num_real_edges]
    if len(recv) > 1 and np.any(recv[1:] < recv[:-1]):
        raise ValueError("compute_row_bounds: the segment ids are not sorted")
    nodes = np.arange(num_nodes)
    return np.stack(
        [
            np.searchsorted(recv, nodes, side="left"),
            np.searchsorted(recv, nodes, side="right"),
        ]
    ).astype(np.int32)


# the 16-byte geometry (csrc/csr_segment_sum.cu): columns a lane (one
# 16-byte word) of the 16-bit and the f32 entries, and the edges whose
# words a lane has in flight (K2's and K5's bf16 stream words too,
# csrc/csr_softmax_spmm.cu, csrc/csr_softmax_spmm_pair.cu)
WORD_COLUMNS = 8
F32_WORD_COLUMNS = 4
EDGE_GROUP = 8
WARP = 32


class SumGeometry(NamedTuple):
    """A lane geometry of K1's kernels (``segment_sum_geometry``: "words16",
    16-byte words; "pairs", 4-byte column pairs; "columns", one column a
    lane), of K2's and K5's bf16 stream (``csr_attention.stream_geometry``:
    "words16", "words8", "general") or of K2's f32 entry
    (``csr_attention.softmax_spmm_geometry``: "words16", "general"): its
    ``kind``, the adjacent ``columns`` a lane owns, the ``lanes`` a row
    takes (a column block of 32 lanes past that), the ``rows_per_warp`` and
    the edges whose loads a lane has in flight."""

    kind: str
    columns: int
    lanes: int
    rows_per_warp: int
    edges_in_flight: int


def alignment(*tensors: Optional[torch.Tensor]) -> int:
    """The largest power of two, at most 16, that divides the address of
    every tensor's first element (``None`` and empty tensors ignored): the
    byte alignment the kernels' vector loads are chosen by."""
    found = 16
    for t in tensors:
        if t is not None and t.numel():
            ptr = t.data_ptr()
            while ptr % found:
                found //= 2
    return found


def segment_sum_geometry(width: int, dtype: torch.dtype, aligned: int) -> SumGeometry:
    """The geometry K1's entry for ``dtype`` runs a ``width``-column row
    with, where data and out are both ``aligned``-byte aligned
    (``alignment``): 16-byte words (4 f32 or 8 16-bit columns a lane) where
    the width is a multiple of a word's columns and the arrays 16-byte
    aligned (``width / columns`` lanes a row, rounded up to a power of two
    and at most 32, so 32 / lanes rows a warp; 8 edges in flight); else,
    for the 16-bit entries, 4-byte pairs where the width is even and the
    arrays 4-byte aligned; else one column a lane."""
    cols = F32_WORD_COLUMNS if dtype == torch.float32 else WORD_COLUMNS
    if width > 0 and width % cols == 0 and aligned % 16 == 0:
        lanes = 1
        while lanes < WARP and lanes * cols < width:
            lanes *= 2
        return SumGeometry("words16", cols, lanes, WARP // lanes, EDGE_GROUP)
    if dtype != torch.float32 and width % 2 == 0 and aligned % 4 == 0:
        return SumGeometry("pairs", 2, WARP, 1, 1)
    return SumGeometry("columns", 1, WARP, 1, 1)


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions compute in: float32 for 16-bit and
    float32 inputs, float64 for float64 (the gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


def csr_segment_sum_reference(
    data: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: masked ``index_add_`` into f32 (f64 for f64
    data), returned in ``data``'s dtype. Masked edges contribute nothing."""
    acc = accumulation_dtype(data.dtype)
    src = data.to(acc)
    if mask is not None:
        src = torch.where(mask[:, None], src, torch.zeros((), dtype=src.dtype, device=src.device))
    out = torch.zeros((num_nodes,) + tuple(data.shape[1:]), dtype=acc, device=data.device)
    out.index_add_(0, receivers.to(torch.int64), src)
    return out.to(data.dtype)


def csr_segment_sum_backward_reference(
    g: torch.Tensor,
    receivers: torch.Tensor,
    row_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the backward: ``ddata[e] = g[receivers[e]]``
    for each unmasked edge inside its receiver's range, exactly 0 for every
    other edge (masked edges, padding). The JAX ``_bwd`` gathers for every
    edge; the two agree on the real unmasked edges."""
    n = row_bounds.shape[1]
    e = torch.arange(receivers.shape[0], device=receivers.device)
    r = receivers.to(torch.int64)
    rc = r.clamp(0, n - 1)
    bounds = row_bounds.to(torch.int64)
    live = (r >= 0) & (r < n) & (bounds[0][rc] <= e) & (e < bounds[1][rc])
    if mask is not None:
        live &= mask
    return torch.where(live[:, None], g.index_select(0, rc), torch.zeros((), dtype=g.dtype, device=g.device))


# the kernels' entries by element type (csrc/csr_segment_sum.cu)
ENTRIES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def _check_cuda_args(op, t, edges, receivers, row_bounds, mask) -> None:
    """Raise unless the kernels of ``op`` take these tensors: ``t`` (data
    [E, H] or gradient [N, H]) float32, bfloat16 or float16 and contiguous,
    the edge layout of ``edges`` edges on its device."""

    def fail(msg):
        raise ValueError(f"{op}: {msg}")

    if t.dtype not in ENTRIES:
        fail(f"the CUDA kernels take float32, bfloat16 or float16 data, got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        fail(f"data must be a contiguous 2-D tensor, got {tuple(t.shape)}")
    if receivers.shape != (edges,):
        fail(f"receivers must be [{edges}], got {tuple(receivers.shape)}")
    if receivers.dtype != torch.int32 or not receivers.is_contiguous():
        fail("receivers must be contiguous int32 (the backward kernel reads them)")
    if row_bounds.dim() != 2 or row_bounds.shape[0] != 2:
        fail(f"row_bounds must be [2, N], got {tuple(row_bounds.shape)}")
    if row_bounds.dtype != torch.int32 or not row_bounds.is_contiguous():
        fail("row_bounds must be contiguous int32")
    if mask is not None and (
        mask.shape != (edges,) or mask.dtype != torch.bool or not mask.is_contiguous()
    ):
        fail(f"mask must be a contiguous bool [{edges}] tensor")
    for name, x in (("receivers", receivers), ("row_bounds", row_bounds), ("mask", mask)):
        if x is not None and x.device != t.device:
            fail(f"{name} is on {x.device}, data on {t.device}")


def check_in_range(op: str, side: str, segments, bounds, mask) -> None:
    """Raise unless every unmasked edge ``e`` lies in its segment's range
    ``[bounds[0, s], bounds[1, s])``, ``s = segments[e]``: the layout the
    CUDA kernels trust. ``op`` and ``side`` (``"receiver"`` or
    ``"sender"``) name the caller and its segment index in the message."""
    e = torch.arange(segments.shape[0], device=segments.device)
    s = segments.to(torch.int64)
    inside = (bounds[0][s] <= e) & (e < bounds[1][s])
    if mask is not None:
        inside |= ~mask
    if not bool(inside.all()):
        raise ValueError(
            f"{op}: an unmasked edge lies outside its {side}'s row range "
            f"(edges not sorted by {side}, or stale bounds)"
        )


def _launch(data, row_bounds, mask) -> torch.Tensor:
    entry = ENTRIES[data.dtype]
    fn = _native.function(SOURCE, f"csr_segment_sum_{entry}", 4,
                          (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int))
    e, h = data.shape
    n = row_bounds.shape[1]
    out = torch.empty((n, h), dtype=data.dtype, device=data.device)
    if n == 0 or h == 0:
        return out
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = fn(
            data.data_ptr(),
            row_bounds.data_ptr(),
            None if mask is None else mask.data_ptr(),
            out.data_ptr(),
            n,
            e,
            h,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_segment_sum_{entry} kernel launch failed: CUDA error {err}")
    LAUNCHES[f"csr_segment_sum_{entry}"].launches += 1
    if data.dtype == torch.float32:
        csr_segment_sum.geometries[segment_sum_geometry(h, data.dtype, alignment(data, out)).kind] += 1
    return out


def _launch_backward(g, receivers, row_bounds, mask) -> torch.Tensor:
    entry = ENTRIES[g.dtype]
    fn = _native.function(SOURCE, f"csr_segment_sum_bwd_{entry}", 5,
                          (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int))
    n, h = g.shape
    e = receivers.shape[0]
    ddata = torch.empty((e, h), dtype=g.dtype, device=g.device)
    if e == 0 or h == 0:
        return ddata
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = fn(
            g.data_ptr(),
            receivers.data_ptr(),
            row_bounds.data_ptr(),
            None if mask is None else mask.data_ptr(),
            ddata.data_ptr(),
            n,
            e,
            h,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"csr_segment_sum_bwd_{entry} kernel launch failed: CUDA error {err}")
    LAUNCHES[f"csr_segment_sum_bwd_{entry}"].launches += 1
    return ddata


# K1 and K1b as torch.library operators (_native.register_op): the CPU
# implementation is the plain version, the CUDA one the kernel
def _segment_sum_cpu(data, receivers, row_bounds, mask):
    check_in_range("csr_segment_sum", "receiver", receivers, row_bounds, mask)
    return csr_segment_sum_reference(data, receivers, row_bounds.shape[1], mask)


def _segment_sum_cuda(data, receivers, row_bounds, mask):
    _check_cuda_args("csr_segment_sum", data, data.shape[0], receivers, row_bounds, mask)
    return _launch(data, row_bounds, mask)


def _segment_sum_fake(data, receivers, row_bounds, mask):
    return data.new_empty((row_bounds.shape[1], data.shape[1]))


def _segment_sum_backward_cpu(g, receivers, row_bounds, mask):
    return csr_segment_sum_backward_reference(g, receivers, row_bounds, mask)


def _segment_sum_backward_cuda(g, receivers, row_bounds, mask):
    op = "csr_segment_sum_backward"
    g = g.contiguous()
    _check_cuda_args(op, g, receivers.shape[0], receivers, row_bounds, mask)
    if row_bounds.shape[1] != g.shape[0]:
        raise ValueError(f"{op}: row_bounds covers {row_bounds.shape[1]} rows, g has {g.shape[0]}")
    return _launch_backward(g, receivers, row_bounds, mask)


def _segment_sum_backward_fake(g, receivers, row_bounds, mask):
    return g.new_empty((receivers.shape[0], g.shape[1]))


_segment_sum_op = _native.register_op(
    "csr_segment_sum", "(Tensor data, Tensor receivers, Tensor row_bounds, Tensor? mask) -> Tensor",
    _segment_sum_cpu, _segment_sum_cuda, _segment_sum_fake)
_segment_sum_backward_op = _native.register_op(
    "csr_segment_sum_backward", "(Tensor g, Tensor receivers, Tensor row_bounds, Tensor? mask) -> Tensor",
    _segment_sum_backward_cpu, _segment_sum_backward_cuda, _segment_sum_backward_fake)


class _SegmentSum(torch.autograd.Function):
    """K1 forward, K1b backward, through their operators."""

    @staticmethod
    def forward(ctx, data, receivers, row_bounds, mask):
        ctx.save_for_backward(receivers, row_bounds, mask)
        return _segment_sum_op(data, receivers, row_bounds, mask)

    @staticmethod
    def backward(ctx, g):
        receivers, row_bounds, mask = ctx.saved_tensors
        return csr_segment_sum_backward(g, receivers, row_bounds, mask), None, None, None


def csr_segment_sum(
    data: torch.Tensor,
    receivers: torch.Tensor,
    row_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data`` ([E, H]) rows into ``N = row_bounds.shape[1]`` rows by
    receiver-sorted ``receivers``; ``row_bounds`` is ``compute_row_bounds``
    of those receivers and ``mask`` ([E] bool) drops edges anywhere.
    Differentiable in ``data``: the gradient is ``csr_segment_sum_backward``.
    The op ``torch.ops.graphphysics_torch.csr_segment_sum``.

    The kernel reads only the row ranges, so every unmasked edge must lie in
    its receiver's range. A CUDA tensor launches the Hopper kernel of its
    dtype and adds one to ``csr_segment_sum.launches`` (float32, and
    to the geometry that ran on ``csr_segment_sum.geometries``),
    ``csr_segment_sum.bf16.launches`` or ``csr_segment_sum.f16.launches``
    (the 16-bit entries: the sum in f32, the rows rounded once to the
    data's dtype, which the output keeps); the CUDA path trusts the
    layout and does not check it, so unsorted edges or stale ``row_bounds``
    give wrong sums without an error there (build graphs with
    ``pad_graph_sorted_np``, which keeps the two together). A CPU tensor
    checks that precondition and takes ``csr_segment_sum_reference``."""
    return _SegmentSum.apply(data, receivers, row_bounds, mask)


csr_segment_sum.launches = 0
# the f32 entry's launches by the geometry that ran (segment_sum_geometry)
csr_segment_sum.geometries = {"words16": 0, "columns": 0}


def csr_segment_sum_backward(
    g: torch.Tensor,
    receivers: torch.Tensor,
    row_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The gradient of ``csr_segment_sum`` with respect to its data, from
    the output's gradient ``g`` ([N, H]): ``[E, H]`` with ``g[receivers[e]]``
    on each unmasked edge inside its receiver's range and 0 on every other
    edge. The op ``torch.ops.graphphysics_torch.csr_segment_sum_backward``:
    a CUDA tensor launches the Hopper kernel of its dtype (float32, bfloat16
    or float16, in g's dtype; every edge row is written) and adds one to
    ``csr_segment_sum_backward.launches`` (float32),
    ``csr_segment_sum_backward.bf16.launches`` or ``.f16.launches``; a CPU
    tensor takes ``csr_segment_sum_backward_reference``."""
    return _segment_sum_backward_op(g, receivers, row_bounds, mask)


csr_segment_sum_backward.launches = 0


class LaunchCount:
    """The launch count of one kernel entry (``.launches``)."""

    def __init__(self):
        self.launches = 0


# the 16-bit entries count apart from the f32 ones, so a run shows which ran
csr_segment_sum.bf16 = LaunchCount()
csr_segment_sum.f16 = LaunchCount()
csr_segment_sum_backward.bf16 = LaunchCount()
csr_segment_sum_backward.f16 = LaunchCount()
LAUNCHES = {
    "csr_segment_sum_f32": csr_segment_sum,
    "csr_segment_sum_bf16": csr_segment_sum.bf16,
    "csr_segment_sum_f16": csr_segment_sum.f16,
    "csr_segment_sum_bwd_f32": csr_segment_sum_backward,
    "csr_segment_sum_bwd_bf16": csr_segment_sum_backward.bf16,
    "csr_segment_sum_bwd_f16": csr_segment_sum_backward.f16,
}
