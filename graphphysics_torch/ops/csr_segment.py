"""Segment sum over a receiver-sorted (CSR) edge list: the counterpart of
``graphphysics_tpu/ops/pallas_segment.py``.

``csr_segment_sum`` computes ``out[n] = sum of data[e] over the real edges e
with receivers[e] == n``. For a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/csr_segment_sum.cu`` (built with ``nvcc`` at first use)
or raises; for a CPU tensor it takes ``csr_segment_sum_reference``, the plain
PyTorch version (masked ``index_add_`` into f32). Nothing else selects
between the two.

The kernel reads per-node ``[start, end)`` ranges of real edges
(``compute_row_bounds``, built on the host with the padding) instead of the
TPU kernel's per-256-row block offsets; ``compute_block_offsets`` and
``compute_max_chunks`` are kept so tests can hold the host helpers against
the JAX ones.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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


def csr_segment_sum_reference(
    data: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: masked ``index_add_`` into f32, returned in
    ``data``'s dtype. Masked edges contribute nothing."""
    src = data.to(torch.float32)
    if mask is not None:
        src = torch.where(mask[:, None], src, torch.zeros((), dtype=src.dtype, device=src.device))
    out = torch.zeros((num_nodes,) + tuple(data.shape[1:]), dtype=torch.float32, device=data.device)
    out.index_add_(0, receivers.to(torch.int64), src)
    return out.to(data.dtype)


def _check_cuda_args(data, receivers, row_bounds, mask) -> None:
    def fail(msg):
        raise ValueError(f"csr_segment_sum: {msg}")

    if data.dtype != torch.float32:
        fail(f"the CUDA kernel takes float32 data, got {data.dtype}")
    if data.dim() != 2 or not data.is_contiguous():
        fail(f"data must be a contiguous [E, H] tensor, got {tuple(data.shape)}")
    if data.requires_grad and torch.is_grad_enabled():
        fail("the CUDA kernel has no backward yet; call it under no_grad")
    e = data.shape[0]
    if receivers.shape != (e,):
        fail(f"receivers must be [{e}], got {tuple(receivers.shape)}")
    if row_bounds.dim() != 2 or row_bounds.shape[0] != 2:
        fail(f"row_bounds must be [2, N], got {tuple(row_bounds.shape)}")
    if row_bounds.dtype != torch.int32 or not row_bounds.is_contiguous():
        fail("row_bounds must be contiguous int32")
    if mask is not None and (
        mask.shape != (e,) or mask.dtype != torch.bool or not mask.is_contiguous()
    ):
        fail(f"mask must be a contiguous bool [{e}] tensor")
    for name, t in (("receivers", receivers), ("row_bounds", row_bounds), ("mask", mask)):
        if t is not None and t.device != data.device:
            fail(f"{name} is on {t.device}, data on {data.device}")


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
    lib = _native.load(SOURCE)
    fn = lib.csr_segment_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    e, h = data.shape
    n = row_bounds.shape[1]
    out = torch.empty((n, h), dtype=torch.float32, device=data.device)
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
        raise RuntimeError(f"csr_segment_sum kernel launch failed: CUDA error {err}")
    csr_segment_sum.launches += 1
    return out


def csr_segment_sum(
    data: torch.Tensor,
    receivers: torch.Tensor,
    row_bounds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data`` ([E, H]) rows into ``N = row_bounds.shape[1]`` rows by
    receiver-sorted ``receivers``; ``row_bounds`` is ``compute_row_bounds``
    of those receivers and ``mask`` ([E] bool) drops edges anywhere.

    The kernel reads only the row ranges, so every unmasked edge must lie in
    its receiver's range. A CUDA tensor launches the Hopper kernel (float32,
    forward only) and adds one to ``csr_segment_sum.launches``; the CUDA path
    trusts the layout and does not check it, so unsorted edges or stale
    ``row_bounds`` give wrong sums without an error there (build graphs with
    ``pad_graph_sorted_np``, which keeps the two together). A CPU tensor
    checks that precondition and takes ``csr_segment_sum_reference``."""
    if data.is_cuda:
        _check_cuda_args(data, receivers, row_bounds, mask)
        return _launch(data, row_bounds, mask)
    check_in_range("csr_segment_sum", "receiver", receivers, row_bounds, mask)
    return csr_segment_sum_reference(data, receivers, row_bounds.shape[1], mask)


csr_segment_sum.launches = 0
