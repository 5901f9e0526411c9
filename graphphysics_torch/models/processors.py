"""Processor architectures (counterpart of
``graphphysics_tpu/models/processors.py``): EncodeProcessDecode and
EncodeTransformDecode, unrolled, with the plain MLP decoder or, with
``num_mixture_components`` K > 0, a GMM head (diagonal unless
``use_diagonal`` is false) whose output the Simulator samples at eval with
``temperature`` (None reads as 1.0; 0.0 gives the chosen component's mean).

Both take the JAX models' precision and memory knobs. ``dtype`` (None:
float32; ``torch.bfloat16``) is the layers' compute dtype; parameters and
predictions stay float32. ``remat`` recomputes each block's activations in
the backward (``torch.utils.checkpoint``, the counterpart of ``nn.remat``)
instead of keeping them. ``scan_blocks`` is accepted and runs the same
unrolled loop: in the JAX package it scans one block body to keep compile
time flat in depth, "same math as the unrolled loop"; PyTorch runs eagerly
and has no such compile time, so the knob changes nothing here. A JAX
``scan_blocks`` model's weights load after
``utils.reference_weights.unstack_scanned_blocks``.

Both families read the graph's edge layout: ``row_bounds`` (EPD) or
``sender_bounds`` (transformer) for the kernels, or ``ell_degree`` and
``twin_perm`` for the ELL ops. On an edge-partitioned part (one rank's
part, ``Graph.partition_axis`` set; ``parallel``) both pass its partition
fields to every block, remat or not: the exchanges run inside the blocks
(``ops.halo``), the EPD's sums and the transformer's softmaxes over the
part's receiver ranges. The transformer takes ``use_proj_bias`` as
the JAX one does; the EPD takes GraphNetBlock's ``project_before_gather``,
which the JAX EncodeProcessDecode leaves at its default (off)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from graphphysics_torch.core.graph import Graph
from graphphysics_torch.models.layers import (
    MLP,
    DiagonalGMMHead,
    GMMHead,
    GraphNetBlock,
    TransformerBlock,
    partition_fields,
)
from graphphysics_torch.ops.csr_attention import gather_csr


def _decoder(hidden_size: int, output_size: int, num_mixture_components: int,
             use_diagonal: bool, dtype: Optional[torch.dtype]) -> nn.Module:
    """The MLP decoder (no output norm) for K = 0, else a GMM head, computing
    in ``dtype`` (the caller casts its output to f32)."""
    if num_mixture_components == 0:
        return MLP(hidden_size, hidden_size, output_size, layer_norm=False, dtype=dtype)
    head = DiagonalGMMHead if use_diagonal else GMMHead
    return head(hidden_size, output_size, num_mixture_components, dtype)


class _GMMOptions:
    """The decoder's GMM settings and the precision and memory knobs, as the
    JAX models carry them."""

    num_mixture_components: int
    temperature: Optional[float]
    use_diagonal: bool
    output_size: int
    dtype: Optional[torch.dtype]
    remat: bool
    scan_blocks: bool

    def _set_gmm(self, output_size, num_mixture_components, temperature, use_diagonal):
        self.output_size = output_size
        self.num_mixture_components = num_mixture_components
        self.temperature = temperature
        self.use_diagonal = use_diagonal

    def _set_knobs(self, dtype, remat, scan_blocks):
        self.dtype = dtype
        self.remat = bool(remat)
        self.scan_blocks = bool(scan_blocks)

    def _block(self, block: nn.Module, *args, **kwargs):
        """``block(*args, **kwargs)``, rematerialized in the backward with
        ``remat``."""
        if self.remat:
            return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)
        return block(*args, **kwargs)

    @property
    def d(self) -> int:
        return self.output_size

    @property
    def K(self) -> int:
        return self.num_mixture_components


class EncodeProcessDecode(_GMMOptions, nn.Module):
    """MeshGraphNet-style EPD: MLP encoders for nodes and edges,
    ``message_passing_num`` GraphNetBlocks, MLP decoder (no output norm) or
    GMM head. Emits float32 predictions; with a bf16 ``dtype`` the node and
    edge residual streams stay f32 (every MLP but the decoder ends in
    RMSNorm), so the segment sum reads f32 messages."""

    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        edge_input_size: int,
        output_size: int,
        hidden_size: int = 128,
        num_mixture_components: int = 0,
        temperature: Optional[float] = None,
        use_diagonal: bool = True,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        scan_blocks: bool = False,
        project_before_gather: bool = False,
    ):
        super().__init__()
        self._set_gmm(output_size, num_mixture_components, temperature, use_diagonal)
        self._set_knobs(dtype, remat, scan_blocks)
        self.nodes_encoder = MLP(node_input_size, hidden_size, hidden_size, dtype=dtype)
        self.edges_encoder = MLP(edge_input_size, hidden_size, hidden_size, dtype=dtype)
        self.processor_list = nn.ModuleList(
            GraphNetBlock(hidden_size, dtype, project_before_gather)
            for _ in range(message_passing_num)
        )
        self.decode_module = _decoder(hidden_size, output_size, num_mixture_components,
                                      use_diagonal, dtype)

    def forward(self, graph: Graph) -> torch.Tensor:
        x, _ = self.process(self.nodes_encoder(graph.x), self.edges_encoder(graph.edge_attr), graph)
        return self.decode_module(x).to(torch.float32)

    def process(self, x: torch.Tensor, edge_attr: torch.Tensor, graph: Graph, blocks=None):
        """The encoded node and edge tables through ``blocks`` (default:
        every block of ``processor_list``; a pipeline stage passes its
        own) on ``graph``'s edges."""
        for block in self.processor_list if blocks is None else blocks:
            x, edge_attr = self._block(
                block,
                x,
                edge_attr,
                graph.senders,
                graph.receivers,
                graph.edge_mask,
                graph.row_bounds,
                graph.ell_degree,
                graph.twin_perm,
                graph.partition_axis,
                graph.halo_send_idx,
                graph.halo_dtype,
            )
        return x, edge_attr


class EncodeTransformDecode(_GMMOptions, nn.Module):
    """Sparse graph transformer: MLP node encoder (with RMSNorm),
    ``message_passing_num`` pre-norm TransformerBlocks attending over the
    mesh adjacency, MLP decoder (no output norm) or GMM head. Edge features
    are not used. On CUDA the graph must carry ``sender_bounds``
    (``pad_graph_csr_np``): attention then runs the fused Hopper attention
    kernel once per block (on its bf16 entry with a bf16 ``dtype``: the
    projections give q, k and v in it; with grad on, the forward then
    builds the graph's transposed CSR once for every block's bf16
    backward); or be an ELL graph, whose attention is the dense ELL ops.
    Emits float32 predictions."""

    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        output_size: int,
        hidden_size: int = 128,
        num_heads: int = 4,
        num_mixture_components: int = 0,
        temperature: Optional[float] = None,
        use_diagonal: bool = True,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
        scan_blocks: bool = False,
        use_proj_bias: bool = True,
    ):
        super().__init__()
        self._set_gmm(output_size, num_mixture_components, temperature, use_diagonal)
        self._set_knobs(dtype, remat, scan_blocks)
        self.nodes_encoder = MLP(node_input_size, hidden_size, hidden_size, dtype=dtype)
        self.processor_list = nn.ModuleList(
            TransformerBlock(hidden_size, num_heads, dtype, use_proj_bias)
            for _ in range(message_passing_num)
        )
        self.decode_module = _decoder(hidden_size, output_size, num_mixture_components,
                                      use_diagonal, dtype)

    def forward(self, graph: Graph) -> torch.Tensor:
        x, _ = self.process(self.nodes_encoder(graph.x), None, graph)
        return self.decode_module(x).to(torch.float32)

    def process(self, x: torch.Tensor, edge_attr, graph: Graph, blocks=None):
        """The encoded node table through ``blocks`` (default: every block
        of ``processor_list``; a pipeline stage passes its own) on
        ``graph``'s edges; ``edge_attr`` passes through (the transformer
        has no edge table)."""
        transposed = self._gather_csr(graph, x)
        for block in self.processor_list if blocks is None else blocks:
            x = self._block(block, x, graph.senders, graph.receivers, graph.edge_mask,
                            graph.sender_bounds, graph.ell_degree, graph.twin_perm,
                            *partition_fields(graph), gather_csr=transposed)
        return x, edge_attr

    def _gather_csr(self, graph: Graph, x: torch.Tensor):
        """The graph's transposed CSR (``ops.csr_attention.gather_csr``),
        built once per forward for every block, where the bf16 attention's
        backward on CUDA sums over it: a CSR graph on the card, bf16, grad
        on. None elsewhere."""
        if (graph.sender_bounds is None or not x.is_cuda or self.dtype != torch.bfloat16
                or not torch.is_grad_enabled()):
            return None
        return gather_csr(graph.senders, graph.receivers, graph.sender_bounds, graph.edge_mask)
