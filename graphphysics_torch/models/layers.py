"""Core neural layers (counterpart of ``graphphysics_tpu/models/layers.py``).

Module and parameter names follow the reference PyTorch ``state_dict``
(``build_mlp`` is a Sequential: Linear layers at even indices, the RMSNorm
last), so reference-format weights load with ``load_state_dict(strict=True)``.

Every layer takes a compute ``dtype`` (None: float32), as the flax layers do.
A ``Linear`` with a dtype computes as flax's ``nn.Dense(dtype=)``: it casts
its input, weight and bias to the dtype and returns the dtype; parameters
stay float32, so state_dicts and checkpoints do not change. The casts are
explicit rather than ``torch.autocast``'s, whose per-device op lists would
round in other places on the card than on the CPU. ``RMSNorm`` computes in
its input's dtype and its f32 ``scale`` promotes the result to f32, as in
the JAX package, so the residual streams stay f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphphysics_torch.ops import halo
from graphphysics_torch.ops.attention import sparse_graph_attention
from graphphysics_torch.ops.ell_ops import ell_gather, ell_repeat, ell_segment_sum
from graphphysics_torch.ops.segment import masked_segment_sum, take_rows


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (None: as given), the
    counterpart of flax's ``nn.Dense(dtype=)``: input, weight and bias cast
    to it, the result in it. As XLA, it rounds the product to the dtype and
    then the sum with the bias; ``F.linear`` with a bias would round once."""

    def __init__(self, in_features: int, out_features: int, dtype: Optional[torch.dtype] = None,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class SplitDense(Linear):
    """A ``Linear`` over a conceptual concatenation of ``parts`` (widths
    ``in_sizes``), applied as one product per part with its slice of the
    one weight, so its parameters are those of the ``Linear`` on the
    concatenation (JAX ``SplitDense``). ``posts[i]``, where not None, maps
    part ``i``'s product before the sum: an edge gather, so that the
    product runs on node rows. Each product, then the sum with the bias,
    in the compute dtype."""

    def __init__(self, in_sizes: Tuple[int, ...], out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(sum(in_sizes), out_features, dtype)
        self.in_sizes = tuple(in_sizes)

    def forward(self, parts, posts) -> torch.Tensor:
        dt = self.compute_dtype or self.weight.dtype
        out, off = None, 0
        for part, size, post in zip(parts, self.in_sizes, posts):
            term = F.linear(part.to(dt), self.weight[:, off:off + size].to(dt))
            if post is not None:
                term = post(term)
            out = term if out is None else out + term
            off += size
        return out + self.bias.to(dt)


class RMSNorm(nn.Module):
    """``scale * x / (sqrt(max(sum(x^2), 1e-24)) * d^-0.5 + eps)``: the
    reference formula, not ``torch.nn.RMSNorm``. The ``1e-24`` floor gives an
    all-zero row (reachable through ReLU) a zero, not NaN, gradient. It
    computes in the input's dtype, ``d^-0.5`` rounded to it first as JAX
    rounds a Python constant; the f32 ``scale`` makes the result f32."""

    EPS = 1e-8

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sq = (x * x).sum(dim=-1, keepdim=True)
        rms_x = torch.sqrt(torch.clamp(sq, min=1e-24)) * torch.tensor(self.dim ** -0.5, dtype=x.dtype)
        return self.scale * (x / (rms_x + self.EPS))


class MLP(nn.Sequential):
    """Reference ``build_mlp`` with its 4 linear layers: (Linear+ReLU) x 3,
    Linear, optional RMSNorm output (which returns f32)."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int, layer_norm: bool = True,
                 dtype: Optional[torch.dtype] = None):
        layers = [Linear(in_size, hidden_size, dtype), nn.ReLU()]
        for _ in range(2):
            layers += [Linear(hidden_size, hidden_size, dtype), nn.ReLU()]
        layers.append(Linear(hidden_size, out_size, dtype))
        if layer_norm:
            layers.append(RMSNorm(out_size))
        super().__init__(*layers)


class _FusedEdgeMLP(MLP):
    """The edge ``MLP`` with its first layer a ``SplitDense`` over
    ``[edge_attr, x_receivers, x_senders]`` (JAX ``_FusedEdgeMLP``): the
    same modules and ``state_dict`` as the ``MLP`` on the concatenation."""

    def __init__(self, in_sizes: Tuple[int, ...], hidden_size: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(sum(in_sizes), hidden_size, hidden_size, dtype=dtype)
        self[0] = SplitDense(in_sizes, hidden_size, dtype)

    def forward(self, parts, posts) -> torch.Tensor:
        y = self[0](parts, posts)
        for layer in list(self)[1:]:
            y = layer(y)
        return y


class GraphNetBlock(nn.Module):
    """Message-passing block.

    Edge update: MLP on ``[edge_attr, x[receivers], x[senders]]``. Node
    update: MLP on ``[x, sum of incoming edge messages]``, the messages summed
    into their receivers. Residuals on both, in the streams' dtype (f32: the
    MLPs end in RMSNorm, so the messages reach the sum in f32).

    On an ELL graph (``ell_degree`` and ``twin_perm`` given) the gathers are
    ``ell_repeat`` and ``ell_gather`` and the sum is ``ell_segment_sum``,
    dense ops on every device; otherwise ``take_rows`` and
    ``masked_segment_sum``, which on CUDA is the segment-sum kernel and
    needs ``row_bounds``.

    ``project_before_gather`` (JAX ``GraphNetBlock``'s knob, default off):
    the edge MLP's first layer is linear, so its node terms are projected
    at node granularity and gathered after,
    ``ea @ W_e + (x @ W_r)[receivers] + (x @ W_s)[senders]``: the same
    function and the same ``state_dict``, with two of the three products on
    N rows instead of E.

    On an edge-partitioned part (``partition_axis``) the receivers are local
    and the sender rows come through the exchange (``ops.halo``: the halo
    rows, or the all-gathered table). With ``overlap_exchange`` (default
    on, as in JAX) only the sender term of the first edge layer is split
    off: ``x @ W_s`` is projected at node granularity and shipped, and the
    ``[edge_attr, x_receivers] @ W`` product runs while the halo exchange
    is in flight; the same ``state_dict``."""

    def __init__(self, hidden_size: int, dtype: Optional[torch.dtype] = None,
                 project_before_gather: bool = False, overlap_exchange: bool = True):
        super().__init__()
        self.project_before_gather = project_before_gather
        self.overlap_exchange = overlap_exchange
        # what the edge MLP's node and edge inputs pass through before the
        # gathers: nothing, or under tensor parallelism (``parallel.tp``)
        # the all-reduce of their gradients, on N node rows rather than on
        # the E gathered ones
        self.input_copy = None
        if project_before_gather:
            self.edge_block = _FusedEdgeMLP((hidden_size,) * 3, hidden_size, dtype)
        else:
            self.edge_block = MLP(3 * hidden_size, hidden_size, hidden_size, dtype=dtype)
        self.node_block = MLP(2 * hidden_size, hidden_size, hidden_size, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        edge_attr: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_mask: Optional[torch.Tensor] = None,
        row_bounds: Optional[torch.Tensor] = None,
        ell_degree: Optional[int] = None,
        twin_perm: Optional[torch.Tensor] = None,
        partition_axis: Optional[str] = None,
        halo_send_idx: Optional[torch.Tensor] = None,
        halo_dtype: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if partition_axis is not None:
            def gather_recv(p):
                return take_rows(p, receivers)

            def gather_send(p):
                return halo.partitioned_gather(p, senders, partition_axis, halo_send_idx, halo_dtype)
        elif ell_degree is not None:
            def gather_recv(p):
                return ell_repeat(p, ell_degree)

            def gather_send(p):
                return ell_gather(p, senders, twin_perm, ell_degree)
        else:
            def gather_recv(p):
                return take_rows(p, receivers)

            def gather_send(p):
                return take_rows(p, senders)

        if self.project_before_gather:
            edge_update = self.edge_block((edge_attr, x, x), (None, gather_recv, gather_send))
        elif partition_axis is not None and self.overlap_exchange:
            edge_update = self._overlapped_edge_update(
                edge_attr, x, gather_recv, senders, partition_axis, halo_send_idx, halo_dtype)
        else:
            # only the edge MLP's input passes the copy: the residuals and
            # the node MLP take x and edge_attr as they are
            ea, xe = ((edge_attr, x) if self.input_copy is None
                      else (self.input_copy(edge_attr), self.input_copy(x)))
            edge_update = self.edge_block(torch.cat([ea, gather_recv(xe), gather_send(xe)], dim=-1))
        if ell_degree is not None:
            aggr = ell_segment_sum(edge_update, ell_degree, edge_mask)
        else:
            aggr = masked_segment_sum(
                edge_update, receivers, x.shape[0], mask=edge_mask, row_bounds=row_bounds
            )
        node_update = self.node_block(torch.cat([x, aggr], dim=-1))
        return x + node_update.to(x.dtype), edge_attr + edge_update.to(edge_attr.dtype)

    def _overlapped_edge_update(self, edge_attr, x, gather_recv, senders, partition_axis,
                                halo_send_idx, halo_dtype) -> torch.Tensor:
        """The edge MLP with its first layer split as JAX's
        ``_FusedEdgeMLP((local, x), (None, gather_send))``:
        ``[edge_attr, x_r] @ W_l + (x @ W_s)[senders] + b``, each product in
        the compute dtype, summed in that order. The sender projection is
        shipped first (asynchronously in halo mode) and the local product
        computed before the received rows are needed."""
        first = self.edge_block[0]
        dt = first.compute_dtype or first.weight.dtype
        split = edge_attr.shape[-1] + x.shape[-1]
        proj = F.linear(x.to(dt), first.weight[:, split:].to(dt))  # node rows
        if halo_send_idx is not None:
            pending = halo.halo_recv(proj, halo_send_idx, partition_axis, halo_dtype, async_op=True)
        else:
            table = halo.all_gather_table(proj, partition_axis)
        local = torch.cat([edge_attr, gather_recv(x)], dim=-1)
        y = F.linear(local.to(dt), first.weight[:, :split].to(dt))
        if halo_send_idx is not None:
            table = torch.cat([proj, pending.wait()], dim=0)
        y = (y + take_rows(table, senders)) + first.bias.to(dt)
        for layer in list(self.edge_block)[1:]:
            y = layer(y)
        return y


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU. A 16-bit ``x`` goes op by op through
    ``jax.nn.gelu``'s ``0.5 * x * erfc(-x * sqrt(1/2))`` in its dtype, so it
    rounds where the JAX package does; ``F.gelu`` would round once."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return 0.5 * x * torch.special.erfc(-x * torch.tensor(0.5 ** 0.5, dtype=x.dtype))
    return F.gelu(x, approximate="none")


class GatedMLP(nn.Module):
    """GEGLU: ``gelu(linear1(x)) * linear2(x)`` with the exact (erf) GELU,
    both ``expansion_factor * hidden_size`` wide."""

    def __init__(self, in_size: int, hidden_size: int, expansion_factor: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        width = expansion_factor * hidden_size
        self.linear1 = Linear(in_size, width, dtype)
        self.linear2 = Linear(in_size, width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(self.linear1(x)) * self.linear2(x)


class GatedMLPBlock(nn.Sequential):
    """RMSNorm, GEGLU, Linear: the reference ``build_gated_mlp`` Sequential
    (``0.scale``, ``1.linear1|linear2``, ``2``)."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int, expansion_factor: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(
            RMSNorm(in_size),
            GatedMLP(in_size, hidden_size, expansion_factor, dtype),
            Linear(expansion_factor * hidden_size, out_size, dtype),
        )


class GMMHead(nn.Module):
    """Full-covariance GMM head: ``pre_proj`` (hidden -> hidden), then
    ``proj`` into ``K * (1 + d + d(d+1)/2)`` parameters per node (logit,
    mean, Cholesky lower triangle); ``pre_proj`` computes in ``dtype``, the
    final projection in f32."""

    def __init__(self, hidden_size: int, d: int, num_components: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pre_proj = Linear(hidden_size, hidden_size, dtype)
        self.proj = nn.Linear(hidden_size, num_components * self.per_component(d))

    @staticmethod
    def per_component(d: int) -> int:
        return 1 + d + d * (d + 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.pre_proj(x).to(torch.float32))


class DiagonalGMMHead(GMMHead):
    """Diagonal-covariance GMM head: ``2d + 1`` parameters per component
    (logit, mean, log std)."""

    @staticmethod
    def per_component(d: int) -> int:
        return 2 * d + 1


class Attention(nn.Module):
    """Multi-head adjacency-masked attention with the reference's quirks:
    q/k/v are read in the ``(N, head_dim, num_heads)`` layout, so head h
    holds the columns ``h, h+H, h+2H, ...``, the output goes back through the
    same layout before ``proj``, and scores are scaled by
    ``num_heads ** -0.5`` (not ``head_dim ** -0.5``).

    ``q_proj``, ``k_proj`` and ``v_proj`` are separate Linear layers; a
    reference model that shares the q weight (``use_separate_proj_weight``
    false) loads as three equal weights with their own biases, which is what
    ``export_reference_state_dict`` writes. With a ``dtype`` the projections
    return it, so q, k and v reach the attention kernels in it. With
    ``use_proj_bias`` false the q, k, v and output projections have no
    bias, as the JAX ``Attention(use_proj_bias=False)``."""

    def __init__(self, output_dim: int, num_heads: int = 4, dtype: Optional[torch.dtype] = None,
                 use_proj_bias: bool = True):
        super().__init__()
        if output_dim % num_heads:
            raise ValueError(f"output_dim {output_dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        # the scores' scale: the model's head count, which stays when a
        # tensor-parallel rank keeps only some heads (parallel.tp)
        self.scale = num_heads ** -0.5
        self.q_proj = Linear(output_dim, output_dim, dtype, bias=use_proj_bias)
        self.k_proj = Linear(output_dim, output_dim, dtype, bias=use_proj_bias)
        self.v_proj = Linear(output_dim, output_dim, dtype, bias=use_proj_bias)
        self.proj = Linear(output_dim, output_dim, dtype, bias=use_proj_bias)

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_mask: Optional[torch.Tensor] = None,
        sender_bounds: Optional[torch.Tensor] = None,
        ell_degree: Optional[int] = None,
        twin_perm: Optional[torch.Tensor] = None,
        *partition,
        gather_csr=None,
    ) -> torch.Tensor:
        """``partition``: a partitioned part's ``row_bounds``,
        ``partition_axis``, ``halo_send_idx``, ``halo_dtype``,
        ``halo_row_bounds`` and ``num_local_edges`` (``partition_fields``);
        ``gather_csr``: the graph's transposed CSR, for the bf16 backward on
        CUDA (``ops.csr_attention.gather_csr``)."""
        n = x.shape[0]
        h = self.num_heads

        def to_heads(t):  # (N, head_dim, H) layout, then [N, H, head_dim]
            return t.reshape(n, -1, h).transpose(1, 2)

        y = sparse_graph_attention(
            to_heads(self.q_proj(x)),
            to_heads(self.k_proj(x)),
            to_heads(self.v_proj(x)),
            senders,
            receivers,
            num_nodes=n,
            edge_mask=edge_mask,
            scale=self.scale,
            sender_bounds=sender_bounds,
            ell_degree=ell_degree,
            twin_perm=twin_perm,
            gather_csr=gather_csr,
            **dict(zip(PARTITION_FIELDS, partition)),
        )
        # back to the flat layout: [N, H, Dh] -> (N, Dh, H) -> [N, D]
        return self.proj(y.transpose(1, 2).reshape(n, -1))


class TransformerBlock(nn.Module):
    """Pre-norm transformer block: ``x + attention(norm1(x))``, then
    ``x + gated_mlp(norm2(x))``, each branch cast back to the residual
    stream's dtype."""

    def __init__(self, output_dim: int, num_heads: int = 4, dtype: Optional[torch.dtype] = None,
                 use_proj_bias: bool = True):
        super().__init__()
        self.attention = Attention(output_dim, num_heads, dtype, use_proj_bias)
        self.norm1 = RMSNorm(output_dim)
        self.norm2 = RMSNorm(output_dim)
        self.gated_mlp = GatedMLPBlock(output_dim, output_dim, output_dim, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_mask: Optional[torch.Tensor] = None,
        sender_bounds: Optional[torch.Tensor] = None,
        ell_degree: Optional[int] = None,
        twin_perm: Optional[torch.Tensor] = None,
        *partition,
        gather_csr=None,
    ) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), senders, receivers, edge_mask, sender_bounds,
                               ell_degree, twin_perm, *partition, gather_csr=gather_csr).to(x.dtype)
        return x + self.gated_mlp(self.norm2(x)).to(x.dtype)


# a partitioned part's fields that reach the attention, in order
PARTITION_FIELDS = ("row_bounds", "partition_axis", "halo_send_idx", "halo_dtype",
                    "halo_row_bounds", "num_local_edges")


def partition_fields(graph) -> tuple:
    """The ``PARTITION_FIELDS`` of ``graph``; all None unless it is a
    partitioned part."""
    if graph.partition_axis is None:
        return (None,) * len(PARTITION_FIELDS)
    return tuple(getattr(graph, f) for f in PARTITION_FIELDS)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every ``nn.Linear`` of ``module`` from ``generator`` with
    PyTorch's default bounds (uniform in +-1/sqrt(fan_in)), so a seed fixes
    the weights without touching the global random state."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
    return module
