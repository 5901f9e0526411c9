"""Port parity, fused CSR attention: ``csr_attention`` (the autograd
Function whose CUDA kernels fuse the gathers, the per-edge scores, the
softmax and the weighted sum; on the CPU its plain versions) against the
JAX ``csr_sparse_attention`` with its Pallas kernel in interpret mode,
forward and ``jax.vjp``, with q, k and v given both as contiguous
``[N, H, Dh]`` tensors and as the ``(N, Dh, H)`` transposed views the
model's ``Attention`` passes; ``csr_attention_backward_reference`` against
autograd of ``csr_attention_reference``; a float64 gradient check; and the
layout helpers the CUDA wrappers use. Layouts come from the port's padding:
``n_pad == n``, empty rows and a two-graph concatenation, with masked edges
inside the ranges. Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_torch.core.graph import pad_graph_csr_np
from graphphysics_torch.ops.csr_attention import (
    NEG,
    _geometry_ok,
    _in_layout,
    _is_interleaved,
    csr_attention,
    csr_attention_backward,
    csr_attention_backward_reference,
    csr_attention_reference,
    csr_softmax_spmm,
    csr_softmax_spmm_backward,
    csr_sparse_attention,
    lanes_per_row,
)
from tests._torch_port_common import LAYOUTS, layout_graphs, mask_some_edges

# forward: f32 sums in another order (online softmax in the TPU kernel, two
# passes here); gradients: dk and dv are segment sums of per-edge terms over
# the receivers, as tests/test_torch_port_backward.py
RTOL, ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
H, DH = 4, 8


def _inputs(layout, seed):
    g = layout_graphs(pad_graph_csr_np, layout, seed=seed, n_pad=128)
    r = np.random.default_rng(seed + 1)
    q, k, v, cot = (r.normal(size=(g.num_nodes, H, DH)).astype(np.float32) for _ in range(4))
    return g, mask_some_edges(g), (q, k, v), cot


def _as_model_view(a: np.ndarray) -> torch.Tensor:
    """``a`` ([N, H, Dh]) as the model's Attention holds it: the transpose of
    a contiguous (N, Dh, H) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).transpose(1, 2)


def _jax_attention(g, mask, qkv, cot, scale):
    bounds = jax_pa.compute_block_bounds(g.senders, g.num_nodes)

    def fn(q, k, v):
        return jax_pa.csr_sparse_attention(
            q, k, v, jnp.asarray(g.senders), jnp.asarray(g.receivers), jnp.asarray(bounds),
            edge_mask=jnp.asarray(mask), scale=scale,
            max_chunks=jax_pa.compute_max_chunks_bounds(bounds),
        )

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in qkv))
        grads = vjp(jnp.asarray(cot))
    return np.asarray(want), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("view", ["contiguous", "model_view"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fused_attention_matches_jax(layout, view):
    g, mask, qkv, cot = _inputs(layout, seed=21)
    scale = H ** -0.5
    want, want_grads = _jax_attention(g, mask, qkv, cot, scale)

    make = torch.from_numpy if view == "contiguous" else _as_model_view
    ts = [make(a).requires_grad_(True) for a in qkv]
    assert all(_is_interleaved(t) is (view == "model_view") for t in ts)
    counters = (csr_attention, csr_attention_backward, csr_softmax_spmm, csr_softmax_spmm_backward)
    before = [c.launches for c in counters]
    out, ml = csr_attention(*ts, torch.from_numpy(g.senders), torch.from_numpy(g.receivers),
                            torch.from_numpy(g.sender_bounds), torch.from_numpy(mask), scale)
    assert not ml.requires_grad
    out.backward(torch.from_numpy(cot))
    assert [c.launches for c in counters] == before  # the CPU launches no kernel
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    for name, t, w in zip("qkv", ts, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    # rows without an unmasked edge: out 0, m = -1e30, l = 0, dq 0
    live = np.zeros(g.num_nodes, bool)
    live[g.senders[mask]] = True
    assert np.all(out.detach().numpy()[~live] == 0) and np.all(ts[0].grad.numpy()[~live] == 0)
    assert np.all(ml.numpy()[:H, ~live] == np.float32(NEG)) and np.all(ml.numpy()[H:, ~live] == 0)
    if layout == "empty_rows":
        assert (~live).sum() > 50
    # the public attention is the same function
    got = csr_sparse_attention(*(t.detach() for t in ts), torch.from_numpy(g.senders),
                               torch.from_numpy(g.receivers), torch.from_numpy(g.sender_bounds),
                               edge_mask=torch.from_numpy(mask), scale=scale)
    torch.testing.assert_close(got, out.detach(), rtol=0, atol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_reference_is_autograd_of_the_plain_forward(layout):
    g, mask, qkv, cot = _inputs(layout, seed=23)
    args = (torch.from_numpy(g.senders), torch.from_numpy(g.receivers))
    mask_t = torch.from_numpy(mask)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in qkv]
    out, ml = csr_attention_reference(*ts, *args, g.num_nodes, mask_t, 0.7)
    want = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    got = csr_attention_backward_reference(*(t.detach() for t in ts), *args, ml, out.detach(),
                                           torch.from_numpy(cot), mask_t, 0.7)
    # the delta identity against the softmax's own backward: f32 reassociation
    for a, b, name in zip(got, want, "qkv"):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL, msg=name)
    # the public backward on CPU tensors is the same function
    again = csr_attention_backward(*(t.detach() for t in ts), *args, torch.from_numpy(g.sender_bounds),
                                   ml, out.detach(), torch.from_numpy(cot), mask_t, 0.7)
    for a, b in zip(again, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("view", ["contiguous", "model_view"])
def test_fused_attention_gradcheck_f64(view):
    g = layout_graphs(pad_graph_csr_np, "two_graphs", seed=25, n_pad=128, size=16)
    r = np.random.default_rng(26)
    qkv = [r.normal(size=(g.num_nodes, 2, 2)) for _ in range(3)]
    make = torch.from_numpy if view == "contiguous" else _as_model_view
    ts = [make(a).requires_grad_(True) for a in qkv]
    args = (torch.from_numpy(g.senders), torch.from_numpy(g.receivers),
            torch.from_numpy(g.sender_bounds), torch.from_numpy(mask_some_edges(g)))
    assert torch.autograd.gradcheck(lambda q, k, v: csr_attention(q, k, v, *args, 0.7)[0], ts)


def test_layout_helpers():
    """The layouts and lane geometries the CUDA wrappers accept."""
    base = torch.zeros(6, 8, 4)  # (N, Dh, H)
    assert _is_interleaved(base.transpose(1, 2)) is True
    assert _is_interleaved(torch.zeros(6, 4, 8)) is False
    assert _is_interleaved(torch.zeros(6, 8, 4).permute(2, 0, 1)) is None
    g = torch.arange(6 * 32.0).reshape(6, 4, 8)
    for interleaved in (False, True):
        got = _in_layout(g, interleaved)
        assert _is_interleaved(got) is interleaved and torch.equal(got, g)
    # the model's widths, both layouts; the widest D; 3 columns a lane
    assert lanes_per_row(128, 4, True) and lanes_per_row(128, 4, False)
    assert lanes_per_row(64, 4, True) and lanes_per_row(512, 8, True)
    assert lanes_per_row(96, 4, False, backward=True) == 32
    assert lanes_per_row(96, 4, True, backward=True) == 8  # the only lane count that takes it
    assert lanes_per_row(128, 4, True) == 8 and lanes_per_row(128, 4, True, backward=True) == 32
    assert not any(_geometry_ok(g, 96, 3, False) for g in (8, 16, 32))  # head_dim 32, 3 columns
    assert not _geometry_ok(8, 512, 8, True)  # 64 columns a lane
