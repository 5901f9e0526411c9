"""Port parity, backward: the gradients of ``csr_segment_sum``,
``csr_softmax_spmm`` and ``csr_sparse_attention`` (CPU path: the plain
backward versions inside ``torch.autograd.Function``) against ``jax.vjp`` of
the JAX package's functions with their Pallas kernels in interpret mode; the
plain backward versions against autograd of the plain forwards; gradient
checks in float64; and the gradients of ``take_rows``, ``masked_segment_sum``
and ``segment_softmax`` against JAX's. Layouts come from the port's padding:
empty rows, ``n_pad == n`` (padded edges are masked self-loops on the real
last node) and a two-graph concatenation (padding between real edges), with
masked edges inside the ranges too. Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_tpu.ops import pallas_segment as jax_ps
from graphphysics_tpu.ops import segment as jax_seg
from graphphysics_torch.core.graph import concat_graphs, pad_graph_csr_np, pad_graph_sorted_np
from graphphysics_torch.ops.csr_attention import (
    csr_softmax_spmm,
    csr_softmax_spmm_backward,
    csr_softmax_spmm_backward_reference,
    csr_softmax_spmm_reference,
    csr_sparse_attention,
)
from graphphysics_torch.ops.csr_segment import (
    csr_segment_sum,
    csr_segment_sum_backward,
    csr_segment_sum_backward_reference,
    csr_segment_sum_reference,
)
from graphphysics_torch.ops.segment import masked_segment_sum, segment_softmax, take_rows
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# f32 sums of the same terms in another order (XLA / the Pallas kernel vs
# ATen), as the forward tests
RTOL, ATOL = 1e-5, 1e-5
SUM_ATOL = 1e-4  # segment sums of ~10 N(0,1) rows

LAYOUTS = ["n_pad_eq_n", "empty_rows", "two_graphs"]


def _graphs(pad, layout, seed, n_pad, size=None):
    """Graphs of one of ``LAYOUTS`` padded with ``pad``: n_pad == n with
    padding edges on the real last node; every edge into the first few
    nodes (most rows empty); or two graphs of other sizes concatenated.
    ``size`` (default ``n_pad``) scales the real nodes and edges of the
    last, for the small graphs of the gradient checks."""
    r = np.random.default_rng(seed)
    size = n_pad if size is None else size

    def one(n, e, hi=None):
        ends = r.integers(0, n if hi is None else hi, e).astype(np.int32)
        other = r.integers(0, n, e).astype(np.int32)
        s, recv = (other, ends) if pad is pad_graph_sorted_np else (ends, other)
        return pad(np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32), s, recv,
                   n_pad, 6 * size)

    if layout == "n_pad_eq_n":
        return one(n_pad, 5 * size)
    if layout == "empty_rows":
        return one(n_pad - n_pad // 6, 4 * size, hi=9)
    return concat_graphs([one(size - size // 8, 5 * size), one(3 * size // 4, 4 * size)])


def _mask(g):
    mask = g.edge_mask.copy()
    mask[::7] = False  # masked edges inside the ranges too
    return mask


# ---------------------------------------------------------------- K1 and K1b


@pytest.mark.parametrize("layout", LAYOUTS)
def test_csr_segment_sum_gradient_matches_jax(layout):
    g = _graphs(pad_graph_sorted_np, layout, seed=1, n_pad=48)
    mask = _mask(g)
    n, h = g.num_nodes, 16
    r = np.random.default_rng(2)
    data = r.normal(size=(g.num_edges, h)).astype(np.float32)
    cot = r.normal(size=(n, h)).astype(np.float32)

    # the JAX caller zeroes masked data; its kernel takes ascending receivers
    offsets = jax_ps.compute_block_offsets(g.receivers, n)

    def jax_fn(d):
        return jax_ps.csr_segment_sum(
            jnp.where(jnp.asarray(mask)[:, None], d, 0.0), jnp.asarray(g.receivers),
            jnp.asarray(offsets), n, max_chunks=jax_ps.compute_max_chunks(offsets),
        )

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fn, jnp.asarray(data))
        (want_grad,) = vjp(jnp.asarray(cot))

    d = torch.from_numpy(data).requires_grad_(True)
    before = (csr_segment_sum.launches, csr_segment_sum_backward.launches)
    out = csr_segment_sum(d, torch.from_numpy(g.receivers), torch.from_numpy(g.row_bounds),
                          torch.from_numpy(mask))
    out.backward(torch.from_numpy(cot))
    assert (csr_segment_sum.launches, csr_segment_sum_backward.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=RTOL, atol=SUM_ATOL)
    got = d.grad.numpy()
    # JAX gathers for every edge; the port gives exactly 0 off the real
    # unmasked edges (the JAX caller's upstream zeroing stops it there)
    np.testing.assert_array_equal(got[mask], np.asarray(want_grad)[mask])
    assert np.all(got[~mask] == 0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_segment_sum_backward_reference_is_autograd_of_the_plain_forward(layout):
    g = _graphs(pad_graph_sorted_np, layout, seed=3, n_pad=40)
    mask = torch.from_numpy(_mask(g))
    recv, bounds = torch.from_numpy(g.receivers), torch.from_numpy(g.row_bounds)
    gen = torch.Generator().manual_seed(0)
    data = torch.randn(g.num_edges, 8, generator=gen, requires_grad=True)
    cot = torch.randn(g.num_nodes, 8, generator=gen)
    (want,) = torch.autograd.grad(
        csr_segment_sum_reference(data, recv, g.num_nodes, mask), data, cot
    )
    got = csr_segment_sum_backward_reference(cot, recv, bounds, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the public wrapper on the CPU is the same function
    torch.testing.assert_close(csr_segment_sum_backward(cot, recv, bounds, mask), got, rtol=0, atol=0)


def test_segment_sum_backward_zeroes_edges_outside_every_range():
    """Padding edges lie outside every range even when unmasked: 0 there."""
    recv = torch.tensor([0, 0, 2, 2, 2, 2], dtype=torch.int32)  # last 2: padding
    bounds = torch.tensor([[0, 2, 2], [2, 2, 4]], dtype=torch.int32)
    g = torch.arange(6.0).reshape(3, 2)
    got = csr_segment_sum_backward_reference(g, recv, bounds)
    torch.testing.assert_close(got, torch.tensor([[0.0, 1], [0, 1], [4, 5], [4, 5], [0, 0], [0, 0]]))


def test_segment_sum_gradcheck_f64():
    g = _graphs(pad_graph_sorted_np, "two_graphs", seed=4, n_pad=24)
    args = (torch.from_numpy(g.receivers), torch.from_numpy(g.row_bounds),
            torch.from_numpy(_mask(g)))
    data = torch.randn(g.num_edges, 3, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    assert torch.autograd.gradcheck(lambda d: csr_segment_sum(d, *args), (data.requires_grad_(),))


# ---------------------------------------------------------------- K2 and K3


def _attention_inputs(layout, seed, h=4, dh=8, size=None):
    g = _graphs(pad_graph_csr_np, layout, seed=seed, n_pad=128, size=size)
    r = np.random.default_rng(seed + 1)
    scores = (3 * r.normal(size=(g.num_edges, h))).astype(np.float32)
    values = r.normal(size=(g.num_edges, h * dh)).astype(np.float32)
    cot = r.normal(size=(g.num_nodes, h * dh)).astype(np.float32)
    return g, _mask(g), scores, values, cot


def _jax_softmax_spmm(g, mask, n):
    """JAX ``csr_softmax_spmm`` fed as its ``csr_sparse_attention`` feeds
    it: masked edges carry score -1e30 and segment N."""
    seg = np.where(mask, g.senders, n).astype(np.int32)
    bounds = jax_pa.compute_block_bounds(g.senders, n)
    mc = jax_pa.compute_max_chunks_bounds(bounds)

    def fn(s, v):
        s = jnp.where(jnp.asarray(mask)[:, None], s, jax_pa._NEG)
        return jax_pa.csr_softmax_spmm(s, v, jnp.asarray(seg), jnp.asarray(bounds), n, max_chunks=mc)

    return fn


@pytest.mark.parametrize("layout", LAYOUTS)
def test_csr_softmax_spmm_gradient_matches_jax(layout):
    g, mask, scores, values, cot = _attention_inputs(layout, seed=5)
    n = g.num_nodes
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(_jax_softmax_spmm(g, mask, n), jnp.asarray(scores), jnp.asarray(values))
        want_ds, want_dv = vjp(jnp.asarray(cot))

    s = torch.from_numpy(scores).requires_grad_(True)
    v = torch.from_numpy(values).requires_grad_(True)
    before = (csr_softmax_spmm.launches, csr_softmax_spmm_backward.launches)
    out, ml = csr_softmax_spmm(s, v, torch.from_numpy(g.senders), torch.from_numpy(g.sender_bounds),
                               torch.from_numpy(mask))
    assert not ml.requires_grad
    out.backward(torch.from_numpy(cot))
    assert (csr_softmax_spmm.launches, csr_softmax_spmm_backward.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_ds), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_dv), rtol=RTOL, atol=ATOL)
    # masked edges and padding: exactly 0 and no NaN
    assert np.all(s.grad.numpy()[~mask] == 0) and np.all(v.grad.numpy()[~mask] == 0)
    empty = (g.sender_bounds[0] == g.sender_bounds[1])
    if layout == "empty_rows":
        assert empty.sum() > 50 and np.all(ml.numpy()[4:, empty] == 0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_softmax_spmm_backward_reference_is_autograd_of_the_plain_forward(layout):
    g, mask, scores, values, cot = _attention_inputs(layout, seed=7)
    mask_t = torch.from_numpy(mask)
    seg = torch.from_numpy(g.senders)
    s = torch.from_numpy(scores).requires_grad_(True)
    v = torch.from_numpy(values).requires_grad_(True)
    out, ml = csr_softmax_spmm_reference(s, v, seg, g.num_nodes, mask_t)
    want = torch.autograd.grad(out, (s, v), torch.from_numpy(cot))
    got = csr_softmax_spmm_backward_reference(
        s.detach(), v.detach(), seg, ml, out.detach(), torch.from_numpy(cot), mask_t
    )
    # the delta identity against the softmax's own backward: f32 reassociation
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_softmax_spmm_gradcheck_f64():
    g, mask, scores, values, _ = _attention_inputs("two_graphs", seed=9, h=2, dh=2, size=16)
    args = (torch.from_numpy(g.senders), torch.from_numpy(g.sender_bounds), torch.from_numpy(mask))
    s = torch.from_numpy(scores[:, :2]).double().contiguous().requires_grad_(True)
    v = torch.from_numpy(values[:, :4]).double().contiguous().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: csr_softmax_spmm(a, b, *args)[0], (s, v))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_csr_sparse_attention_gradient_matches_jax(layout):
    g = _graphs(pad_graph_csr_np, layout, seed=11, n_pad=128)
    mask = _mask(g)
    n, h, dh = g.num_nodes, 4, 8
    r = np.random.default_rng(12)
    q, k, v = (r.normal(size=(n, h, dh)).astype(np.float32) for _ in range(3))
    cot = r.normal(size=(n, h, dh)).astype(np.float32)
    bounds = jax_pa.compute_block_bounds(g.senders, n)

    def jax_fn(q, k, v):
        return jax_pa.csr_sparse_attention(
            q, k, v, jnp.asarray(g.senders), jnp.asarray(g.receivers), jnp.asarray(bounds),
            edge_mask=jnp.asarray(mask), scale=0.5, max_chunks=jax_pa.compute_max_chunks_bounds(bounds),
        )

    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want_grads = vjp(jnp.asarray(cot))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = csr_sparse_attention(*ts, torch.from_numpy(g.senders), torch.from_numpy(g.receivers),
                               torch.from_numpy(g.sender_bounds), edge_mask=torch.from_numpy(mask),
                               scale=0.5)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for name, t, w in zip("qkv", ts, want_grads):
        # dk and dv are segment sums of per-edge terms over the receivers
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=name)


def test_csr_sparse_attention_gradcheck_f64():
    g = _graphs(pad_graph_csr_np, "two_graphs", seed=13, n_pad=128, size=16)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(g.num_nodes, 2, 2, dtype=torch.float64, generator=gen).requires_grad_()
               for _ in range(3))
    args = (torch.from_numpy(g.senders), torch.from_numpy(g.receivers),
            torch.from_numpy(g.sender_bounds))
    mask = torch.from_numpy(_mask(g))

    def fn(q, k, v):
        return csr_sparse_attention(q, k, v, *args, edge_mask=mask, scale=0.7)

    assert torch.autograd.gradcheck(fn, (q, k, v))


# ---------------------------------------------------------------- plain ops


def test_plain_segment_op_gradients_match_jax():
    """f32 backward of ``take_rows`` and of the CPU ``masked_segment_sum``
    (no row bounds) and ``segment_softmax``: autograd of plain ops."""
    r = np.random.default_rng(14)
    n, e, h = 30, 120, 6
    x = r.normal(size=(n, h)).astype(np.float32)
    idx = r.integers(0, n, e).astype(np.int32)
    data = r.normal(size=(e, h)).astype(np.float32)
    scores = (2 * r.normal(size=(e, 4))).astype(np.float32)
    seg = r.integers(0, n - 5, e).astype(np.int32)  # rows n-5.. empty
    mask = r.random(e) > 0.2
    cot_rows = r.normal(size=(e, h)).astype(np.float32)
    cot_nodes = r.normal(size=(n, h)).astype(np.float32)
    cot_edges = r.normal(size=(e, 4)).astype(np.float32)
    jm, jidx, jseg = jnp.asarray(mask), jnp.asarray(idx), jnp.asarray(seg)

    cases = [
        (lambda a: jax_seg.take_rows(a, jidx), lambda a: take_rows(a, torch.from_numpy(idx)),
         x, cot_rows),
        (lambda a: jax_seg.masked_segment_sum(a, jseg, n, mask=jm),
         lambda a: masked_segment_sum(a, torch.from_numpy(seg), n, mask=torch.from_numpy(mask)),
         data, cot_nodes),
        (lambda a: jax_seg.segment_softmax(a, jseg, n, mask=jm),
         lambda a: segment_softmax(a, torch.from_numpy(seg), n, mask=torch.from_numpy(mask)),
         scores, cot_edges),
    ]
    for jax_fn, port_fn, arg, cot in cases:
        _, vjp = jax.vjp(jax_fn, jnp.asarray(arg))
        (want,) = vjp(jnp.asarray(cot))
        t = torch.from_numpy(arg).requires_grad_(True)
        port_fn(t).backward(torch.from_numpy(cot))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=RTOL, atol=SUM_ATOL)
