"""Port parity of the bf16 fused attention's backward algorithm: the card's
``csr_attention_bwd_bf16`` sums dq by sender rows and dk, dv by gather
rows over the graph's transposed CSR (``ops.csr_attention.gather_csr``),
with no atomics. Here the transposed CSR itself is checked (every real
unmasked edge listed once, ascending within its gather row, padded and
masked edges nowhere), and a plain PyTorch version of the algorithm (part
A's per-edge attn and ds by sender rows, part B's sums by gather rows in
the transposed order) is held, on bf16 inputs from numpy with a seed,
against ``csr_attention_backward_reference`` and against ``jax.grad``
through the JAX ``csr_sparse_attention`` (K2 in TPU interpret mode) fed the
same bf16 arrays: both layouts, H in {1, 4}, a width of the kernels'
general geometry, masked and padded edges, nodes that no edge gathers, and
a two-graph concat batch. Also the bf16 kernels' geometry choice by width,
heads, layout and alignment. Everything runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.core import graph as jax_graph
from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_torch.core.graph import concat_graphs, pad_graph_csr_np
from graphphysics_torch.ops import csr_attention as ca
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

BF16 = torch.bfloat16
# as test_torch_port_bf16_ops.test_csr_attention_plain_bf16_matches_jax:
# JAX sums each edge's bf16 term in bf16 (its gathers' backward), the port
# in f32 and rounds once, so the two are held to bf16 accumulation's error
ATTN_GRAD_RTOL, ATTN_GRAD_ATOL = 3e-2, 3e-2
ISOLATED = (5, 17)  # nodes of graph 0 that no edge gathers in the "isolated" case


def _topology(r, n, e, isolated=()):
    senders = r.integers(0, n, e).astype(np.int32)
    keep = np.setdiff1d(np.arange(n), isolated)
    receivers = keep[r.integers(0, len(keep), e)].astype(np.int32)
    return senders, receivers


def _graphs(case, seed):
    """The port's and the JAX package's padded CSR graph of ``case`` on the
    same topology, with every tenth real edge masked (``edge_mask``): one
    300-node graph padded to 384 nodes and 2,048 edges ("padded"), the same
    with nodes ``ISOLATED`` gathered by no edge ("isolated"), or two graphs
    of 150 nodes padded to 256 and 1,024 edges, concatenated ("concat")."""
    r = np.random.default_rng(seed)
    sizes = [(150, 800, 256, 1024)] * 2 if case == "concat" else [(300, 1800, 384, 2048)]
    ports, jaxes = [], []
    for n, e, n_pad, e_pad in sizes:
        s, t = _topology(r, n, e, ISOLATED if case == "isolated" else ())
        x, pos = np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32)
        ports.append(pad_graph_csr_np(x, pos, s, t, n_pad, e_pad))
        jaxes.append(jax_graph.pad_graph_csr_np(x, pos, s, t, n_pad, e_pad))
    port, theirs = concat_graphs(ports), jax_graph.concat_graphs(jaxes)
    mask = np.asarray(port.edge_mask).copy()
    mask[np.flatnonzero(mask)[::10]] = False
    for a, b in ((port.senders, theirs.senders), (port.receivers, theirs.receivers),
                 (port.edge_mask, theirs.edge_mask)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return port.replace(edge_mask=mask), theirs.replace(edge_mask=jnp.asarray(mask))


def _tensors(port):
    return (torch.from_numpy(np.asarray(port.senders)), torch.from_numpy(np.asarray(port.receivers)),
            torch.from_numpy(np.asarray(port.sender_bounds)), torch.from_numpy(np.asarray(port.edge_mask)))


def _real(seg, bounds, mask):
    """The real unmasked edges: in their sender's range, kept by the mask."""
    ids = torch.arange(seg.shape[0])
    s = seg.long()
    return (ids >= bounds[0].long()[s]) & (ids < bounds[1].long()[s]) & mask


def plain_backward_by_gather_rows(q, k, v, seg, gather, bounds, ml, out, g, mask, scale):
    """The bf16 backward's algorithm in plain PyTorch (f32 arithmetic on the
    bf16 rows, as the kernels): part A by sender rows, per real unmasked
    edge its softmax weight attn and score gradient ds per head and dq
    summed by sender; part B by gather rows, dk and dv summed over the
    transposed CSR's slots of each node in their order (``index_add_`` on
    the CPU adds in index order), each dv term rounded to bf16 first.
    Returns ``(dq, dk, dv)`` in bf16 and the transposed CSR."""
    n, h, dh = q.shape
    e = gather.shape[0]
    q32, k32, v32, o32, g32 = (t.float() for t in (q, k, v, out, g))
    real = _real(seg, bounds, mask)
    sr, jr = seg.long()[real], gather.long()[real]

    def rows_of(t, idx):  # row gathers keep the rows' memory layout
        return t.index_select(0, idx)

    # part A: per sender row
    delta = (o32 * g32).sum(dim=-1)  # [N, H]
    k_e = rows_of(k32, jr)
    s = (rows_of(q32, sr) * k_e).sum(dim=-1) * scale
    attn = torch.exp(s - rows_of(ml[:h].t(), sr)) / (rows_of(ml[h:].t(), sr) + ca.EPS)
    ds = attn * ((rows_of(v32, jr) * rows_of(g32, sr)).sum(dim=-1) - rows_of(delta, sr))
    dq = torch.zeros(n, h, dh).index_add_(0, sr, ds[:, :, None] * scale * k_e)
    attn_e, ds_e = torch.zeros(e, h), torch.zeros(e, h)  # what part A writes per edge and head
    attn_e[real], ds_e[real] = attn, ds
    # part B: per gather row, over the transposed CSR
    tc = ca.gather_csr(seg, gather, bounds, mask)
    counts = (tc.bounds[1] - tc.bounds[0]).long()
    used = int(counts.sum())
    rows = torch.repeat_interleave(torch.arange(n), counts)
    es, ns = tc.order[:used].long(), tc.senders[:used].long()
    dk = torch.zeros(n, h, dh).index_add_(0, rows, rows_of(ds_e, es)[:, :, None] * scale * rows_of(q32, ns))
    dv = torch.zeros(n, h, dh).index_add_(
        0, rows, (rows_of(attn_e, es)[:, :, None] * rows_of(g32, ns)).to(BF16).float())
    return (dq.to(BF16), dk.to(BF16), dv.to(BF16)), tc


def _inputs(n, width, heads, layout, seed):
    """q, k, v and an output gradient, bf16 [N, H, Dh], from numpy with a
    seed, in the model's interleaved memory or contiguous."""
    r = np.random.default_rng(seed)
    arrays = [r.normal(size=(n, heads, width // heads)).astype(np.float32) for _ in range(4)]

    def port(a):
        t = torch.from_numpy(a).to(BF16)
        return t.transpose(1, 2).contiguous().transpose(1, 2) if layout == "interleaved" else t

    return arrays, [port(a) for a in arrays]


@pytest.mark.parametrize("case", ["padded", "isolated", "concat"])
def test_gather_csr_lists_every_real_unmasked_edge_once_in_order(case):
    port, _ = _graphs(case, seed=3)
    seg, gather, bounds, mask = _tensors(port)
    n, e = bounds.shape[1], gather.shape[0]
    before = ca.gather_csr.launches
    tc = ca.gather_csr(seg, gather, bounds, mask)
    assert ca.gather_csr.launches == before + 1
    assert tc.bounds.shape == (2, n) and tc.order.shape == tc.senders.shape == (e,)
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in tc)
    real = _real(seg, bounds, mask).numpy()
    g_np = gather.numpy()
    starts, ends = tc.bounds.numpy()
    np.testing.assert_array_equal(starts[1:], ends[:-1])  # ranges tile the used slots
    assert starts[0] == 0 and ends[-1] == real.sum()
    listed = []
    for j in range(n):
        edges = tc.order.numpy()[starts[j]:ends[j]]
        np.testing.assert_array_equal(edges, np.flatnonzero(real & (g_np == j)))  # ascending
        np.testing.assert_array_equal(tc.senders.numpy()[starts[j]:ends[j]], seg.numpy()[edges])
        listed.extend(edges)
    assert sorted(listed) == list(np.flatnonzero(real))  # each real unmasked edge once
    assert not np.isin(listed, np.flatnonzero(~np.asarray(port.edge_mask))).any()
    if case == "isolated":
        assert all(starts[j] == ends[j] for j in ISOLATED)
    padding = np.r_[800:1024, 1824:2048] if case == "concat" else np.r_[1800:2048]
    assert not np.isin(listed, padding).any()  # padding edges lie in no range


@pytest.mark.parametrize("case,width,heads,layout", [
    ("padded", 64, 4, "interleaved"),   # the model's (N, Dh, H) view, the 16-byte geometry
    ("padded", 64, 4, "blocked"),       # contiguous [N, H, Dh]
    ("isolated", 64, 1, "interleaved"),  # one head
    ("isolated", 48, 4, "interleaved"),  # the kernels' word geometry
    ("concat", 64, 4, "interleaved"),
    ("concat", 32, 1, "blocked"),
])
def test_gather_rows_backward_matches_the_reference(case, width, heads, layout):
    """The algorithm's (dq, dk, dv) equal ``csr_attention_backward_reference``
    bit for bit: f32 arithmetic at the same places, and its ``index_add_``
    over all edges in ascending id adds each gather row's terms in the
    transposed CSR's order (masked edges add zeros); nodes that no edge
    gathers get exactly 0."""
    port, _ = _graphs(case, seed=width + heads)
    seg, gather, bounds, mask = _tensors(port)
    n = bounds.shape[1]
    _, (q, k, v, cot) = _inputs(n, width, heads, layout, seed=width * heads + 7)
    scale = heads ** -0.5
    out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale)
    grads, _ = plain_backward_by_gather_rows(q, k, v, seg, gather, bounds, ml, out, cot, mask, scale)
    want = ca.csr_attention_backward_reference(q, k, v, seg, gather, ml, out, cot, mask, scale)
    for got, theirs, name in zip(grads, want, "qkv"):
        assert got.dtype == BF16 and theirs.dtype == BF16
        torch.testing.assert_close(got, theirs, rtol=0, atol=0, msg=f"d{name}")
    if case == "isolated":
        for t in grads[1:]:
            assert torch.equal(t[list(ISOLATED)].float(), torch.zeros(len(ISOLATED), heads, width // heads))
    assert ca.bf16_geometry(width, heads, layout == "interleaved")[1] == ("words" if width == 48 else "fast")


@pytest.mark.parametrize("case,width,heads,layout", [
    ("padded", 64, 4, "interleaved"),
    ("padded", 64, 4, "blocked"),
    ("isolated", 64, 1, "interleaved"),
    ("isolated", 48, 4, "interleaved"),
    ("concat", 64, 4, "interleaved"),
])
def test_gather_rows_backward_matches_jax(case, width, heads, layout):
    """The algorithm's (dq, dk, dv) against ``jax.grad`` through the JAX
    ``csr_sparse_attention`` on the same bf16 q, k, v and cotangent (the
    forward's out and ml from the port's plain forward, which
    test_torch_port_bf16_ops holds against JAX)."""
    port, theirs = _graphs(case, seed=width + heads + 1)
    seg, gather, bounds, mask = _tensors(port)
    n = bounds.shape[1]
    arrays, (q, k, v, cot) = _inputs(n, width, heads, layout, seed=width * heads + 11)
    scale = heads ** -0.5
    jqkv = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]]
    jcot = jnp.asarray(arrays[3]).astype(jnp.bfloat16).astype(jnp.float32)

    def jax_fn(a, b, c):
        return jax_pa.csr_sparse_attention(a, b, c, theirs.senders, theirs.receivers, theirs.csr_bounds,
                                           theirs.edge_mask, scale=scale, max_chunks=theirs.csr_max_chunks)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: (jax_fn(*a).astype(jnp.float32) * jcot).sum(), argnums=(0, 1, 2))(*jqkv)
    out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale)
    grads, _ = plain_backward_by_gather_rows(q, k, v, seg, gather, bounds, ml, out, cot, mask, scale)
    for got, theirs_grad, name in zip(grads, want, "qkv"):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(theirs_grad, np.float32),
                                   rtol=ATTN_GRAD_RTOL, atol=ATTN_GRAD_ATOL, err_msg=f"d{name}")


def test_bf16_geometry_takes_16_byte_lanes_where_width_and_alignment_allow():
    """The bf16 forward runs 8 columns (16 bytes) a lane where D % 8 == 0,
    D / 8 lanes in {4, 8, 16, 32} split the heads into power-of-two
    partials and every row base is 16-byte aligned (16 columns a lane at
    D = 512), the backward 16 columns a lane where it can; the word
    geometry (one word of 8 or 4 columns a lane, ``bf16_word_geometry``)
    where its lanes hold the row, the general geometry elsewhere, listed
    last; nothing past 512 or with H not dividing D."""
    assert ca.bf16_geometry(128, 4, True) == (16, "fast")  # the panels width: 2 rows a warp
    assert ca.bf16_geometry(128, 4, False) == (16, "fast")
    assert ca.bf16_geometry(64, 4, True) == (8, "fast")  # c-a-gmm and the large mesh
    assert ca.bf16_geometry(32, 8, True) == (4, "fast")
    assert ca.bf16_geometry(512, 4, True) == (32, "fast")  # 16 columns a lane
    assert ca.bf16_geometries(128, 4, True) == [(16, "fast"), (8, "fast"), (16, "words"), (32, "general")]
    # the backward prefers 16 columns a lane: 8 lanes a row at D = 128
    assert ca.bf16_geometry(128, 4, True, backward=True) == (8, "fast")
    assert ca.bf16_geometry(64, 4, True, backward=True) == (4, "fast")
    assert ca.bf16_geometry(48, 4, True, backward=True) == (8, "words")  # the same lanes both ways
    assert ca.bf16_geometry(128, 4, True, aligned=False) == (32, "words")  # 8-byte rows: 4-column words
    assert ca.bf16_geometry(48, 4, True) == (8, "words")  # 6 16-byte words: not a power of two
    assert ca.bf16_geometry(96, 3, True) == (16, "words")  # 3 heads
    assert ca.bf16_geometry(40, 8, True) == (8, "words")  # D % 8 == 0, 5 words
    assert ca.bf16_geometry(36, 4, False) == (16, "words")  # D % 8 != 0: 9 8-byte words
    assert ca.bf16_geometries(512, 8, True) == [(32, "fast"), (32, "general")]  # 64 words: past 32 lanes
    assert ca.bf16_geometries(264, 4, True) == [(32, "general")]  # 33 words
    assert ca.bf16_geometry(1024, 4, True) is None and ca.bf16_geometry(30, 4, True) is None


def test_bf16_backward_needs_the_transposed_csr():
    """The bf16 backward on the card sums dk and dv over the transposed CSR
    and raises without it or with one of another graph: no atomic path to
    fall back to."""
    port, _ = _graphs("padded", seed=0)
    seg, gather, bounds, mask = _tensors(port)
    n, e = bounds.shape[1], gather.shape[0]
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match="gather_csr"):
        ca._check_gather("t", None, n, e, dev)
    tc = ca.gather_csr(seg, gather, bounds, mask)
    ca._check_gather("t", tc, n, e, dev)
    with pytest.raises(ValueError, match="order must be a contiguous int32"):
        ca._check_gather("t", tc._replace(order=tc.order[:-1]), n, e, dev)
    with pytest.raises(ValueError, match="bounds must be a contiguous int32"):
        ca._check_gather("t", tc._replace(bounds=tc.bounds.long()), n, e, dev)
