"""Port parity, the fused bf16 attention's word geometry, on the CPU:

- ``csr_attention.bf16_word_geometry`` and ``bf16_geometries``, the rule by
  which the bf16 entries take the word geometry of
  ``csrc/csr_attention_bf16_words.cu`` (one word of 8 bf16 columns, 16
  bytes, where D % 8 == 0 and every row base is 16-byte aligned, else of 4;
  P per-head partials reduce-scattered to one head a lane) at the widths
  without their 16-byte geometry, held to the constants, the column choice
  and the instantiations of ``csrc/attention_words.cuh`` for every
  D <= 512; the widths past its lanes or heads keep the general
  geometry.
- The word geometry's order emulated in numpy f32 on bf16 values (a
  lane's per-head partials in column order, the butterfly over its row's
  lanes, the online softmax a head in windows of the kernel's edges, out
  rounded to bf16 once; part A's attn and ds a head and dq by sender rows,
  part B's dk and dv by gather rows over the transposed CSR, each dv term
  rounded to bf16), held against the JAX package's ``csr_sparse_attention``
  (its K2 in TPU interpret mode) and its gradient, and against the port's
  plain versions, on one padded CSR graph with a hub row, masked edges and
  nodes no edge gathers, both layouts; the stream twin at 48 x 4.
- A ``"precision": "bf16"`` transformer at hidden 48 (the word geometry's
  width on the card) against the JAX model: the eval forward and each
  parameter's gradient of one step, at tolerances measured for bf16
  round-off through 3 blocks at widths other than 32 (``WIDTH_*_RTOL``).

Inputs come from numpy with a seed and go to both sides."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.core import graph as jax_graph
from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_torch.core.graph import pad_graph_csr_np
from graphphysics_torch.ops import csr_attention as ca
from graphphysics_torch.ops.csr_segment import WARP
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)
from tests import test_torch_port_precision as precision
from tests.test_torch_port_bf16_ops import ATTN_FWD_ATOL, ATTN_GRAD_ATOL, ATTN_GRAD_RTOL
from tests.test_torch_port_cuda import BF16_ATOL, BF16_DV_TERM, BF16_RTOL

CSRC = Path(ca.__file__).resolve().parents[1] / "csrc"
HEADER = CSRC / "attention_words.cuh"
HEADS = CSRC / "word_heads.cuh"  # the head sums and the rule, shared with K3's words
SOURCE = CSRC / "csr_attention_bf16_words.cu"
BF16 = torch.bfloat16

# (D, H, layout, aligned) -> (W, L, P, ALIGNED, lo, hi) of the bf16 word
# geometry, which both directions take (no 16-byte geometry there)
RULE_CASES = [
    # 6 16-byte words: 8 lanes, 2 idle, 4 rows a warp; column i in head i % 4
    ((48, 4, "model", True), (8, 8, 4, True, 1, 8)),
    ((48, 4, "contiguous", True), (8, 8, 4, False, 1, 8)),  # heads of 12: the select
    # 12 words, 3 heads: the select
    ((96, 3, "model", True), (8, 16, 4, False, 1, 16)),
    ((96, 3, "contiguous", True), (8, 16, 1, True, 1, 4)),  # a head's 4 lanes
    # 5 words, 8 heads: one head a column of the lane
    ((40, 8, "model", True), (8, 8, 8, True, 1, 8)),
    ((40, 8, "contiguous", True), (8, 8, 8, False, 1, 8)),
    # D % 8 == 4: 8-byte words, an odd count of them
    ((20, 4, "model", True), (4, 8, 4, True, 1, 8)),
    ((36, 4, "model", True), (4, 16, 4, True, 1, 16)),
    ((36, 4, "contiguous", True), (4, 16, 4, False, 1, 16)),
    ((20, 1, "model", True), (4, 8, 1, True, 1, 8)),
    # rows only 8-byte aligned: 8-byte words
    ((48, 4, "model", False), (4, 16, 4, True, 1, 16)),
    ((128, 4, "model", False), (4, 32, 4, True, 1, 32)),
    # 16 heads: interleaved lanes s and s ^ 1 hold other heads
    ((128, 16, "model", True), (8, 16, 8, True, 2, 16)),
    ((96, 12, "model", True), (8, 16, 16, False, 1, 16)),  # the most partials a lane keeps
    ((8, 1, "model", True), (8, 1, 1, True, 1, 1)),  # one lane a row
]
# (D, H, layout, aligned): the general geometry alone (past 32 lanes of
# words, or past 16 heads)
GENERAL_CASES = [(264, 4, "model", True), (260, 4, "model", True), (136, 4, "model", False),
                 (68, 17, "model", True), (68, 17, "contiguous", True)]


def _window():
    """The edges whose words a lane has in flight (the header's kEdges)."""
    return int(re.search(r"constexpr int kEdges = (\d+);", HEADER.read_text()).group(1))


@pytest.mark.parametrize("case,want", RULE_CASES)
def test_bf16_word_geometry_rule(case, want):
    width, heads, layout, aligned = case
    interleaved = layout == "model"
    g = ca.bf16_word_geometry(width, heads, interleaved, aligned)
    assert tuple(g) == want
    # whole words fill the row; the reduce-scatter's levels fit below hi
    assert width % g.cols == 0 and g.lanes * g.cols >= width and g.cols in ca.BF16_WORD_COLUMNS
    assert g.partials == 1 or g.lo * g.partials <= g.hi
    for backward in (False, True):
        kinds = ca.bf16_geometries(width, heads, interleaved, aligned, backward)
        fast = [k for k in kinds if k[1] == "fast"]
        assert kinds[len(fast):] == [(g.lanes, "words"), (kinds[-1][0], "general")]
        assert ca.bf16_geometry(width, heads, interleaved, aligned, backward) == (kinds[0])
        assert bool(fast) is (width == 128 and heads == 16 and aligned)  # 16 lanes of 8: fast


@pytest.mark.parametrize("width,heads,layout,aligned", GENERAL_CASES)
def test_general_geometry_keeps_what_the_bf16_words_cannot_hold(width, heads, layout, aligned):
    interleaved = layout == "model"
    assert ca.bf16_word_geometry(width, heads, interleaved, aligned) is None
    assert ca.bf16_geometry(width, heads, interleaved, aligned)[1] == "general"


def _cases(name):
    text = HEADER.read_text()
    body = re.search(rf"#define {name}\(CASE\)(.*?)\n\n", text, re.S).group(1)
    return {(int(w), int(p), a == "true") for w, p, a in re.findall(r"CASE\((\d+), (\d+), (true|false)\)", body)}


def test_bf16_word_rule_follows_the_kernels_constants():
    """The Python rule's constants are the header's, its column choice is
    the header's expression with 16-byte words (``eight``), the bf16 entry
    refuses words of fewer than 4 columns, and every (W, P, ALIGNED) it
    gives for a D <= 512 in either layout and alignment is one of the
    header's bf16 kernel cases, with whole words."""
    text = HEADER.read_text() + HEADS.read_text()
    assert int(re.search(r"constexpr int kMaxPartials = (\d+);", text).group(1)) == ca.MAX_PARTIALS
    assert int(re.search(r"constexpr int kMaxLanes = (\d+);", text).group(1)) == WARP
    assert "eight && width % 8 == 0 ? 8 : (width % 4 == 0 ? 4 : (width % 2 == 0 ? 2 : 1))" in text
    assert "&& geo->cols >= 4;" in SOURCE.read_text()
    assert ca.BF16_WORD_COLUMNS == (8, 4)
    assert "ATTENTION_WORD16_CASES(CASE)" in SOURCE.read_text()
    cases = _cases("ATTENTION_WORD16_CASES")
    given = set()
    for d in range(1, ca.MAX_WIDTH + 1):
        for h in range(1, d + 1):
            if d % h:
                continue
            for interleaved in (False, True):
                for aligned in (False, True):
                    g = ca.bf16_word_geometry(d, h, interleaved, aligned)
                    if g is None:
                        continue
                    assert d % g.cols == 0 and d % 4 == 0, (d, h, g)
                    assert g.cols == (8 if aligned and d % 8 == 0 else 4)
                    assert g.lanes <= WARP and g.partials <= ca.MAX_PARTIALS
                    given.add((g.cols, g.partials, g.aligned))
    assert given == cases


# --- the word geometry's order, emulated ----------------------------------------

HUB_EDGES = 48  # node 0 sends this many more: past a row's 32 lanes
ISOLATED = (5, 17)  # nodes no edge gathers


def _graphs(seed):
    """The port's and the JAX package's padded CSR graph on one topology:
    300 nodes padded to 384, 1,800 random edges and node 0's 48 more, padded
    to 2,048, nodes ``ISOLATED`` gathered by no edge, every tenth real edge
    masked."""
    r = np.random.default_rng(seed)
    n, e = 300, 1800
    s = np.concatenate([r.integers(0, n, e), np.zeros(HUB_EDGES, np.int64)]).astype(np.int32)
    keep = np.setdiff1d(np.arange(n), ISOLATED)
    t = keep[r.integers(0, len(keep), len(s))].astype(np.int32)
    x, pos = np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32)
    port = pad_graph_csr_np(x, pos, s, t, 384, 2048)
    theirs = jax_graph.pad_graph_csr_np(x, pos, s, t, 384, 2048)
    mask = np.asarray(port.edge_mask).copy()
    mask[np.flatnonzero(mask)[::10]] = False
    np.testing.assert_array_equal(np.asarray(port.senders), np.asarray(theirs.senders))
    return port.replace(edge_mask=mask), theirs.replace(edge_mask=jnp.asarray(mask))


def _round_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).float().numpy()


def _inputs(n, width, heads, seed):
    """q, k, v and g as [N, H, Dh] f32 arrays of bf16 values."""
    r = np.random.default_rng(seed)
    return [_round_bf16(r.normal(size=(n, heads, width // heads))) for _ in range(4)]


def _memory_rows(x, interleaved):
    """[N, H, Dh] as the node rows the kernels read: [N, Dh * H] (column c
    in head c % H) or [N, H * Dh] (head c // Dh)."""
    n = x.shape[0]
    return (x.transpose(0, 2, 1) if interleaved else x).reshape(n, -1)


def _heads_of_rows(rows, heads, interleaved):
    n, d = rows.shape
    if interleaved:
        return rows.reshape(n, d // heads, heads).transpose(0, 2, 1)
    return rows.reshape(n, heads, d // heads)


class _Words:
    """A bf16 word geometry of one width: each lane's columns and their
    heads. A word the row's end would cut is refused: the kernels load and
    store whole words, so such a word would reach into the next row."""

    def __init__(self, width, heads, interleaved, geo):
        self.geo = geo
        w, lanes = geo.cols, geo.lanes
        if width % w:
            raise ValueError(f"{w}-column words cut a {width}-column row")
        cols = np.arange(lanes * w).reshape(lanes, w)
        live = cols < width
        self.col_head = np.where(live, cols % heads if interleaved else cols // (width // heads), 0)
        self.width, self.heads = width, heads

    def head_sums(self, a, b):
        """[N, H] per-head sums of a * b over node rows [N, D], in the
        kernels' order: a lane's partials in column order, then the
        butterfly over the row's lanes (the reduce-scatter's pairs are the
        butterfly's; the lanes that hold other heads add exact zeros). The
        idle lanes' words are zeros."""
        n = a.shape[0]
        w, lanes = self.geo.cols, self.geo.lanes
        pad = lanes * w - self.width
        prod = np.concatenate([a * b, np.zeros((n, pad), np.float32)], axis=1).reshape(n, lanes, w)
        part = np.zeros((n, lanes, self.heads), np.float32)
        for i in range(w):
            for h in range(self.heads):
                part[:, :, h] += np.where(self.col_head[:, i] == h, prod[:, :, i], np.float32(0))
        offset = 1
        while offset < lanes:
            part = part + part[:, np.arange(lanes) ^ offset]
            offset *= 2
        return part[:, 0]

    def per_column(self, x):
        """[..., H] per-head values as [..., D] per column of the node rows."""
        return x[..., self.col_head.reshape(-1)[:self.width]]


def _slots(bounds, mask, gather):
    """Each row's range length and, per slot t, the edge, its liveness and
    gather row."""
    length = bounds[1] - bounds[0]
    for t in range(int(length.max())):
        has = t < length
        e = np.where(has, bounds[0] + t, 0)
        yield t, e, has & mask[e], gather[e]


def words_forward(q, k, v, bounds, gather, mask, scale, interleaved, aligned=True, stream=False):
    """The bf16 forward's order on [N, H, Dh] bf16 values: per row, its
    range's slots in windows of ``min(kEdges, L)``, each live edge's
    head score from ``head_sums`` times ``scale`` (rounded to bf16 with
    ``stream``), then a head's largest live score of the window, one rescale
    of ``l`` and the sums, and each live edge's weight added in slot order;
    out rounded to bf16 once. Returns (out [N, H, Dh], ml [2H, N])."""
    n, heads = q.shape[0], q.shape[1]
    width = q.shape[1] * q.shape[2]
    lanes = _Words(width, heads, interleaved, ca.bf16_word_geometry(width, heads, interleaved, aligned))
    window = min(_window(), lanes.geo.lanes)
    qm, km, vm = (_memory_rows(x, interleaved) for x in (q, k, v))
    m = np.full((n, heads), ca.NEG, np.float32)
    l = np.zeros((n, heads), np.float32)
    acc = np.zeros_like(qm)
    slots = list(_slots(bounds, mask, gather))
    for w0 in range(0, len(slots), window):
        scores, lives, values = [], [], []
        for t, e, live, j in slots[w0:w0 + window]:
            s = lanes.head_sums(qm, km[j]) * np.float32(scale)
            scores.append(_round_bf16(s) if stream else s)
            lives.append(live[:, None])
            values.append(vm[j])
        m_new = m
        for s, live in zip(scores, lives):
            m_new = np.where(live, np.maximum(m_new, s), m_new)
        alpha = np.exp(m - m_new)
        l = l * alpha
        acc = acc * lanes.per_column(alpha)
        for s, live, x in zip(scores, lives, values):
            with np.errstate(over="ignore"):  # a dead slot's score, not added
                pe = np.where(live, np.exp(s - m_new), np.float32(0))
            l = l + pe
            acc = acc + lanes.per_column(pe) * x
        m = m_new
    out = _round_bf16(acc / (lanes.per_column(l) + np.float32(ca.EPS)))
    return _heads_of_rows(out, heads, interleaved), np.concatenate([m.T, l.T])


def words_backward(q, k, v, bounds, gather, mask, ml, out, g, scale, interleaved, senders, aligned=True):
    """The bf16 backward's order in its two parts. Part A by sender rows:
    delta per head from ``head_sums``; per live edge in slot order the score
    and <v, g> per head, attn = exp(s - m) * (1 / (l + 1e-16)), ds = attn *
    (<v, g> - delta), each edge's (attn, ds) per head kept, dq summed in slot
    order.
    Part B by gather rows over the transposed CSR (ascending edge id): dk +=
    ds * scale * q and dv += bf16(attn * g) per column. Each rounded to bf16
    once. Returns (dq, dk, dv) as [N, H, Dh]."""
    n, heads = q.shape[0], q.shape[1]
    width = q.shape[1] * q.shape[2]
    lanes = _Words(width, heads, interleaved, ca.bf16_word_geometry(width, heads, interleaved, aligned))
    qm, km, vm, om, gm = (_memory_rows(x, interleaved) for x in (q, k, v, out, g))
    delta = lanes.head_sums(om, gm)
    m, inv_l = ml[:heads].T, np.float32(1) / (ml[heads:].T + np.float32(ca.EPS))
    scale = np.float32(scale)
    dq = np.zeros_like(qm)
    attn_ds = np.zeros((len(gather), 2, heads), np.float32)
    for t, e, live, j in _slots(bounds, mask, gather):
        s = lanes.head_sums(qm, km[j]) * scale
        vg = lanes.head_sums(vm[j], gm)
        with np.errstate(over="ignore"):  # rows without a live edge (m = -1e30): not added
            attn = np.where(live[:, None], np.exp(s - m) * inv_l, np.float32(0))
        ds = attn * (vg - delta)
        dq = dq + lanes.per_column(ds) * scale * km[j]
        rows = np.flatnonzero(live)
        attn_ds[e[rows], 0], attn_ds[e[rows], 1] = attn[rows], ds[rows]
    # part B: every live edge in ascending id adds into its gather row, which
    # is the transposed CSR's order of each row's slots
    live = np.zeros(len(gather), bool)
    for t, e, ok, j in _slots(bounds, mask, gather):
        live[e[ok]] = True
    edges = np.flatnonzero(live)
    dk = np.zeros_like(qm)
    dv = np.zeros_like(qm)
    attn_c, ds_c = lanes.per_column(attn_ds[edges, 0]), lanes.per_column(attn_ds[edges, 1])
    src = senders[edges]
    np.add.at(dk, gather[edges], ds_c * scale * qm[src])
    np.add.at(dv, gather[edges], _round_bf16(attn_c * gm[src]))
    return tuple(_heads_of_rows(_round_bf16(x), heads, interleaved) for x in (dq, dk, dv))


def test_emulation_refuses_a_cut_word():
    """16-byte words at D = 20 would cut the third lane's word at the row's
    end (columns 16-23 of a 20-column row): the emulation refuses that
    geometry rather than read the next row's columns as zeros, and the rule
    gives 8-byte words there."""
    geo = ca.bf16_word_geometry(20, 4, True)
    assert geo.cols == 4
    with pytest.raises(ValueError, match="cut"):
        _Words(20, 4, True, geo._replace(cols=8, lanes=4))


def _port(x, interleaved):
    t = torch.from_numpy(np.ascontiguousarray(x)).to(BF16)
    return t.transpose(1, 2).contiguous().transpose(1, 2) if interleaved else t


def _jax_attention(arrays, theirs, scale, stream_dtype="f32"):
    """JAX's ``csr_sparse_attention`` on the bf16 q, k, v (its K2 in TPU
    interpret mode) and its gradient in q, k, v for the output cotangent."""
    jqkv = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]]
    jcot = jnp.asarray(arrays[3]).astype(jnp.bfloat16).astype(jnp.float32)

    def attend(a, b, c):
        return jax_pa.csr_sparse_attention(a, b, c, theirs.senders, theirs.receivers, theirs.csr_bounds,
                                           theirs.edge_mask, scale=scale, max_chunks=theirs.csr_max_chunks,
                                           stream_dtype=stream_dtype)

    with pltpu.force_tpu_interpret_mode():
        out = attend(*jqkv)
        grads = jax.grad(lambda *a: (attend(*a).astype(jnp.float32) * jcot).sum(), argnums=(0, 1, 2))(*jqkv)
    return np.asarray(out, np.float32), [np.asarray(x, np.float32) for x in grads]


def _close_to_plain(got, want, g=None):
    """Two bf16 ulps of the plain version (the card tests' tolerance), dv
    also one edge term rounded the other way."""
    atol = BF16_ATOL if g is None else max(BF16_ATOL, BF16_DV_TERM * np.abs(g).max())
    np.testing.assert_allclose(got, want.float().numpy(), rtol=BF16_RTOL, atol=atol)


@pytest.mark.parametrize("layout", ["model", "contiguous"])
@pytest.mark.parametrize("width,heads", [(48, 4), (96, 3), (40, 8), (20, 4), (20, 1)])
def test_bf16_word_order_matches_jax_and_plain(width, heads, layout):
    """The bf16 forward's and backward's order at the word geometry's
    widths against JAX's ``csr_sparse_attention`` on the same bf16 arrays
    and its gradient (the files' bf16 tolerances: a bf16 ulp of the
    output's scale forward, bf16 accumulation's error backward), and
    against the port's plain versions (two bf16 ulps); rows without live
    edges give 0, and nodes no edge gathers get dk = dv = 0."""
    interleaved = layout == "model" and heads > 1
    port, theirs = _graphs(seed=width + heads)
    n = port.num_nodes
    seg, gather, bounds, mask = (np.asarray(x) for x in (port.senders, port.receivers, port.sender_bounds,
                                                         port.edge_mask))
    arrays = _inputs(n, width, heads, seed=width * heads + 7)
    q, k, v, g = arrays
    scale = heads ** -0.5
    out, ml = words_forward(q, k, v, bounds, gather, mask, scale, interleaved)
    want, want_grads = _jax_attention(arrays, theirs, scale)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATTN_FWD_ATOL * np.abs(want).max())
    tq, tk, tv, tg = (_port(x, interleaved) for x in arrays)
    tseg, tgather, tmask = (torch.from_numpy(x) for x in (seg, gather, mask))
    plain, plain_ml = ca.csr_attention_reference(tq, tk, tv, tseg, tgather, n, tmask, scale)
    _close_to_plain(out, plain)
    np.testing.assert_allclose(ml, plain_ml.numpy(), rtol=1e-5, atol=1e-5)
    empty = (bounds[1] - bounds[0]) == 0
    assert empty.any() and (out[empty] == 0).all() and (ml[heads:, empty] == 0).all()
    grads = words_backward(q, k, v, bounds, gather, mask, ml, out, g, scale, interleaved, seg)
    plain_grads = ca.csr_attention_backward_reference(tq, tk, tv, tseg, tgather, torch.from_numpy(ml),
                                                      _port(out, interleaved), tg, tmask, scale)
    for got, theirs_grad, plain_grad, name in zip(grads, want_grads, plain_grads, "qkv"):
        np.testing.assert_allclose(got, theirs_grad, rtol=ATTN_GRAD_RTOL, atol=ATTN_GRAD_ATOL, err_msg=f"d{name}")
        _close_to_plain(got, plain_grad, g if name == "v" else None)
    for t in grads[1:]:
        assert (t[list(ISOLATED)] == 0).all()


def test_bf16_word_order_stream_matches_jax_and_plain():
    """The forward's order with the bf16 stream at 48 x 4 in the model's
    view (each head's score rounded by the lane holding it; the v rows are
    bf16 already) against JAX's ``csr_sparse_attention(...,
    stream_dtype="bf16")`` and the plain version's stream. q and k lie on a
    1/16 grid, so every order sums a score exactly and each side rounds the
    same score to bf16."""
    port, theirs = _graphs(seed=53)
    n = port.num_nodes
    seg, gather, bounds, mask = (np.asarray(x) for x in (port.senders, port.receivers, port.sender_bounds,
                                                         port.edge_mask))
    arrays = _inputs(n, 48, 4, seed=54)
    arrays[:2] = [np.round(x * 16) / np.float32(16) for x in arrays[:2]]
    q, k, v, _ = arrays
    out, ml = words_forward(q, k, v, bounds, gather, mask, 0.5, True, stream=True)
    base, _ = words_forward(q, k, v, bounds, gather, mask, 0.5, True)
    assert not np.array_equal(out, base)
    want, _ = _jax_attention(arrays, theirs, 0.5, stream_dtype="bf16")
    np.testing.assert_allclose(out, want, rtol=0, atol=ATTN_FWD_ATOL * np.abs(want).max())
    tq, tk, tv = (_port(x, True) for x in arrays[:3])
    plain, plain_ml = ca.csr_attention_reference(tq, tk, tv, torch.from_numpy(seg), torch.from_numpy(gather), n,
                                                 torch.from_numpy(mask), 0.5, stream_dtype="bf16")
    _close_to_plain(out, plain)
    np.testing.assert_allclose(ml, plain_ml.numpy(), rtol=1e-5, atol=1e-5)


# The bf16 model at hidden 48 against the bf16 JAX model, as the precision
# tests' 32-wide one (max |port - JAX| over max |JAX| forward; each
# parameter's gradient, the worst): at 32 the two read 0 forward, at 48 and
# at the published 64 a few bf16 roundings fall the other way (f32 sums in
# another order on the two sides) and cascade through 3 blocks: 8.5e-3 and
# 7.8e-3 forward, 2.2e-2 and 1.9e-2 gradient on seed 0 (1.2e-2 and 3.1e-2
# at 48 on seed 1). The f32 port against the same bf16 JAX model read
# 1.5e-2 forward and 7.7e-2 gradient at 48: the gradient limit tells the
# precisions apart.
WIDTH_FWD_RTOL = 1.5e-2
WIDTH_GRAD_RTOL = 5e-2


def test_bf16_transformer_at_hidden_48_matches_jax(monkeypatch):
    """The bf16 transformer at hidden 48 in 4 heads (3 blocks; the model's
    (N, Dh, H) view, which the card runs in the bf16 word geometry) against
    the bf16 JAX model from equal weights: the eval forward and each
    parameter's gradient of one step's loss; the f32 port out of the
    gradient's tolerance."""
    param = precision._param
    monkeypatch.setattr(precision, "_param", lambda kind, prec, K=0, hidden=48, blocks=3:
                        param(kind, prec, K, hidden, blocks))
    assert precision._param("transformer", "bf16")["model"]["hidden_size"] == 48
    jg, g = precision._graphs("transformer")
    params, want_out, want_grads = precision._jax_reference("transformer", 0, jg)
    _, out, grads = precision._port_run("transformer", 0, "bf16", params, g)
    fwd, grad, worst = precision._errors(want_out, want_grads, out, grads, g.node_mask)
    assert fwd <= WIDTH_FWD_RTOL, f"bf16 forward rel err {fwd}"
    assert grad <= WIDTH_GRAD_RTOL, f"bf16 gradient rel err {grad} ({worst})"
    _, out32, grads32 = precision._port_run("transformer", 0, "f32", params, g)
    _, grad32, _ = precision._errors(want_out, want_grads, out32, grads32, g.node_mask)
    assert grad32 > WIDTH_GRAD_RTOL, grad32
