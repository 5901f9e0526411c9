"""Port parity, the fused f32 attention's word geometry, on the CPU:

- ``csr_attention.word_geometry``, ``lanes_per_row`` and ``geometry_kind``,
  the rule by which ``csrc/csr_attention.cu`` and ``csr_attention_bwd.cu``
  choose the word geometry (W consecutive columns a lane as one word, P
  per-head partials reduce-scattered to one head a lane) for widths
  without a fast geometry, in both layouts; the widths past its limits
  keep the general geometry, the published widths their fast ones.
- The rule against the constants and instantiations of
  ``csrc/attention_words.cuh``: every (W, P, ALIGNED) the rule gives for a
  D <= 512 is a kernel case there.
- The word geometry's order emulated in numpy f32 (a lane's per-head
  partials in column order, the butterfly over its row's lanes, the online
  softmax a head, and the backward's formulas), held against the JAX
  package's ``csr_sparse_attention`` (its K2 in TPU interpret mode) and its
  gradient, and against the port's plain versions, at 1e-5.

Inputs come from numpy with a seed and go to both sides."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_torch.ops import csr_attention as ca
from graphphysics_torch.ops.csr_segment import WARP, compute_row_bounds
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# both sides in f32, sums in another order
ORDER_RTOL, ORDER_ATOL = 1e-5, 1e-5
HEADER = Path(ca.__file__).resolve().parents[1] / "csrc" / "attention_words.cuh"
EDGES = 2  # the kernels' window: kEdges edges whose k and v words a lane has in flight

# (D, H, layout) -> (forward lanes, backward lanes, kind, (W, L, P,
# ALIGNED, lo, hi) of the word geometry)
RULE_CASES = [
    # 12 words: 16 lanes, 4 idle, column i in head i
    (48, 4, "model", (16, 16, "words", (4, 16, 4, True, 1, 16))),
    (48, 4, "contiguous", (8, 16, "fast", (4, 16, 4, False, 1, 16))),
    # head (s + i) % 3: the select
    (96, 3, "model", (32, 32, "words", (4, 32, 4, False, 1, 32))),
    # a head's 8 lanes
    (96, 3, "contiguous", (32, 32, "words", (4, 32, 1, True, 1, 8))),
    # lanes s and s ^ 1 hold other heads
    (40, 8, "model", (16, 16, "words", (4, 16, 4, True, 2, 16))),
    (40, 8, "contiguous", (8, 8, "fast", (4, 16, 8, False, 1, 16))),
    (24, 4, "model", (8, 8, "words", (4, 8, 4, True, 1, 8))),
    (24, 4, "contiguous", (8, 8, "fast", (4, 8, 4, False, 1, 8))),
    (80, 4, "model", (32, 32, "words", (4, 32, 4, True, 1, 32))),
    (80, 4, "contiguous", (8, 16, "fast", (4, 32, 4, False, 1, 32))),
    (112, 4, "model", (32, 32, "words", (4, 32, 4, True, 1, 32))),
    # 5 and 9 words, an odd count: the last word ends the row, lanes 5-7
    # (9-15) idle
    (20, 4, "model", (8, 8, "words", (4, 8, 4, True, 1, 8))),
    (20, 4, "contiguous", (8, 8, "words", (4, 8, 4, False, 1, 8))),
    (36, 4, "model", (16, 16, "words", (4, 16, 4, True, 1, 16))),
    (36, 4, "contiguous", (16, 16, "words", (4, 16, 4, False, 1, 16))),
    (20, 1, "contiguous", (8, 8, "words", (4, 8, 1, True, 1, 8))),
    # 3 words, at least P lanes
    (12, 3, "model", (4, 4, "words", (4, 4, 4, False, 1, 4))),
    (12, 3, "contiguous", (4, 4, "words", (4, 4, 1, True, 1, 1))),  # a lane a head
    (30, 3, "model", (16, 16, "words", (2, 16, 4, False, 1, 16))),  # D % 4 != 0: 8-byte words
    (30, 3, "contiguous", (16, 16, "words", (2, 16, 4, False, 1, 16))),
    (15, 5, "model", (16, 16, "words", (1, 16, 8, False, 1, 16))),  # odd D: one column a lane
    (6, 2, "model", (4, 4, "words", (2, 4, 2, True, 1, 4))),
    (6, 2, "contiguous", (4, 4, "words", (2, 4, 2, False, 1, 4))),
    # the most partials a lane keeps
    (96, 12, "model", (32, 32, "words", (4, 32, 16, False, 1, 32))),
    (96, 12, "contiguous", (32, 32, "words", (4, 32, 1, True, 1, 2))),
]
# (D, H, layout): the general geometry keeps them, 32 lanes
GENERAL_CASES = [
    (160, 4, "model"),  # 40 words: past 32 lanes
    (264, 4, "model"),
    (68, 17, "model"),  # 17 heads: past MAX_PARTIALS
    (68, 17, "contiguous"),
    (500, 5, "model"),
]


@pytest.mark.parametrize("width,heads,layout,want", RULE_CASES)
def test_word_geometry_rule(width, heads, layout, want):
    interleaved = layout == "model"
    fwd, bwd, kind, geometry = want
    assert ca.lanes_per_row(width, heads, interleaved) == fwd
    assert ca.lanes_per_row(width, heads, interleaved, backward=True) == bwd
    assert ca.geometry_kind(fwd, width, heads, interleaved) == kind
    assert ca.geometry_kind(bwd, width, heads, interleaved) == kind
    g = ca.word_geometry(width, heads, interleaved)
    assert tuple(g) == geometry
    # whole words fill the row; the reduce-scatter's levels fit below hi
    assert width % g.cols == 0 and g.lanes * g.cols >= width
    assert g.partials == 1 or g.lo * g.partials <= g.hi
    if kind == "words":
        assert fwd == bwd == g.lanes


@pytest.mark.parametrize("width,heads,layout", GENERAL_CASES)
def test_general_geometry_keeps_what_the_words_cannot_hold(width, heads, layout):
    interleaved = layout == "model"
    assert ca.word_geometry(width, heads, interleaved) is None
    for backward in (False, True):
        lanes = ca.lanes_per_row(width, heads, interleaved, backward=backward)
        assert lanes == 32 and ca.geometry_kind(lanes, width, heads, interleaved) == "general"


@pytest.mark.parametrize("layout", ["model", "contiguous"])
def test_published_widths_keep_their_fast_geometries_beside_the_words(layout):
    """128 and 64 in 4 heads keep the fast geometries at the lanes measured
    fastest; the word geometry's lanes there would be other ones."""
    interleaved = layout == "model"
    for d in (64, 128):
        assert ca.lanes_per_row(d, 4, interleaved) == 8
        assert ca.lanes_per_row(d, 4, interleaved, backward=True) == 32
        assert ca.geometry_kind(8, d, 4, interleaved) == ca.geometry_kind(32, d, 4, interleaved) == "fast"


def _cases_in_header():
    text = HEADER.read_text()
    body = re.search(r"#define ATTENTION_WORD_CASES\(CASE\)(.*?)\n\n", text, re.S).group(1)
    return {(int(w), int(p), a == "true") for w, p, a in re.findall(r"CASE\((\d+), (\d+), (true|false)\)", body)}


def test_word_rule_follows_the_kernels_constants():
    """The Python rule's constants are the header's, its column choice is
    the header's expression, and every (W, P, ALIGNED) it gives for a
    D <= 512 in either layout is one of the header's kernel cases, each
    with whole words (W divides D)."""
    text = HEADER.read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert constant("kMaxPartials") == ca.MAX_PARTIALS
    assert constant("kMaxLanes") == WARP
    assert "width % 4 == 0 ? 4 : (width % 2 == 0 ? 2 : 1)" in text
    assert ca.WORD_COLUMNS == (4, 2, 1)
    for branch in ("if (heads == 1) {", "} else if (interleaved && cols % heads == 0) {",
                   "} else if (interleaved && heads % cols == 0 && pow2(heads / cols)) {",
                   "} else if (!interleaved && head_dim % cols == 0 && pow2(head_dim / cols)) {"):
        assert branch in text
    assert constant("kEdges") == EDGES
    cases = _cases_in_header()
    given = set()
    for d in range(1, ca.MAX_WIDTH + 1):
        for h in range(1, d + 1):
            if d % h:
                continue
            for interleaved in (False, True):
                g = ca.word_geometry(d, h, interleaved)
                if g is not None:
                    assert d % g.cols == 0, (d, h, g)
                    given.add((g.cols, g.partials, g.aligned))
    assert given == cases


# --- the word geometry's order, emulated ----------------------------------------


def _graph(n=160, seed=5):
    """Sender-sorted rows: row 0 a hub of 300 edges, row 1 all masked, rows
    2-6 empty, the rest 0-12 edges with a tenth masked; gather indices in
    [0, n)."""
    r = np.random.default_rng(seed)
    counts = np.concatenate([[300, 9], np.zeros(5, int), r.integers(0, 13, n - 7)])
    seg = np.repeat(np.arange(n), counts).astype(np.int32)
    e = len(seg)
    mask = r.random(e) >= 0.1
    mask[300:309] = False
    gather = r.integers(0, n, e).astype(np.int32)
    return n, seg, gather, mask


def _inputs(n, width, heads, seed):
    r = np.random.default_rng(seed)
    q, k, v, g = (r.normal(size=(n, heads, width // heads)).astype(np.float32) for _ in range(4))
    return q, k, v, g


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


class _Lanes:
    """A word geometry of one width: each lane's columns and their heads.
    A word the row's end would cut is refused: the kernels load and store
    whole words, so such a word would reach into the next row."""

    def __init__(self, width, heads, interleaved, geo=None):
        self.geo = ca.word_geometry(width, heads, interleaved) if geo is None else geo
        w, lanes = self.geo.cols, self.geo.lanes
        if width % w:
            raise ValueError(f"{w}-column words cut a {width}-column row")
        cols = np.arange(lanes * w).reshape(lanes, w)
        self.live = cols < width
        head_dim = width // heads
        self.col_head = np.where(self.live, cols % heads if interleaved else cols // head_dim, 0)
        self.width, self.heads = width, heads

    def head_sums(self, a, b):
        """[N, H] per-head sums of a * b over node rows [N, D], in the
        kernels' order: a lane's partials in column order, then the
        butterfly over the row's lanes (xor offsets 1, 2, ..., L / 2; the
        reduce-scatter's pairs are the butterfly's). The idle lanes' words
        are zeros."""
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
        """[N, H] per-head values as [N, D] per column of the node rows."""
        return x[:, self.col_head.reshape(-1)[:self.width]]


def _round_bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float().numpy()


def words_forward(q, k, v, seg, gather, mask, n, scale, interleaved, stream=False):
    """The forward's order on [N, H, Dh] inputs: per row, its range's edges
    in windows of ``min(EDGES, L)`` slots, each live edge's head score from
    ``head_sums`` times ``scale`` (rounded to bf16 with ``stream``), then a
    head's largest live score of the window, one rescale of ``l`` and the
    sums, and each live edge's weight added in slot order, each value
    rounded to bf16 with ``stream``. Returns (out [N, H, Dh], ml [2H, N])."""
    heads = q.shape[1]
    lanes = _Lanes(q.shape[1] * q.shape[2], heads, interleaved)
    window = min(EDGES, lanes.geo.lanes)
    qm, km, vm = (_memory_rows(x, interleaved) for x in (q, k, v))
    bounds = compute_row_bounds(seg, n)
    m = np.full((n, heads), ca.NEG, np.float32)
    l = np.zeros((n, heads), np.float32)
    acc = np.zeros_like(qm)
    length = bounds[1] - bounds[0]
    for t0 in range(0, int(length.max()), window):
        scores, lives, values = [], [], []
        for t in range(t0, t0 + window):
            has = t < length
            e = np.where(has, bounds[0] + t, 0)
            j = gather[e]
            s = lanes.head_sums(qm, km[j]) * np.float32(scale)
            scores.append(_round_bf16(s) if stream else s)
            lives.append((has & mask[e])[:, None])
            values.append(_round_bf16(vm[j]) if stream else vm[j])
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
    out = acc / (lanes.per_column(l) + np.float32(ca.EPS))
    return _heads_of_rows(out, heads, interleaved), np.concatenate([m.T, l.T])


def words_backward(q, k, v, seg, gather, mask, ml, out, g, scale, interleaved):
    """The backward's order: delta per head from ``head_sums``; per row, its
    live edges in order, the score and <v, g> per head, attn = exp(s - m) /
    (l + 1e-16), ds = attn * (<v, g> - delta); dq summed in edge order, dk
    and dv added per edge. Returns (dq, dk, dv) as [N, H, Dh]."""
    n, heads = q.shape[0], q.shape[1]
    lanes = _Lanes(q.shape[1] * q.shape[2], heads, interleaved)
    qm, km, vm, om, gm = (_memory_rows(x, interleaved) for x in (q, k, v, out, g))
    bounds = compute_row_bounds(seg, n)
    delta = lanes.head_sums(om, gm)
    m, l = ml[:heads].T, ml[heads:].T
    dq = np.zeros_like(qm)
    dk = np.zeros_like(qm)
    dv = np.zeros_like(qm)
    length = bounds[1] - bounds[0]
    scale = np.float32(scale)
    for t in range(int(length.max())):
        has = t < length
        e = np.where(has, bounds[0] + t, 0)
        live = has & mask[e]
        j = gather[e]
        s = lanes.head_sums(qm, km[j]) * scale
        vg = lanes.head_sums(vm[j], gm)
        with np.errstate(over="ignore"):  # rows without a live edge (m = -1e30): not added
            attn = np.exp(s - m) / (l + np.float32(ca.EPS))
        ds = attn * (vg - delta)
        dsc, attnc = lanes.per_column(ds), lanes.per_column(attn)
        keep = live[:, None]
        dq = np.where(keep, dq + dsc * scale * km[j], dq)
        rows = np.flatnonzero(live)
        np.add.at(dk, j[rows], (dsc * scale * qm)[rows])
        np.add.at(dv, j[rows], (attnc * gm)[rows])
    return tuple(_heads_of_rows(x, heads, interleaved) for x in (dq, dk, dv))


def _jax_attention(q, k, v, seg, gather, mask, n, scale, g, stream_dtype="f32"):
    """JAX's ``csr_sparse_attention`` (its K2 in TPU interpret mode) and its
    gradient in q, k, v for the output cotangent g."""
    block_bounds = jax_pa.compute_block_bounds(seg, n, num_real_edges=len(seg))
    chunks = jax_pa.compute_max_chunks_bounds(block_bounds)

    def attend(q_, k_, v_):
        return jax_pa.csr_sparse_attention(q_, k_, v_, jnp.asarray(seg), jnp.asarray(gather),
                                           jnp.asarray(block_bounds), jnp.asarray(mask), scale,
                                           max_chunks=chunks, stream_dtype=stream_dtype)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(attend, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


# the rule's cases that take the word geometry
ORDER_CASES = [(d, h, layout) for d, h, layout, want in RULE_CASES if want[2] == "words"]


def test_emulation_refuses_a_cut_word():
    """Two 16-byte words a lane at D = 20 would cut the third lane's words
    at the row's end (columns 16-23 of a 20-column row): the emulation
    refuses that geometry rather than read the next row's columns as
    zeros."""
    cut = ca.word_geometry(20, 4, True)._replace(cols=8, lanes=4)
    with pytest.raises(ValueError, match="cut"):
        _Lanes(20, 4, True, cut)


@pytest.mark.parametrize("width,heads,layout", ORDER_CASES)
def test_word_order_matches_jax(width, heads, layout):
    """The forward's and the backward's order at the word geometry's widths
    against JAX's ``csr_sparse_attention`` and its gradient, and against the
    port's plain versions, at 1e-5; rows without live edges give 0. The
    order's head sums are the same bits in every mode: a butterfly over all
    of a row's lanes pairs a head's partials as the kernels' narrower one
    does, adding exact zeros for the lanes that hold other heads."""
    interleaved = layout == "model"
    n, seg, gather, mask = _graph(seed=width + heads)
    q, k, v, g = _inputs(n, width, heads, seed=width * heads)
    scale = heads ** -0.5
    out, ml = words_forward(q, k, v, seg, gather, mask, n, scale, interleaved)
    want, want_grads = _jax_attention(q, k, v, seg, gather, mask, n, scale, g)
    np.testing.assert_allclose(out, want, rtol=ORDER_RTOL, atol=ORDER_ATOL)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    tseg, tgather, tmask = (torch.from_numpy(x) for x in (seg, gather, mask))
    plain, plain_ml = ca.csr_attention_reference(tq, tk, tv, tseg, tgather, n, tmask, scale)
    np.testing.assert_allclose(out, plain.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)
    np.testing.assert_allclose(ml, plain_ml.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)
    assert (out[1:7] == 0).all() and (ml[heads:, 1:7] == 0).all()
    grads = words_backward(q, k, v, seg, gather, mask, ml, out, g, scale, interleaved)
    plain_grads = ca.csr_attention_backward_reference(tq, tk, tv, tseg, tgather, torch.from_numpy(ml),
                                                      torch.from_numpy(out), tg, tmask, scale)
    for got, ref, plain_ref in zip(grads, want_grads, plain_grads):
        np.testing.assert_allclose(got, ref, rtol=ORDER_RTOL, atol=ORDER_ATOL)
        np.testing.assert_allclose(got, plain_ref.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)


@pytest.mark.parametrize("width,heads,layout", [(48, 4, "model"), (96, 3, "model"), (40, 8, "model"),
                                                (20, 4, "model"), (30, 3, "contiguous")])
def test_word_order_stream_matches_jax(width, heads, layout):
    """The forward's order with the bf16 stream (each head's score rounded
    by the lane holding it, each value before it is weighted) against JAX's
    ``csr_sparse_attention(..., stream_dtype="bf16")`` and the plain
    version's stream, at 1e-5. q and k lie on a 1/16 grid, so every order
    sums a score exactly and each side rounds the same score to bf16."""
    interleaved = layout == "model"
    n, seg, gather, mask = _graph(seed=width + heads + 1)
    q, k, v, g = _inputs(n, width, heads, seed=width * heads + 1)
    q, k = (np.round(x * 16) / np.float32(16) for x in (q, k))
    scale = heads ** -0.5
    out, ml = words_forward(q, k, v, seg, gather, mask, n, scale, interleaved, stream=True)
    want, _ = _jax_attention(q, k, v, seg, gather, mask, n, scale, g, stream_dtype="bf16")
    np.testing.assert_allclose(out, want, rtol=ORDER_RTOL, atol=ORDER_ATOL)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain, plain_ml = ca.csr_attention_reference(tq, tk, tv, torch.from_numpy(seg), torch.from_numpy(gather),
                                                 n, torch.from_numpy(mask), scale, stream_dtype="bf16")
    np.testing.assert_allclose(out, plain.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)
    np.testing.assert_allclose(ml, plain_ml.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)
