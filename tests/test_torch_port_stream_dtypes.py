"""Port parity, the TPU kernels' two 16-bit stream modes, on the CPU (the
kernels' plain versions) against the JAX package:

- K1 on bf16 and f16 data: ``csr_segment_sum`` and ``masked_segment_sum``
  (with ``row_bounds``, the path of the Hopper kernel's 16-bit entries)
  against the JAX ``masked_segment_sum`` on the same 16-bit input and
  against JAX's K1 (``pallas_segment.csr_segment_sum`` in TPU interpret
  mode) on the f32 upcast, cast back: JAX's K1 itself does not run on
  16-bit data in interpret mode (it pads the data in its own dtype and
  copies it into an f32 scratch, which the interpreter refuses), so it is
  held on the function it stands for. The hub row of 4,096 unit edges, and
  the gradients bit for bit against ``jax.grad``.
- ``stream_dtype="bf16"`` of ``csr_softmax_spmm``, ``csr_softmax_spmm_pair``
  and ``csr_sparse_attention`` (f32 and bf16 q, k, v) against the JAX
  functions with the stream on (K2 in TPU interpret mode): outputs, ``ml``,
  gradients, that the stream differs from the f32 mode, and the
  ``ValueError`` on an unknown mode.
- The lane geometries K1's entries and K5's stream entry choose by width,
  heads and alignment (``segment_sum_geometry``, ``stream_geometry``,
  the CUDA sources' rules mirrored in Python), and ``alignment``.

Inputs come from numpy with a seed and go to both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_tpu.ops import pallas_segment as jax_ps
from graphphysics_tpu.ops import segment as jax_seg
from graphphysics_torch.core.graph import pad_graph_csr_np
from graphphysics_torch.ops import csr_attention as ca
from graphphysics_torch.ops.csr_segment import compute_row_bounds, csr_segment_sum
from graphphysics_torch.ops.segment import masked_segment_sum
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f16": (torch.float16, jnp.float16)}
# explicit mantissa bits and the least normal exponent of each 16-bit type
MANTISSA = {"bf16": 7, "f16": 10}
MIN_EXP = {"bf16": -126, "f16": -14}
# K1 16-bit: both sides sum the same 16-bit values in f32 (in other orders)
# and round once, so they agree to one unit in the last place of the output
# dtype: f32 sums that differ by round-off can round to neighbouring values.
K1_ULPS = 1
# the stream's outputs, f32 q, k, v or given scores: both sides compute in
# f32 from the same bf16-rounded values, so they differ by f32 round-off of
# the softmax and the sums (the tolerance of tests/test_pallas_attention.py)
STREAM_RTOL, STREAM_ATOL = 1e-5, 1e-5
# the gradients: the f32 backward of each side from the unrounded inputs
# and the stream pass's statistics
STREAM_GRAD_RTOL, STREAM_GRAD_ATOL = 1e-4, 1e-4
# bf16 q, k, v: the existing bf16 fused tolerances (test_torch_port_bf16_ops.py:
# one bf16 ulp of the output's scale forward; JAX sums the per-edge gradient
# terms in bf16, the port in f32)
BF16_FWD_ATOL = 2.0 ** -7
BF16_GRAD_RTOL, BF16_GRAD_ATOL = 3e-2, 3e-2
# the least gap between the bf16 stream and the f32 mode on the seeded
# cases: a mode that skipped the rounding would read 0 here
STREAM_DIFFERS = 1e-4


def _ulp(x: np.ndarray, name: str) -> np.ndarray:
    """One unit in the last place of each value of ``x`` in the 16-bit type
    ``name`` (the subnormals' spacing below its least normal exponent)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** MIN_EXP[name])
    return 2.0 ** (np.floor(np.log2(mag)) - MANTISSA[name])


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


# --------------------------------------------------------------------------
# K1 on 16-bit data

K1_NODES, K1_EDGES, K1_WIDTH = 600, 3000, 32


@functools.lru_cache(maxsize=None)
def _k1_case(name):
    """Receiver-sorted edges with a tenth masked, data of magnitude ~4 in
    the 16-bit type (both sides get the same bits), and JAX's two results:
    ``masked_segment_sum`` on the 16-bit data and K1 on the f32 upcast."""
    tdt, jdt = DTYPES[name]
    r = np.random.default_rng(MANTISSA[name])
    recv = np.sort(r.integers(0, K1_NODES, K1_EDGES)).astype(np.int32)
    mask = r.random(K1_EDGES) > 0.1
    data16 = torch.from_numpy(4 * r.normal(size=(K1_EDGES, K1_WIDTH)).astype(np.float32)).to(tdt)
    exact = data16.float().numpy()  # the 16-bit values, exactly, in f32
    want_sum = jax_seg.masked_segment_sum(jnp.asarray(exact).astype(jdt), jnp.asarray(recv), K1_NODES,
                                          jnp.asarray(mask))
    assert want_sum.dtype == jdt
    offsets = jax_ps.compute_block_offsets(recv, K1_NODES)
    with pltpu.force_tpu_interpret_mode():
        want_k1 = jax_ps.csr_segment_sum(jnp.asarray(exact * mask[:, None]), jnp.asarray(recv),
                                         jnp.asarray(offsets), K1_NODES,
                                         max_chunks=jax_ps.compute_max_chunks(offsets))
    return data16, recv, mask, _np(want_sum), _np(want_k1.astype(jdt))


@pytest.mark.parametrize("entry", ["csr_segment_sum", "masked_segment_sum"])
@pytest.mark.parametrize("name", ["bf16", "f16"])
def test_k1_16bit_within_one_ulp_of_jax(name, entry):
    data16, recv, mask, want_sum, want_k1 = _k1_case(name)
    r, m = torch.from_numpy(recv), torch.from_numpy(mask)
    bounds = torch.from_numpy(compute_row_bounds(recv, K1_NODES))
    if entry == "csr_segment_sum":
        got = csr_segment_sum(data16, r, bounds, m)
    else:
        got = masked_segment_sum(data16, r, K1_NODES, m, row_bounds=bounds)
    assert got.dtype == DTYPES[name][0]
    got = _np(got)
    for want, what in ((want_sum, "masked_segment_sum"), (want_k1, "K1 on the f32 upcast")):
        gap = np.abs(got - want)
        assert np.all(gap <= K1_ULPS * _ulp(want, name)), (what, gap.max())


@pytest.mark.parametrize("name", ["bf16", "f16"])
def test_k1_16bit_hub_row_reads_4096(name):
    """4,096 unit edges into one node sum to exactly 4,096 in both 16-bit
    types (a sum kept in bf16 would stop at 256, in f16 at 2,048), as JAX's
    ``masked_segment_sum`` gives; the other rows hold one edge each."""
    tdt, jdt = DTYPES[name]
    hub, n = 4096, 64
    recv = np.concatenate([np.zeros(hub, np.int32), np.arange(1, n, dtype=np.int32)])
    data = torch.ones((len(recv), 8), dtype=tdt)
    bounds = torch.from_numpy(compute_row_bounds(recv, n))
    for out in (csr_segment_sum(data, torch.from_numpy(recv), bounds),
                masked_segment_sum(data, torch.from_numpy(recv), n, row_bounds=bounds)):
        assert out.dtype == tdt
        assert torch.equal(out[0].float(), torch.full((8,), 4096.0))
        assert torch.equal(out[1:].float(), torch.ones(n - 1, 8))
    want = jax_seg.masked_segment_sum(jnp.ones((len(recv), 8), jdt), jnp.asarray(recv), n)
    assert np.array_equal(_np(want)[0], np.full(8, 4096.0))


@pytest.mark.parametrize("name", ["bf16", "f16"])
def test_k1_16bit_gradients_bit_equal_jax(name):
    """The gradient of the 16-bit sum is the gather of the 16-bit cotangent
    (0 on masked edges): bit for bit ``jax.grad`` of the JAX
    ``masked_segment_sum``."""
    tdt, jdt = DTYPES[name]
    data16, recv, mask, _, _ = _k1_case(name)
    w = np.random.default_rng(5).normal(size=(K1_NODES, K1_WIDTH)).astype(np.float32)

    def loss(d):
        out = jax_seg.masked_segment_sum(d, jnp.asarray(recv), K1_NODES, jnp.asarray(mask))
        return (out.astype(jnp.float32) * w).sum()

    want = jax.grad(loss)(jnp.asarray(data16.float().numpy()).astype(jdt))
    assert want.dtype == jdt
    bounds = torch.from_numpy(compute_row_bounds(recv, K1_NODES))
    for entry in ("csr_segment_sum", "masked_segment_sum"):
        d = data16.clone().requires_grad_(True)
        r, m = torch.from_numpy(recv), torch.from_numpy(mask)
        out = (csr_segment_sum(d, r, bounds, m) if entry == "csr_segment_sum"
               else masked_segment_sum(d, r, K1_NODES, m, row_bounds=bounds))
        (grad,) = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), d)
        assert grad.dtype == tdt
        assert np.array_equal(_np(grad), _np(want)), entry
        assert bool((grad[~m] == 0).all())


# --------------------------------------------------------------------------
# stream_dtype="bf16": K2 on given scores


def _k2_case(seed, n=700, e=4096, h=4, dh=16):
    """Sender-sorted scores and values (the case the stream's parity was
    first read on: 700 nodes, 4,096 edges, 4 heads of 16), an eighth of the
    edges masked."""
    r = np.random.default_rng(seed)
    seg = np.sort(r.integers(0, n, e)).astype(np.int32)
    mask = r.random(e) >= 0.125
    scores = (3 * r.normal(size=(e, h))).astype(np.float32)
    values = r.normal(size=(e, h * dh)).astype(np.float32)
    cot = r.normal(size=(n, h * dh)).astype(np.float32)
    return n, seg, mask, scores, values, cot


def _jax_k2_inputs(n, seg, mask, scores):
    """As ``csr_sparse_attention`` hands them to K2: masked edges at score
    -1e30 and segment N, block ranges from the sorted segments."""
    s = np.where(mask[:, None], scores, jax_pa._NEG).astype(np.float32)
    sg = np.where(mask, seg, n).astype(np.int32)
    bounds = jax_pa.compute_block_bounds(seg, n, num_real_edges=len(seg))
    return jnp.asarray(s), jnp.asarray(sg), jnp.asarray(bounds), jax_pa.compute_max_chunks_bounds(bounds)


def test_softmax_spmm_bf16_stream_matches_jax():
    n, seg, mask, scores, values, cot = _k2_case(0)
    s, sg, bounds, mc = _jax_k2_inputs(n, seg, mask, scores)
    v = jnp.asarray(values)
    with pltpu.force_tpu_interpret_mode():
        want, want_ml = jax_pa._softmax_spmm_impl(s, v, sg, bounds, n, s.shape[1], jax_pa.BLOCK_NODES,
                                                  jax_pa.BLOCK_EDGES, mc, stream_dtype="bf16")
        want_grads = jax.grad(
            lambda a, b: (jax_pa.csr_softmax_spmm(a, b, sg, bounds, n, max_chunks=mc, stream_dtype="bf16")
                          * cot).sum(), argnums=(0, 1))(s, v)
    ts, tv = torch.tensor(scores, requires_grad=True), torch.tensor(values, requires_grad=True)
    args = (torch.from_numpy(seg), torch.from_numpy(compute_row_bounds(seg, n)), torch.from_numpy(mask))
    out, ml = ca.csr_softmax_spmm(ts, tv, *args, stream_dtype="bf16")
    assert out.dtype == torch.float32 and ml.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(want), rtol=STREAM_RTOL, atol=STREAM_ATOL)
    np.testing.assert_allclose(_np(ml), _np(want_ml), rtol=STREAM_RTOL, atol=STREAM_ATOL)
    grads = torch.autograd.grad(out, (ts, tv), torch.from_numpy(cot))
    for got, ref, name in zip(grads, want_grads, ("dscores", "dvalues")):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=STREAM_GRAD_RTOL, atol=STREAM_GRAD_ATOL,
                                   err_msg=name)
        assert np.all(_np(got)[~mask] == 0)
    f32, _ = ca.csr_softmax_spmm(ts, tv, *args)
    assert np.abs(_np(out) - _np(f32)).max() > STREAM_DIFFERS


def test_softmax_spmm_bf16_stream_is_f32_on_rounded_inputs():
    """The stream's result is the f32 mode's on scores and values rounded to
    bf16 (RN), exactly, on the CPU."""
    n, seg, mask, scores, values, _ = _k2_case(1)
    args = (torch.from_numpy(seg), torch.from_numpy(compute_row_bounds(seg, n)), torch.from_numpy(mask))
    s, v = torch.from_numpy(scores), torch.from_numpy(values)
    out, ml = ca.csr_softmax_spmm(s, v, *args, stream_dtype="bf16")
    rounded = ca.csr_softmax_spmm(s.to(torch.bfloat16).float(), v.to(torch.bfloat16).float(), *args)
    assert torch.equal(out, rounded[0]) and torch.equal(ml, rounded[1])


def test_bf16_stream_close_to_f32():
    """Twin of ``tests/test_pallas_attention.py::test_bf16_stream_close_to_f32``
    on the port's plain version at its size (70,000 nodes, 8,192 edges, 4
    heads of 16): the empty rows exactly 0, the rest within the bf16
    rounding of the inputs (rtol 0.1, atol 0.05, that test's limits)."""
    n, e, h, dh = 70000, 8192, 4, 16
    r = np.random.default_rng(13)
    seg = np.sort(r.integers(0, n, e)).astype(np.int32)
    scores = torch.from_numpy(r.normal(size=(e, h)).astype(np.float32))
    values = torch.from_numpy(r.normal(size=(e, h * dh)).astype(np.float32))
    args = (torch.from_numpy(seg), torch.from_numpy(compute_row_bounds(seg, n)))
    out32, _ = ca.csr_softmax_spmm(scores, values, *args)
    out16, _ = ca.csr_softmax_spmm(scores, values, *args, stream_dtype="bf16")
    a32, a16 = out32.numpy(), out16.numpy()
    occupied = np.zeros(n, bool)
    occupied[seg] = True
    assert np.all(a16[~occupied] == 0.0)
    np.testing.assert_allclose(a16[occupied], a32[occupied], rtol=0.1, atol=0.05)


# --------------------------------------------------------------------------
# stream_dtype="bf16": K5, the pair


def test_softmax_spmm_pair_bf16_stream_matches_jax():
    r = np.random.default_rng(2)
    n, h, dh, ea, eb = 128, 4, 8, 300, 90
    sets = []
    for e, every in ((ea, 7), (eb, 5)):
        seg = np.sort(r.integers(0, n, e)).astype(np.int32)
        mask = np.ones(e, bool)
        mask[::every] = False
        sets.append(((3 * r.normal(size=(e, h))).astype(np.float32),
                     r.normal(size=(e, h * dh)).astype(np.float32), seg, mask))
    cot = r.normal(size=(n, h * dh)).astype(np.float32)

    def jax_prep(s, v, seg, m):
        bounds = jax_pa.compute_block_bounds(seg, n, num_real_edges=len(seg))
        return (jnp.asarray(np.where(m[:, None], s, jax_pa._NEG).astype(np.float32)), jnp.asarray(v),
                jnp.asarray(np.where(m, seg, n).astype(np.int32)), jnp.asarray(bounds))

    (sa, va, ga, ba), (sb, vb, gb, bb) = (jax_prep(*x) for x in sets)
    mc = max(ea, eb) // jax_pa.BLOCK_EDGES + 2
    with pltpu.force_tpu_interpret_mode():
        want, want_ml = jax_pa._pair_impl(sa, va, ga, ba, sb, vb, gb, bb, n, jax_pa.BLOCK_NODES,
                                          jax_pa.BLOCK_EDGES, mc, "bf16")
        want_grads = jax.grad(
            lambda a, b, c, d: (jax_pa.csr_softmax_spmm_pair(a, b, ga, ba, c, d, gb, bb, n,
                                                             stream_dtype="bf16") * cot).sum(),
            argnums=(0, 1, 2, 3))(sa, va, sb, vb)

    def port_prep(s, v, seg, m):
        return (torch.tensor(s, requires_grad=True), torch.tensor(v, requires_grad=True),
                torch.from_numpy(seg), torch.from_numpy(compute_row_bounds(seg, n)), torch.from_numpy(m))

    (tsa, tva, tga, tba, tma), (tsb, tvb, tgb, tbb, tmb) = (port_prep(*x) for x in sets)
    out, ml = ca.csr_softmax_spmm_pair(tsa, tva, tga, tba, tsb, tvb, tgb, tbb, tma, tmb,
                                       stream_dtype="bf16")
    np.testing.assert_allclose(_np(out), _np(want), rtol=STREAM_RTOL, atol=STREAM_ATOL)
    np.testing.assert_allclose(_np(ml), _np(want_ml), rtol=STREAM_RTOL, atol=STREAM_ATOL)
    grads = torch.autograd.grad(out, (tsa, tva, tsb, tvb), torch.from_numpy(cot))
    for got, ref, m, name in zip(grads, want_grads, (tma, tma, tmb, tmb), ("dsa", "dva", "dsb", "dvb")):
        np.testing.assert_allclose(_np(got), _np(ref), rtol=STREAM_GRAD_RTOL, atol=STREAM_GRAD_ATOL,
                                   err_msg=name)
        assert np.all(_np(got)[~m.numpy()] == 0)
    f32, _ = ca.csr_softmax_spmm_pair(tsa, tva, tga, tba, tsb, tvb, tgb, tbb, tma, tmb)
    assert np.abs(_np(out) - _np(f32)).max() > STREAM_DIFFERS


# --------------------------------------------------------------------------
# stream_dtype="bf16": the fused attention, csr_sparse_attention


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_sparse_attention_bf16_stream_matches_jax(name):
    """q and k on a 1/16 grid in [-2, 2] and a power-of-two scale make every
    f32 score exact whatever the order of its sum, so both sides round the
    same f32 score to bf16. (On arbitrary inputs a score within an f32 ulp
    of a bf16 rounding boundary rounds the other way on one side: a bf16
    ulp of the score, which no 1e-5 bound holds.) v is arbitrary: its
    rounding does not depend on an order."""
    r = np.random.default_rng(3)
    n, e, n_pad, e_pad, h, dh = 500, 3000, 512, 3072, 4, 8
    g = pad_graph_csr_np(np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
                         r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
                         n_pad, e_pad)
    scale = 0.25
    q, k = (r.integers(-32, 33, size=(n_pad, h, dh)).astype(np.float32) / 16 for _ in range(2))
    v = r.normal(size=(n_pad, h, dh)).astype(np.float32)
    cot = r.normal(size=(n_pad, h, dh)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if name == "f32" else (jnp.bfloat16, torch.bfloat16)
    # v's 16-bit values exactly, for bf16: both sides start from the same bits
    v = torch.from_numpy(v).to(tdt).float().numpy()
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    bounds = jax_pa.compute_block_bounds(g.senders, n_pad, num_real_edges=e)
    mc = jax_pa.compute_max_chunks_bounds(bounds)

    def jax_fn(a, b, c, stream_dtype):
        return jax_pa.csr_sparse_attention(a, b, c, jnp.asarray(g.senders), jnp.asarray(g.receivers),
                                           jnp.asarray(bounds), jnp.asarray(g.edge_mask), scale=scale,
                                           max_chunks=mc, stream_dtype=stream_dtype)

    jcot = jnp.asarray(cot).astype(jdt).astype(jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(jq, jk, jv, "bf16")
        want_grads = jax.grad(lambda *a: (jax_fn(*a, "bf16").astype(jnp.float32) * jcot).sum(),
                              argnums=(0, 1, 2))(jq, jk, jv)
    assert want.dtype == jdt
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    args = (torch.from_numpy(g.senders), torch.from_numpy(g.receivers), torch.from_numpy(g.sender_bounds),
            torch.from_numpy(g.edge_mask), scale)
    out = ca.csr_sparse_attention(tq, tk, tv, *args, stream_dtype="bf16")
    assert out.dtype == tdt
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(cot).to(tdt))
    if name == "f32":
        np.testing.assert_allclose(_np(out), _np(want), rtol=STREAM_RTOL, atol=STREAM_ATOL)
        limits = dict(rtol=STREAM_GRAD_RTOL, atol=STREAM_GRAD_ATOL)
    else:
        np.testing.assert_allclose(_np(out), _np(want), rtol=0, atol=BF16_FWD_ATOL * np.abs(_np(want)).max())
        limits = dict(rtol=BF16_GRAD_RTOL, atol=BF16_GRAD_ATOL)
    for got, ref, x in zip(grads, want_grads, "qkv"):
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), _np(ref), err_msg=f"d{x}", **limits)
    # the statistics: the plain version's ml against JAX's K2 on the scores
    # and values csr_sparse_attention streams, rounded as it rounds them
    _, ml = ca.csr_attention(tq, tk, tv, *args, stream_dtype="bf16")
    s_e = (q[g.senders] * k[g.receivers]).sum(-1) * scale
    s, sg, kb, kmc = _jax_k2_inputs(n_pad, g.senders, g.edge_mask, s_e.astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        _, want_ml = jax_pa._softmax_spmm_impl(s, jnp.asarray(v.reshape(n_pad, -1)[g.receivers]).astype(jdt),
                                               sg, kb, n_pad, h, jax_pa.BLOCK_NODES, jax_pa.BLOCK_EDGES, kmc,
                                               stream_dtype="bf16")
    np.testing.assert_allclose(_np(ml), _np(want_ml), rtol=STREAM_RTOL, atol=STREAM_ATOL)
    f32 = ca.csr_sparse_attention(tq, tk, tv, *args)
    assert np.abs(_np(out) - _np(f32)).max() > STREAM_DIFFERS


# --------------------------------------------------------------------------
# an unknown mode


def _tiny_csr():
    g = pad_graph_csr_np(np.zeros((10, 1), np.float32), np.zeros((10, 2), np.float32),
                         np.arange(30, dtype=np.int32) % 10, (np.arange(30, dtype=np.int32) * 3) % 10,
                         128, 32)
    return (torch.from_numpy(g.senders), torch.from_numpy(g.receivers), torch.from_numpy(g.sender_bounds),
            torch.from_numpy(g.edge_mask))


@pytest.mark.parametrize("fn", ["csr_softmax_spmm", "csr_softmax_spmm_pair", "csr_attention",
                                "csr_sparse_attention"])
def test_unknown_stream_dtype_raises_as_jax(fn):
    seg, gather, bounds, mask = _tiny_csr()
    e = seg.shape[0]
    s, v = torch.zeros(e, 2), torch.zeros(e, 32)
    q = torch.zeros(128, 2, 16)
    calls = {
        "csr_softmax_spmm": lambda sd: ca.csr_softmax_spmm(s, v, seg, bounds, mask, stream_dtype=sd),
        "csr_softmax_spmm_pair": lambda sd: ca.csr_softmax_spmm_pair(s, v, seg, bounds, s, v, seg, bounds,
                                                                     mask, mask, stream_dtype=sd),
        "csr_attention": lambda sd: ca.csr_attention(q, q, q, seg, gather, bounds, mask, stream_dtype=sd),
        "csr_sparse_attention": lambda sd: ca.csr_sparse_attention(q, q, q, seg, gather, bounds, mask,
                                                                   stream_dtype=sd),
    }
    with pytest.raises(ValueError, match="unknown stream_dtype 'fp8'"):
        calls[fn]("fp8")
    # the op too, called directly
    with pytest.raises(ValueError, match="unknown stream_dtype 'fp8'"):
        ca._softmax_spmm_op(s, v, seg, bounds, mask, "fp8")
    jb = jax_pa.compute_block_bounds(seg.numpy(), 128)
    with pytest.raises(ValueError, match="unknown stream_dtype 'fp8'"):
        jax_pa._softmax_spmm_impl(jnp.zeros((e, 2)), jnp.zeros((e, 32)), jnp.asarray(seg.numpy()),
                                  jnp.asarray(jb), 128, 2, 128, 512, 1, stream_dtype="fp8")
    for sd in ca.STREAM_DTYPES:  # the known modes run
        calls[fn](sd)


# --------------------------------------------------------------------------
# the lane geometries K1's entries and K5's stream entry choose by shape and
# alignment (the kernels' rules, mirrored in Python for the card's records)


@pytest.mark.parametrize("width,dtype,aligned,want", [
    (128, torch.bfloat16, 16, ("words16", 8, 16, 2, 8)),  # the models' width: two rows a warp
    (64, torch.float16, 16, ("words16", 8, 8, 4, 8)),  # four rows a warp
    (48, torch.bfloat16, 16, ("words16", 8, 8, 4, 8)),  # 6 words: 8 lanes, two idle
    (40, torch.float16, 16, ("words16", 8, 8, 4, 8)),  # 5 words
    (512, torch.bfloat16, 16, ("words16", 8, 32, 1, 8)),  # 256-column blocks
    (127, torch.bfloat16, 16, ("columns", 1, 32, 1, 1)),  # an odd width
    (126, torch.float16, 16, ("pairs", 2, 32, 1, 1)),  # even, not a multiple of 8
    (128, torch.bfloat16, 8, ("pairs", 2, 32, 1, 1)),  # a view 8-byte aligned
    (128, torch.float16, 4, ("pairs", 2, 32, 1, 1)),  # 4-byte aligned
    (128, torch.bfloat16, 2, ("columns", 1, 32, 1, 1)),  # 2-byte aligned
    (128, torch.float32, 16, ("words16", 4, 32, 1, 8)),  # the f32 entry: 4 columns a word, a row a warp
    (64, torch.float32, 16, ("words16", 4, 16, 2, 8)),  # two rows a warp
    (48, torch.float32, 16, ("words16", 4, 16, 2, 8)),  # 12 words: 16 lanes, four idle
    (130, torch.float32, 16, ("columns", 1, 32, 1, 1)),  # not a multiple of 4
    (256, torch.float32, 16, ("words16", 4, 32, 1, 8)),  # 128-column blocks
    (128, torch.float32, 4, ("columns", 1, 32, 1, 1)),  # a view 4-byte aligned
    (128, torch.float32, 8, ("columns", 1, 32, 1, 1)),  # 8-byte aligned
])
def test_segment_sum_geometry(width, dtype, aligned, want):
    from graphphysics_torch.ops.csr_segment import segment_sum_geometry

    assert tuple(segment_sum_geometry(width, dtype, aligned)) == want


@pytest.mark.parametrize("width,heads,aligned,want", [
    (128, 4, 16, ("words16", 8, 16, 2, 8)),  # the panels width: 16 lanes, two rows a warp
    (64, 4, 16, ("words16", 8, 8, 4, 8)),  # the aneurysm width: four rows a warp
    (48, 4, 16, ("words8", 4, 16, 2, 8)),  # heads of 12: 8-byte words, 12 lanes of 16
    (40, 8, 16, ("general", 2, 32, 1, 1)),  # heads of 5
    (96, 3, 16, ("words16", 8, 16, 2, 8)),  # 3 heads of 32: 12 lanes of 16
    (256, 8, 16, ("words16", 8, 32, 1, 8)),  # 32 lanes
    (512, 4, 16, ("general", 16, 32, 1, 1)),  # past 32 words
    (128, 4, 8, ("words8", 4, 32, 1, 8)),  # values 8-byte aligned
    (128, 4, 4, ("general", 4, 32, 1, 1)),  # values 4-byte aligned
    (64, 4, 2, ("general", 2, 32, 1, 1)),
])
def test_pair_stream_geometry(width, heads, aligned, want):
    assert tuple(ca.stream_geometry(width, heads, aligned)) == want


@pytest.mark.parametrize("width,heads", [(130, 4), (544, 4), (128, 0)])
def test_pair_stream_geometry_refuses_what_the_entry_refuses(width, heads):
    assert ca.stream_geometry(width, heads, 16) is None


def test_alignment_reads_each_view_offset():
    """``alignment`` gives the byte alignment of a view's first element (at
    most 16), the least over its tensors, ignoring None and empty ones; the
    card checks' ``view_at`` places a copy at each alignment."""
    import chip_stream
    from graphphysics_torch.ops.csr_segment import alignment

    flat = torch.zeros(64 * 8, dtype=torch.bfloat16)
    assert [alignment(flat[k:]) for k in range(9)] == [16, 2, 4, 2, 8, 2, 4, 2, 16]
    assert alignment(flat, flat[2:], None, flat[:0]) == 4
    data = torch.randn(6, 8).to(torch.bfloat16)
    for aligned in chip_stream.ALIGNMENTS:
        view = chip_stream.view_at(data, aligned)
        assert alignment(view) == aligned and torch.equal(view, data)


def test_geometry_rules_follow_the_kernels_constants():
    """The rules' words and windows are the CUDA sources' own constants."""
    import re
    from pathlib import Path

    from graphphysics_torch.ops import csr_segment as cseg

    csrc = Path(cseg.__file__).resolve().parent.parent / "csrc"

    def constant(source, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", (csrc / source).read_text()).group(1))

    assert constant("csr_segment_sum.cu", "kWordCols") == cseg.WORD_COLUMNS
    assert constant("csr_segment_sum.cu", "kF32WordCols") == cseg.F32_WORD_COLUMNS
    assert constant("csr_segment_sum.cu", "kEdgeGroup") == cseg.EDGE_GROUP
    assert constant("csr_softmax_spmm_pair.cu", "kEdgeGroup") == cseg.EDGE_GROUP
    assert constant("csr_softmax_spmm.cu", "kEdgeGroup") == cseg.EDGE_GROUP


# --------------------------------------------------------------------------
# the ops: schemas, fake implementations, the CUDA argument checks


def test_op_schemas_take_stream_dtype_defaulting_to_f32():
    for op in (ca._softmax_spmm_op, ca._pair_op, ca._attention_op):
        arg = op._schema.arguments[-1]
        assert (arg.name, arg.default_value) == ("stream_dtype", "f32"), op


@pytest.mark.parametrize("name", ["bf16", "f16"])
def test_segment_sum_fakes_keep_the_16bit_dtype(name):
    """The fake implementations (what ``torch.export`` traces) give the
    16-bit entries' output dtype: the data's, as the kernels write it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from graphphysics_torch.ops import csr_segment as cseg

    tdt = DTYPES[name][0]
    recv = np.sort(np.random.default_rng(0).integers(0, 10, 40)).astype(np.int32)
    args = (torch.from_numpy(recv), torch.from_numpy(compute_row_bounds(recv, 10)), None)
    with FakeTensorMode() as mode:
        data, g = (mode.from_tensor(torch.zeros(shape, dtype=tdt)) for shape in ((40, 8), (10, 8)))
        fake_args = tuple(mode.from_tensor(a) if a is not None else a for a in args)
        out = cseg._segment_sum_op(data, *fake_args)
        grad = cseg._segment_sum_backward_op(g, *fake_args)
    assert (out.dtype, tuple(out.shape)) == (tdt, (10, 8))
    assert (grad.dtype, tuple(grad.shape)) == (tdt, (40, 8))


def test_segment_sum_cuda_checks_take_the_three_entries():
    """The CUDA implementation's argument check (run before any launch)
    takes float32, bfloat16 and float16 data and refuses the rest; each
    entry counts on its own counter."""
    from graphphysics_torch.ops import csr_segment as cseg

    recv = torch.zeros(6, dtype=torch.int32)
    bounds = torch.tensor([[0], [6]], dtype=torch.int32)
    for dt, entry in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.float16, "f16")):
        cseg._check_cuda_args("t", torch.zeros(6, 4, dtype=dt), 6, recv, bounds, None)
        assert cseg.ENTRIES[dt] == entry
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        cseg._check_cuda_args("t", torch.zeros(6, 4, dtype=torch.float64), 6, recv, bounds, None)
    assert cseg.LAUNCHES["csr_segment_sum_f32"] is csr_segment_sum
    assert cseg.LAUNCHES["csr_segment_sum_bf16"] is csr_segment_sum.bf16
    assert cseg.LAUNCHES["csr_segment_sum_bwd_f16"] is cseg.csr_segment_sum_backward.f16
    assert ca.LAUNCHES["csr_attention_f32_stream"] is ca.csr_attention.f32_stream
    assert ca.LAUNCHES["csr_attention_bf16_stream"] is ca.csr_attention.bf16_stream
