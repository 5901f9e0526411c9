"""Port parity, the ops on 16-bit data: ``take_rows``'s f32-accumulating
backward, ``masked_segment_sum`` and ``segment_softmax`` on bf16 (twins of
``test_ops.py``'s bf16 tests), and the fused CSR attention's plain versions
(``csr_attention_reference`` and ``csr_attention_backward_reference``, what
the card's ``csr_attention_bf16`` and ``csr_attention_bwd_bf16`` are held
against) fed bf16 q, k and v, against the JAX ``csr_sparse_attention`` (K2
in TPU interpret mode) fed the same bf16 arrays: forward and ``(dq, dk,
dv)``, in the model's interleaved layout, head-blocked, and at a width of
the kernels' general geometry. Everything runs on the CPU; inputs come from
numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_tpu.ops import segment as jax_seg
from graphphysics_torch.core.graph import pad_graph_csr_np
from graphphysics_torch.ops.csr_attention import csr_attention
from graphphysics_torch.ops.segment import masked_segment_sum, segment_softmax, take_rows
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

BF16 = torch.bfloat16


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16)


def _np32(t) -> np.ndarray:
    return np.asarray(t.detach().float().numpy() if torch.is_tensor(t) else jnp.asarray(t, jnp.float32))


def test_take_rows_bf16_grad_sums_in_f32():
    """Twin of ``test_take_rows_bf16_grad_matches_f32_scatter``: the bf16
    gather's gradient equals the f32 scatter of the bf16 cotangents rounded
    once (JAX's custom VJP) exactly, and the JAX one to bf16 tolerance."""
    r = np.random.default_rng(0)
    n, e, h = 11, 40, 8
    x32 = r.normal(size=(n, h)).astype(np.float32)
    idx = r.integers(0, n, size=e).astype(np.int32)
    w = r.normal(size=(e, h)).astype(np.float32)

    def loss_jax(x):
        return (jax_seg.take_rows(x.astype(jnp.bfloat16), jnp.asarray(idx)).astype(jnp.float32) * w).sum()

    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(x32)))
    x = torch.from_numpy(x32).requires_grad_(True)
    rows = take_rows(x.to(BF16), torch.from_numpy(idx))
    assert rows.dtype == BF16
    (rows.float() * torch.from_numpy(w)).sum().backward()
    g16 = (torch.from_numpy(w).to(BF16)).float()  # the cotangent of the bf16 rows
    exact = torch.zeros(n, h).index_add_(0, torch.from_numpy(idx).long(), g16).to(BF16).float()
    assert torch.equal(x.grad, exact)
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=2e-2, atol=2e-2)
    # an odd width takes index_select, as JAX takes jnp.take
    odd = torch.from_numpy(x32[:, :7]).to(BF16)
    assert torch.equal(take_rows(odd, torch.from_numpy(idx)), odd.index_select(0, torch.from_numpy(idx)))


def test_masked_segment_sum_bf16_accumulates_f32():
    """Twin of ``test_masked_segment_sum_bf16_accumulates_f32``."""
    r = np.random.default_rng(1)
    e, n, f = 64, 10, 6
    data = r.normal(size=(e, f)).astype(np.float32)
    seg = r.integers(0, n, size=e).astype(np.int32)
    out = masked_segment_sum(_bf16(data), torch.from_numpy(seg), n)
    assert out.dtype == BF16
    want = np.asarray(jax_seg.masked_segment_sum(jnp.asarray(data).astype(jnp.bfloat16), jnp.asarray(seg), n))
    expected = np.zeros((n, f), np.float32)
    for i in range(e):
        expected[seg[i]] += _np32(_bf16(data[i]))
    np.testing.assert_array_equal(_np32(out), _np32(want))
    np.testing.assert_allclose(_np32(out), expected, rtol=2e-2, atol=2e-2)


def test_segment_softmax_bf16_matches_f32():
    """Twin of ``test_segment_softmax_bf16_matches_f32``: f32 inside, bf16
    out, as JAX."""
    r = np.random.default_rng(2)
    e, n = 50, 8
    scores = r.normal(size=(e, 4)).astype(np.float32)
    seg = r.integers(0, n, size=e).astype(np.int32)
    mask = r.random(e) > 0.2
    out16 = segment_softmax(_bf16(scores), torch.from_numpy(seg), n, torch.from_numpy(mask))
    out32 = segment_softmax(torch.from_numpy(scores), torch.from_numpy(seg), n, torch.from_numpy(mask))
    want16 = jax_seg.segment_softmax(jnp.asarray(scores).astype(jnp.bfloat16), jnp.asarray(seg), n,
                                     jnp.asarray(mask))
    assert out16.dtype == BF16
    np.testing.assert_allclose(_np32(out16), out32.numpy(), atol=1e-2)
    np.testing.assert_array_equal(_np32(out16), _np32(want16))


# csr_attention on bf16 against the JAX csr_sparse_attention on the same
# bf16 arrays. Forward: both compute in f32 and round out to bf16 once, so
# they differ only where f32 sums in another order round across a bf16
# boundary: one bf16 ulp of the output's scale. Backward: (dq, dk, dv) from
# bf16 out and g, per-edge terms in f32; JAX rounds each edge's term to bf16
# and sums them in bf16 (its gathers' backward), the port sums them in f32
# and rounds once, which is more accurate: held to bf16 accumulation's error.
ATTN_FWD_ATOL = 2.0 ** -7
ATTN_GRAD_RTOL, ATTN_GRAD_ATOL = 3e-2, 3e-2


@pytest.mark.parametrize("width,heads,layout", [
    (64, 4, "interleaved"),   # the model's (N, Dh, H) view
    (64, 4, "blocked"),       # contiguous [N, H, Dh]
    (48, 4, "interleaved"),   # the kernels' word geometry
])
def test_csr_attention_plain_bf16_matches_jax(width, heads, layout):
    r = np.random.default_rng(width + heads)
    n, e, n_pad, e_pad = 300, 1800, 384, 2048
    g = pad_graph_csr_np(np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
                         r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
                         n_pad, e_pad)
    dh = width // heads
    scale = heads ** -0.5
    qkv = [r.normal(size=(n_pad, heads, dh)).astype(np.float32) for _ in range(3)]
    cot = r.normal(size=(n_pad, heads, dh)).astype(np.float32)
    jqkv = [jnp.asarray(a).astype(jnp.bfloat16) for a in qkv]
    jcot = jnp.asarray(cot).astype(jnp.bfloat16).astype(jnp.float32)
    bounds = jax_pa.compute_block_bounds(g.senders, n_pad, num_real_edges=e)
    mc = jax_pa.compute_max_chunks_bounds(bounds)

    def jax_fn(q, k, v):
        return jax_pa.csr_sparse_attention(q, k, v, jnp.asarray(g.senders), jnp.asarray(g.receivers),
                                           jnp.asarray(bounds), jnp.asarray(g.edge_mask), scale=scale,
                                           max_chunks=mc)

    with pltpu.force_tpu_interpret_mode():
        want = jax_fn(*jqkv)
        want_grads = jax.grad(lambda *a: (jax_fn(*a).astype(jnp.float32) * jcot).sum(),
                              argnums=(0, 1, 2))(*jqkv)
    assert want.dtype == jnp.bfloat16

    def port(a):
        t = _bf16(a)
        if layout == "interleaved":  # the (N, Dh, H) memory the model's Attention passes
            t = t.transpose(1, 2).contiguous().transpose(1, 2)
        return t.requires_grad_(True)

    q, k, v = (port(a) for a in qkv)
    out, ml = csr_attention(q, k, v, torch.from_numpy(g.senders), torch.from_numpy(g.receivers),
                            torch.from_numpy(g.sender_bounds), torch.from_numpy(g.edge_mask), scale)
    assert out.dtype == BF16 and ml.dtype == torch.float32
    np.testing.assert_allclose(_np32(out), _np32(want), rtol=0, atol=ATTN_FWD_ATOL * np.abs(_np32(want)).max())
    grads = torch.autograd.grad(out, (q, k, v), _bf16(cot))
    for got, theirs, name in zip(grads, want_grads, "qkv"):
        assert got.dtype == BF16
        np.testing.assert_allclose(_np32(got), _np32(theirs), rtol=ATTN_GRAD_RTOL, atol=ATTN_GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_attention_checks_take_bf16_and_refuse_the_rest():
    """The fused kernels' argument checks (run before any launch) take q, k
    and v all bf16 in either layout, and refuse mixed dtypes, other 16-bit
    types, a bf16 width that is not a multiple of 4 and a bf16 row base
    that is not 8-byte aligned; the entry and the launch count follow the
    dtype. A bf16 width of 16-byte lanes takes them where every row base is
    16-byte aligned, and the general geometry where one is only 8-byte
    aligned."""
    from graphphysics_torch.ops import csr_attention as ca

    n = 128
    g = pad_graph_csr_np(np.zeros((100, 1), np.float32), np.zeros((100, 2), np.float32),
                         np.arange(300, dtype=np.int32) % 100, (np.arange(300, dtype=np.int32) * 7) % 100,
                         n, 384)
    bounds, gather = torch.from_numpy(g.sender_bounds), torch.from_numpy(g.receivers)
    q = torch.zeros(n, 4, 12, dtype=BF16)
    assert ca._check_attention_args("t", q, q, q, gather, bounds, None) is False
    view = torch.zeros(n, 12, 4, dtype=BF16).transpose(1, 2)
    assert ca._check_attention_args("t", view, view, view, gather, bounds, None) is True
    with pytest.raises(ValueError, match="share one dtype"):
        ca._check_attention_args("t", q, q.float(), q, gather, bounds, None)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        h = q.half()
        ca._check_attention_args("t", h, h, h, gather, bounds, None)
    with pytest.raises(ValueError, match="multiple of 4"):
        odd = torch.zeros(n, 2, 3, dtype=BF16)
        ca._check_attention_args("t", odd, odd, odd, gather, bounds, None)
    with pytest.raises(ValueError, match="8-byte aligned"):
        shifted = torch.zeros(n * 48 + 2, dtype=BF16)[2:].view(n, 4, 12)
        ca._check_attention_args("t", shifted, shifted, shifted, gather, bounds, None)
    wide = torch.zeros(n, 4, 16, dtype=BF16)
    assert ca._check_attention_args("t", wide, wide, wide, gather, bounds, None) is False
    assert ca._bf16_geometry(wide, (wide, wide), False, None, None) == (8, "fast")
    eight = torch.zeros(n * 64 + 4, dtype=BF16)[4:].view(n, 4, 16)  # 8-byte, not 16-byte, aligned
    assert ca._check_attention_args("t", eight, eight, eight, gather, bounds, None) is False
    # 8-byte rows: the word geometry's 4-column words, 16 lanes a row
    assert ca._bf16_geometry(eight, (eight, eight), False, None, None) == (16, "words")
    assert ca._bf16_geometry(wide, (wide, eight), False, None, None) == (16, "words")
    assert ca.ENTRIES[torch.bfloat16] == "bf16" and ca.ENTRIES[torch.float32] == "f32"
    assert ca.LAUNCHES["csr_attention_bf16"] is ca.csr_attention.bf16
    assert ca.LAUNCHES["csr_attention_bwd_f32"] is ca.csr_attention_backward
