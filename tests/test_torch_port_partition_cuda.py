"""Card tests of K5 (``csr_softmax_spmm_pair``, ``csrc/csr_softmax_spmm_pair.cu``):
its forward and backward kernels against their plain versions at widths of
both geometries, masks, rows empty on one side or both and padding slots;
the backward twice bit for bit; the pair against K2 on the concatenated
edges; autograd through the wrapper. Marked ``cuda``; they skip without a
card. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_partition_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    return torch.device("cuda")


def pair_case(n, ea, eb, d, h, seed, pad=64, hi_b=None):
    """Two receiver-sorted edge sets over ``n`` rows with their ranges, a
    mask dropping every fifth edge, and ``pad`` trailing padding slots
    each (outside every range)."""
    from graphphysics_torch.ops.csr_segment import compute_row_bounds

    r = np.random.default_rng(seed)
    sets = []
    for e, hi in ((ea, n), (eb, n if hi_b is None else hi_b)):
        seg = np.sort(r.integers(0, hi, e)).astype(np.int32)
        seg = np.concatenate([seg, np.full(pad, n - 1, np.int32)])
        bounds = compute_row_bounds(seg, n, num_real_edges=e)
        mask = np.ones(e + pad, bool)
        mask[e:] = False
        mask[::5] = False
        scores = r.standard_normal((e + pad, h)).astype(np.float32) * 3
        values = r.standard_normal((e + pad, d)).astype(np.float32)
        sets.append(tuple(torch.from_numpy(a) for a in (scores, values, seg, bounds, mask)))
    return sets


@pytest.mark.parametrize(
    "n,ea,eb,d,h,hi_b",
    [
        (4096, 24000, 2000, 128, 4, None),  # a part of the 8 x 2,048 batch, P = 4
        (1000, 6000, 1500, 64, 4, None),  # heads of 16 columns: lane-group sums
        (700, 4000, 800, 48, 3, None),  # lane groups over a part-filled slot
        (512, 3000, 300, 48, 4, 40),  # sums through shared memory; most halo rows empty
        (256, 2000, 500, 512, 8, None),  # the widest
        (300, 1000, 0, 40, 8, None),  # no halo edges
        (64, 0, 0, 32, 1, None),  # only padding
    ],
)
def test_pair_kernels_match_plain(cuda, n, ea, eb, d, h, hi_b):
    from graphphysics_torch.ops.csr_attention import (
        csr_softmax_spmm_pair,
        csr_softmax_spmm_pair_backward,
        csr_softmax_spmm_pair_backward_reference,
        csr_softmax_spmm_pair_reference,
    )

    (sa, va, ga, ba, ma), (sb, vb, gb, bb, mb) = pair_case(n, ea, eb, d, h, seed=n + d, hi_b=hi_b)
    dev = [t.to(cuda) for t in (sa, va, ga, ba, ma, sb, vb, gb, bb, mb)]
    s_a, v_a, g_a, b_a, m_a, s_b, v_b, g_b, b_b, m_b = dev
    before = csr_softmax_spmm_pair.launches
    with torch.no_grad():
        out, ml = csr_softmax_spmm_pair(s_a, v_a, g_a, b_a, s_b, v_b, g_b, b_b, m_a, m_b)
    assert csr_softmax_spmm_pair.launches == before + 1
    want_out, want_ml = csr_softmax_spmm_pair_reference(sa, va, ga, sb, vb, gb, n, ma, mb)
    torch.testing.assert_close(out.cpu(), want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml.cpu(), want_ml, rtol=1e-5, atol=1e-5)

    g = torch.randn(n, d, generator=torch.Generator().manual_seed(1))
    before = csr_softmax_spmm_pair_backward.launches
    got = csr_softmax_spmm_pair_backward(s_a, v_a, g_a, b_a, s_b, v_b, g_b, b_b, ml, out,
                                         g.to(cuda), m_a, m_b)
    again = csr_softmax_spmm_pair_backward(s_a, v_a, g_a, b_a, s_b, v_b, g_b, b_b, ml, out,
                                           g.to(cuda), m_a, m_b)
    assert csr_softmax_spmm_pair_backward.launches == before + 2
    want = csr_softmax_spmm_pair_backward_reference(sa, va, ga, sb, vb, gb, ml.cpu(), out.cpu(),
                                                    g, ma, mb)
    for a, b, c, m in zip(got, want, again, (ma, ma, mb, mb)):
        assert torch.equal(a, c)  # no atomics: bit for bit
        # the fused backward's limits: a head's dot over D/H columns sums
        # in another order than the plain version's
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
        assert torch.all(a.cpu()[~m] == 0)


def test_pair_equals_single_softmax_spmm_on_the_union_and_autograd(cuda):
    from graphphysics_torch.ops.csr_attention import (
        csr_softmax_spmm,
        csr_softmax_spmm_pair,
        csr_softmax_spmm_pair_backward,
    )
    from graphphysics_torch.ops.csr_segment import compute_row_bounds

    n, d, h = 1024, 128, 4
    (sa, va, ga, ba, ma), (sb, vb, gb, bb, mb) = pair_case(n, 6000, 900, d, h, seed=3)
    # the union: both sets' unmasked edges, sorted by row
    keep_a, keep_b = ma.numpy(), mb.numpy()
    seg = np.concatenate([ga.numpy()[keep_a], gb.numpy()[keep_b]])
    order = np.argsort(seg, kind="stable")
    scores = torch.cat([sa[ma], sb[mb]])[order].contiguous()
    values = torch.cat([va[ma], vb[mb]])[order].contiguous()
    bounds = torch.from_numpy(compute_row_bounds(seg[order], n))
    with torch.no_grad():
        want, _ = csr_softmax_spmm(scores.to(cuda), values.to(cuda),
                                   torch.from_numpy(seg[order]).to(cuda), bounds.to(cuda))
    leaves = [t.to(cuda).requires_grad_(i in (0, 1, 4, 5))
              for i, t in enumerate((sa, va, ga, ba, sb, vb, gb, bb, ma, mb))]
    before = csr_softmax_spmm_pair_backward.launches
    out, _ = csr_softmax_spmm_pair(*leaves)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(out, [leaves[i] for i in (0, 1, 4, 5)], torch.ones_like(out))
    assert csr_softmax_spmm_pair_backward.launches == before + 1
    assert all(torch.isfinite(t).all() for t in grads)
