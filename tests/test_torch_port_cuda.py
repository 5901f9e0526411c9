"""Card tests of the port's CUDA kernels: ``csr_segment_sum`` and
``csr_softmax_spmm`` against their plain versions on edge cases, and the EPD
and transformer forwards on the card against the CPU. Marked ``cuda``; they
skip without a card. This file imports no JAX, so on a machine without it
run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _atol(bounds):
    """f32 sums of the same terms in another order: the error grows with
    the longest row's length."""
    longest = int((bounds[1] - bounds[0]).max().item()) if bounds.numel() else 0
    return 1e-5 + 2e-6 * longest


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layout(n, e, seed, hi=None, n_pad=None, e_pad=None):
    from graphphysics_torch.core import pad_graph_sorted_np

    r = np.random.default_rng(seed)
    n_pad = n if n_pad is None else n_pad
    e_pad = e if e_pad is None else e_pad
    recv = r.integers(0, n if hi is None else hi, e).astype(np.int32)
    return pad_graph_sorted_np(
        np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
        r.integers(0, n, e).astype(np.int32), recv, n_pad, e_pad,
    )


@pytest.mark.parametrize(
    "n,e,h,hi,n_pad,e_pad",
    [
        (2048, 11906, 128, None, 2048, 13696),  # serving frame, n_pad == n
        (300, 2000, 48, None, 320, 2048),  # width not a multiple of 32
        (1000, 4000, 128, 5, None, None),  # skewed: long rows, most rows empty
        (64, 0, 16, None, 64, 128),  # only padding edges
        (7, 30, 1, None, None, None),  # width 1
    ],
)
def test_kernel_matches_plain(cuda, n, e, h, hi, n_pad, e_pad):
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_reference

    g = _layout(n, e, seed=n + e, hi=hi, n_pad=n_pad, e_pad=e_pad)
    recv = torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.row_bounds).to(cuda)
    mask = torch.from_numpy(g.edge_mask).to(cuda)
    mask[::7] = False  # masked edges inside the row ranges too
    data = torch.randn(g.num_edges, h, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    before = csr_segment_sum.launches
    got = csr_segment_sum(data, recv, bounds, mask)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 1
    want = csr_segment_sum_reference(data, recv, g.num_nodes, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=_atol(bounds))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from graphphysics_torch.ops.csr_segment import csr_segment_sum
    from graphphysics_torch.ops.segment import masked_segment_sum

    g = _layout(32, 100, seed=0)
    recv = torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.row_bounds).to(cuda)
    data = torch.randn(100, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        csr_segment_sum(data.double(), recv, bounds)
    with pytest.raises(ValueError, match="contiguous"):
        csr_segment_sum(torch.randn(8, 100, device=cuda).t(), recv, bounds)
    with pytest.raises(ValueError, match="int32"):
        csr_segment_sum(data, recv, bounds.long())
    with pytest.raises(ValueError, match="no backward"):
        csr_segment_sum(data.requires_grad_(True), recv, bounds)
    with pytest.raises(ValueError, match="row_bounds"):
        masked_segment_sum(data.detach(), recv, 32)
    out16 = masked_segment_sum(data.detach().half(), recv, 32, row_bounds=bounds)
    assert out16.dtype == torch.float16


def test_epd_forward_on_card_matches_cpu(cuda):
    from graphphysics_torch.core import pad_graph_sorted_np
    from graphphysics_torch.models import (
        EncodeProcessDecode, Simulator, SimulatorConfig, reset_parameters,
    )
    from graphphysics_torch.ops.csr_segment import csr_segment_sum

    cfg = SimulatorConfig(11, 3, 2, 0, 2, 0, 2, 2)
    r = np.random.default_rng(0)
    n, e = 500, 3000
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    g = pad_graph_sorted_np(
        x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), 512, 3200,
        edge_attr=r.normal(size=(e, 3)).astype(np.float32),
        y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
    )
    sims = {}
    for dev in ("cpu", "cuda"):
        model = reset_parameters(EncodeProcessDecode(3, 11, 3, 2, 32), torch.Generator().manual_seed(0))
        sims[dev] = Simulator(cfg, model, device=dev)
        sims[dev].accumulate_stats(g.to(dev))
    before = csr_segment_sum.launches
    with torch.inference_mode():
        on_card = sims["cuda"](g.to("cuda"))[2].cpu()
        on_cpu = sims["cpu"](g.to("cpu"))[2]
    assert csr_segment_sum.launches == before + 3
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-4)


def _csr_case(n, e, d, h, seed, hi=None, n_pad=None, e_pad=None, mask_every=5):
    from graphphysics_torch.core import pad_graph_csr_np

    r = np.random.default_rng(seed)
    n_pad = n if n_pad is None else n_pad
    e_pad = e if e_pad is None else e_pad
    g = pad_graph_csr_np(
        np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
        r.integers(0, n if hi is None else hi, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), n_pad, e_pad,
    )
    gen = torch.Generator().manual_seed(seed)
    scores = 3 * torch.randn(g.num_edges, h, generator=gen)
    values = torch.randn(g.num_edges, d, generator=gen)
    mask = torch.from_numpy(g.edge_mask).clone()
    mask[::mask_every] = False  # masked edges inside the ranges too
    return g, scores, values, mask


@pytest.mark.parametrize(
    "n,e,d,h,hi,n_pad,e_pad",
    [
        (2048, 11906, 128, 4, None, 2048, 13696),  # transformer serving frame, n_pad == n
        (2000, 12000, 64, 4, None, 2048, 12288),  # aneurysm width, padding nodes
        (1000, 4000, 128, 4, 5, 1024, 4096),  # skewed: long rows, most rows empty
        (300, 2000, 96, 4, None, 384, 2048),  # 3 columns a lane: scalar loads
        (300, 2000, 512, 8, None, 384, 2048),  # the widest D
        (128, 0, 32, 4, None, 128, 256),  # only padding edges
    ],
)
def test_softmax_spmm_kernel_matches_plain(cuda, n, e, d, h, hi, n_pad, e_pad):
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm, csr_softmax_spmm_reference

    g, scores, values, mask = _csr_case(n, e, d, h, seed=n + e + d, hi=hi, n_pad=n_pad, e_pad=e_pad)
    seg = torch.from_numpy(g.senders).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    args = (scores.to(cuda), values.to(cuda), seg)
    before = csr_softmax_spmm.launches
    out, ml = csr_softmax_spmm(*args, bounds, mask.to(cuda))
    torch.cuda.synchronize()
    assert csr_softmax_spmm.launches == before + 1
    want_out, want_ml = csr_softmax_spmm_reference(*args, g.num_nodes, mask.to(cuda))
    # online vs two-pass softmax in f32: a few ulps per edge of the longest row
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)


def test_softmax_spmm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from graphphysics_torch.ops.attention import sparse_graph_attention
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm

    g, scores, values, mask = _csr_case(128, 500, 64, 4, seed=0, n_pad=128, e_pad=512)
    seg = torch.from_numpy(g.senders).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    s, v = scores.to(cuda), values.to(cuda)
    with pytest.raises(ValueError, match="float32"):
        csr_softmax_spmm(s.double(), v, seg, bounds)
    with pytest.raises(ValueError, match="positive multiple of 32"):
        csr_softmax_spmm(s, v[:, :48].contiguous(), seg, bounds)
    with pytest.raises(ValueError, match="at most 512"):
        csr_softmax_spmm(s, torch.zeros(512, 640, device=cuda), seg, bounds)
    with pytest.raises(ValueError, match="head_dim"):
        csr_softmax_spmm(s[:, :3].contiguous(), v, seg, bounds)
    with pytest.raises(ValueError, match="contiguous"):
        csr_softmax_spmm(s, torch.zeros(64, 512, device=cuda).t(), seg, bounds)
    with pytest.raises(ValueError, match="int32"):
        csr_softmax_spmm(s, v, seg, bounds.long())
    with pytest.raises(ValueError, match="no backward"):
        csr_softmax_spmm(s.requires_grad_(True), v, seg, bounds)
    q = torch.zeros(128, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="sender_bounds"):
        sparse_graph_attention(q, q, q, seg, seg, 128)


def test_transformer_forward_on_card_matches_cpu(cuda):
    from graphphysics_torch.core import pad_graph_csr_np
    from graphphysics_torch.models import (
        EncodeTransformDecode, Simulator, SimulatorConfig, reset_parameters,
    )
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm
    from graphphysics_torch.ops.csr_segment import csr_segment_sum

    cfg = SimulatorConfig(11, 0, 3, 0, 2, 0, 3, 3)
    r = np.random.default_rng(0)
    n, e = 500, 3000
    x = r.normal(size=(n, 5)).astype(np.float32)
    x[:, 3] = r.integers(0, 7, n)
    g = pad_graph_csr_np(
        x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), 512, 3200,
        y=r.normal(size=(n, 3)).astype(np.float32), node_type_index=3,
    )
    sims = {}
    for dev in ("cpu", "cuda"):
        model = reset_parameters(EncodeTransformDecode(3, 11, 3, 64, 4), torch.Generator().manual_seed(0))
        sims[dev] = Simulator(cfg, model, device=dev)
        sims[dev].accumulate_stats(g.to(dev))
    before = (csr_softmax_spmm.launches, csr_segment_sum.launches)
    with torch.inference_mode():
        on_card = sims["cuda"](g.to("cuda"))[2].cpu()
        on_cpu = sims["cpu"](g.to("cpu"))[2]
    assert (csr_softmax_spmm.launches, csr_segment_sum.launches) == (before[0] + 3, before[1])
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-4)
