"""Card tests of the port's CUDA kernel: ``csr_segment_sum`` against its
plain version on edge cases, and the EPD forward on the card against the
CPU. Marked ``cuda``; they skip without a card. This file imports no JAX, so
on a machine without it run them with

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
