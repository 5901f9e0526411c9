"""Port twins of ``tests/test_profiling.py``
(``graphphysics_torch/utils/profiling.py``): the chained-step timer threads
the state through the chain, ``fetch_sync`` takes nested structures, the
throughput meter; then the ``torch.profiler`` trace, by hand and through
the Trainer's ``profile_dir``."""

import json
import os

import torch

from graphphysics_torch.utils.profiling import (
    ThroughputMeter,
    fetch_sync,
    time_chained_steps,
    trace,
)
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def test_time_chained_steps_threads_state_and_times():
    def step(state, batch):
        new = state + batch.sum()
        return new, new[0]

    sec, out = time_chained_steps(step, torch.zeros(4), torch.ones(8), iters=5, warmup=2)
    assert sec > 0
    # 2 warm-up + 5 timed dependent steps, each adds sum(batch) = 8
    torch.testing.assert_close(out, torch.full((4,), 7 * 8.0))


def test_fetch_sync_handles_nested_structures_and_scalars():
    fetch_sync(torch.ones(()), {"a": torch.arange(3), "b": None})
    fetch_sync((None,))  # no tensors
    fetch_sync({"empty": torch.zeros((0,)), "full": torch.ones((2,))})
    fetch_sync(torch.zeros((0, 3)))


def test_throughput_meter():
    m = ThroughputMeter(edges_per_step=100, window=4)
    assert m.edges_per_sec == 0.0
    for _ in range(5):
        m.tick()
    assert m.steps_per_sec > 0
    assert m.edges_per_sec == m.steps_per_sec * 100


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_trainer_profile_dir_traces_its_window(tmp_path):
    """``Trainer(profile_dir=...)`` traces ``profile_num_steps`` steps from
    ``profile_start_step`` into ``trace.json`` (JAX ``trainer.py:869-893``),
    the segment-sum op inside them."""
    from tests._torch_port_common import cylinder_param, port_trainer, write_cylinder_split

    param = cylinder_param(*write_cylinder_split(tmp_path / "data"), "epd")
    trainer, loader, _ = port_trainer(param, tmp_path, profile_dir=str(tmp_path / "prof"),
                                      profile_start_step=2, profile_num_steps=2)
    trainer.fit(loader, num_epochs=1)
    assert os.listdir(tmp_path / "prof") == ["trace.json"]
    with open(tmp_path / "prof" / "trace.json") as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert sum(n == "graphphysics_torch::csr_segment_sum" for n in names) == 2 * 2  # blocks x steps
