"""Profiling and timing (counterpart of ``graphphysics_tpu/utils/profiling.py``):
a ``torch.profiler`` trace written as a Chrome trace, a throughput meter,
a synchronize over the tensors of a nested structure, a timer of chained
steps, and the card's GEMM and memory probes.

Device times come from CUDA events or the profiler's CUDA activity; on
the CPU the timers read the host clock after the work, which is all a CPU
run has. The probes run where they are told (``cuda`` unless named) and
report what they measured there: a CPU run's numbers are the CPU's.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, List, Tuple

import torch

from graphphysics_torch.core.device import DeviceLike, resolve_device


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(device: DeviceLike = None) -> torch.profiler.profile:
    """A started ``torch.profiler.profile`` of the host and, on ``cuda``
    (the default), of the card's kernels."""
    prof = torch.profiler.profile(activities=_activities(resolve_device(device)))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str, device: DeviceLike = None,
               name: str = "trace.json") -> str:
    """Wait for the device, stop ``prof`` and write its Chrome trace to
    ``log_dir/name``; returns the path."""
    if resolve_device(device).type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, device: DeviceLike = None, name: str = "trace.json"):
    """``torch.profiler`` over the block, its Chrome trace (view it in
    Perfetto or ``chrome://tracing``) written to ``log_dir/name``; yields
    the profiler (``key_averages()`` for sums by kernel)."""
    prof = start_trace(device)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir, device, name)


class ThroughputMeter:
    """Edges per second (and steps per second) over a sliding window of
    steps; ``tick()`` after each step, on the host clock."""

    def __init__(self, edges_per_step: int, window: int = 50):
        self.edges_per_step = edges_per_step
        self.window = window
        self._times: List[float] = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window + 1:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(dt, 1e-9)

    @property
    def edges_per_sec(self) -> float:
        return self.steps_per_sec * self.edges_per_step


def _tensors(obj: Any) -> List[torch.Tensor]:
    """Every tensor of a nested structure of dicts, lists, tuples and
    objects with tensor attributes (a ``Graph``, an ``nn.Module``'s
    ``state_dict``)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if hasattr(obj, "__dataclass_fields__"):
        return [t for f in obj.__dataclass_fields__ for t in _tensors(getattr(obj, f))]
    return []


def fetch_sync(*objs: Any) -> None:
    """Wait until the work that produced the tensors of ``objs`` (nested
    structures; None, empty tensors and tensors on the CPU are fine) is done:
    one ``torch.cuda.synchronize`` per CUDA device among them."""
    devices = {t.device for o in objs for t in _tensors(o) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def time_chained_steps(step_fn: Callable, state: Any, batch: Any, iters: int = 30,
                       warmup: int = 3) -> Tuple[float, Any]:
    """Seconds per step over ``iters`` dependent steps, ``state, loss =
    step_fn(state, batch)``, the state flowing from one to the next, after
    ``warmup`` steps. On CUDA the time is read by CUDA events around the
    chain, after a synchronize; on the CPU by the host clock. Returns
    ``(seconds_per_step, state)``."""
    loss = None
    for _ in range(warmup):
        state, loss = step_fn(state, batch)
    fetch_sync(loss, state)
    cuda = any(t.is_cuda for t in _tensors((state, batch)))
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        state, loss = step_fn(state, batch)
    if cuda:
        end.record()
        fetch_sync(loss, state)
        return start.elapsed_time(end) / 1e3 / iters, state
    fetch_sync(loss, state)
    return (time.perf_counter() - t0) / iters, state


def _best_seconds(fn: Callable[[], Any], reps: int, device: torch.device) -> float:
    """The fastest of ``reps`` timed calls of ``fn`` after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def chip_probe_tflops(n: int = 4096, depth: int = 4, reps: int = 3,
                      dtype: torch.dtype = torch.bfloat16, device: DeviceLike = None) -> float:
    """The device's matrix-product rate right now, TFLOP/s: a chain of
    ``depth`` dependent ``n x n`` products in ``dtype``, the best of
    ``reps``. TF32 stays as the caller set it (``chip_smoke.py`` and the
    doctor leave it off, so a float32 chain runs in full float32)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((n, n), generator=gen, device=dev) / n ** 0.5).to(dtype)

    def chain():
        y = x
        for _ in range(depth):
            y = y @ x
        return y

    return 2 * n ** 3 * depth / _best_seconds(chain, reps, dev) / 1e12


def chip_probe_gbps(mb: int = 1024, depth: int = 4, reps: int = 3,
                    device: DeviceLike = None) -> float:
    """The device memory's copy rate right now, GB/s: ``depth`` copies of
    an ``mb`` MiB float32 buffer (each reads and writes it once), the best
    of ``reps``. Past the 50 MB L2 cache by default."""
    dev = resolve_device(device)
    src = torch.ones(mb * 2 ** 20 // 4, device=dev)
    dst = torch.empty_like(src)

    def chain():
        for _ in range(depth):
            dst.copy_(src)

    return 2 * src.numel() * 4 * depth / _best_seconds(chain, reps, dev) / 1e9
