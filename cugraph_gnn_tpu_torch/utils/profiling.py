"""Profiling helpers on ``torch.profiler``.

Counterpart of ``cugraph_gnn_tpu/utils/profiling.py``:

* :func:`trace` records the enclosed block with ``torch.profiler`` (CPU
  activity, and CUDA activity when a card is present: the kernels by name,
  the hand-written ones launched through ``ctypes`` too) and writes a
  Chrome trace JSON into ``log_dir``, which Perfetto and ``chrome://tracing``
  open.
* :func:`annotate` names a region on that timeline
  (``torch.profiler.record_function``) and, on the card, as an NVTX range.
* :class:`PerformanceMeter` is the reference's warm-up and timed-window
  meter: ``run`` folds a device scalar through every iteration and reads it
  back once a window, so the host waits for the device, and takes the
  per-iteration time as the difference of a large and a small window,
  which cancels the readback's fixed cost.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from cugraph_gnn_tpu_torch._device import resolve_device


@dataclass
class Trace:
    """What :func:`trace` yields: the running profiler, and after the block
    the path of the trace JSON it wrote."""

    profiler: torch.profiler.profile
    path: Optional[str] = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed block and write ``log_dir/trace_<pid>_<ns>.json``:

        with profiling.trace("/tmp/torch-trace") as t:
            step(...)
        print(t.path)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        handle = Trace(prof)
        yield handle
    handle.path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(handle.path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region on the profiler timeline, and an NVTX range on the card:

        with profiling.annotate("feature-gather"):
            x = store.get_tensor("", "x", ids=ids)
    """
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


@dataclass
class PerformanceMeter:
    """Warm-up + timed-window meter with a dependent readback, on ``device``
    (default: the card).

        meter = PerformanceMeter(warmup=3, iters=50)
        ms = meter.run(lambda acc: acc + step(...))   # step returns a scalar
    """

    warmup: int = 3
    iters: int = 50
    metrics: Dict[str, float] = field(default_factory=dict)
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def run(self, step: Callable, *, name: Optional[str] = None,
            bytes_per_iter: Optional[float] = None,
            items_per_iter: Optional[float] = None) -> float:
        """``step(acc) -> acc`` must fold a scalar tensor on the meter's
        device through the iteration (its value depends on the whole
        computation).  Returns ms/iter; records ``name`` (and GB/s and
        items/s when sizes are given) in :attr:`metrics`."""

        def window(n):
            acc = torch.zeros((), dtype=torch.float32, device=self.device)
            for _ in range(n):
                acc = step(acc)
            return float(acc)  # dependent readback: waits for the device

        for _ in range(self.warmup):
            window(1)
        t0 = time.perf_counter()
        window(1)
        t_small = time.perf_counter() - t0
        t0 = time.perf_counter()
        window(self.iters + 1)
        dt = max(time.perf_counter() - t0 - t_small, 1e-9)
        ms = 1e3 * dt / self.iters
        if name is not None:
            self.metrics[name] = ms
            if bytes_per_iter:
                self.metrics[f"{name}_gbps"] = bytes_per_iter / (ms * 1e-3) / 1e9
            if items_per_iter:
                self.metrics[f"{name}_items_per_s"] = items_per_iter / (ms * 1e-3)
        return ms

    def report(self) -> List[str]:
        return [f"{k}: {v:,.3f}" for k, v in self.metrics.items()]
