"""Timing and tracing (port of ``occlusionfusion_tpu/utils/profiling.py``).

``PhaseTimer`` accumulates wall time per named phase; a span given
tensors to wait on synchronises their CUDA devices before it closes (the
JAX package blocks on its arrays there), so device work is counted in
the phase that queued it. ``device_trace`` records a ``torch.profiler``
trace of the CPU and the card into a directory (a Chrome trace file).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any

import torch


def _cuda_devices(tree: Any, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, found)
    return found


class PhaseTimer:
    """Accumulating per-phase wall timer with device synchronisation."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync: Any = None):
        """Time a phase; pass a tensor (or a nest of them) as ``sync``, or
        set ``box["sync"]`` on the yielded dict, to wait for their devices
        before the span closes."""
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            for dev in _cuda_devices(box.get("sync", sync), set()):
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        rows = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            n = self.counts[name]
            rows.append(
                f"{name:30s} total {total * 1e3:9.1f} ms  "
                f"mean {total / n * 1e3:8.2f} ms  n={n}"
            )
        return "\n".join(rows)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record a torch.profiler trace of the block (the CPU, and the card
    where there is one) into ``log_dir/trace.json`` (Chrome trace format);
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
