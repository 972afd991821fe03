"""The traced window: `torch.profiler`'s kineto events over the window, and
their reduction to the readings the per-layer metrics take.

  * busy_s: the union of the intervals of every device event (kernels,
    copies, memsets; not the window annotation's own device-side mark)
    inside the window, not the sum of their durations;
  * window_s: the length of the window's own annotation;
  * launches: host calls cudaLaunchKernel, cudaLaunchKernelExC,
    cuLaunchKernel, cuLaunchKernelEx and cudaGraphLaunch;
  * syncs: host calls cudaStreamSynchronize, cudaDeviceSynchronize,
    cudaEventSynchronize and the synchronous copies cudaMemcpy,
    cudaMemcpy2D (a `.item()` or `.cpu()` is a cudaMemcpyAsync and a
    cudaStreamSynchronize, counted once);
  * device_ops: device time by operation name, largest first;
  * idle_gaps: the device's idle time inside the window by the innermost
    host operation of the window's thread at the middle of each gap,
    largest first.

The raw event list is read once (`_ProfilerResult.events()`); the
profiler's own tree of function events is never built, which on a window
of a million launches would take minutes.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

WINDOW = "port_bench.window"
LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaGraphLaunch",
))
SYNC_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpy2D",
))
TOP = 10


class Trace:
    """Context manager: profile what runs inside it; `readings()` after."""

    def __init__(self):
        self.result = None

    def __enter__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (
            ProfilerActivity, ProfilerConfig, ProfilerState, _enable_profiler,
            _prepare_profiler,
        )

        self.acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        self.cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                  _ExperimentalConfig())
        _prepare_profiler(self.cfg, self.acts)
        _enable_profiler(self.cfg, self.acts)
        return self

    @contextlib.contextmanager
    def window(self):
        with torch.autograd.profiler.record_function(WINDOW):
            yield

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler

        self.result = _disable_profiler()
        return False

    def readings(self) -> dict:
        return reduce_events(self.result.events())


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events) -> dict:
    from torch.autograd import DeviceType

    w0 = w1 = None
    tid = None
    dev, host = [], []
    by_op = defaultdict(int)
    launches = syncs = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name == WINDOW:  # the annotation's own mark on the device's timeline
                continue
            s = e.start_ns()
            d = e.duration_ns()
            dev.append((s, s + d))
            by_op[name] += d
            continue
        if name in LAUNCH_CALLS:
            launches += 1
        elif name in SYNC_CALLS:
            syncs += 1
        if name == WINDOW:
            w0, w1, tid = e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()
        host.append(e)
    if w0 is None:
        raise RuntimeError("the trace holds no window annotation")
    busy = [(max(s, w0), min(e, w1)) for s, e in _union(dev) if e > w0 and s < w1]
    busy_ns = sum(e - s for s, e in busy)
    # idle gaps inside the window, named by the innermost host op at their middle
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    ops = sorted(
        ((e.start_ns(), -e.duration_ns(), e.name()) for e in host
         if e.start_thread_id() == tid and e.name() != WINDOW),
    )
    idle = defaultdict(int)
    stack, j = [], 0
    for g0, g1 in gaps:  # gaps are in time order
        mid = (g0 + g1) // 2
        while j < len(ops) and ops[j][0] <= mid:
            s, negd, name = ops[j]
            while stack and stack[-1][0] < s:
                stack.pop()
            stack.append((s - negd, name))
            j += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        idle[stack[-1][1] if stack else "(no host op)"] += g1 - g0
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, launches=launches, syncs=syncs,
        device_events=len(dev),
        device_ops=[[n[:120], ns / 1e9] for n, ns in top_ops],
        idle_gaps=[[n[:120], ns / 1e9] for n, ns in top_idle],
    )
