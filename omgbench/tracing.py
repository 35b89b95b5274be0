"""The traced part of a window: ``torch.profiler`` over a contiguous run of
calls, each inside a ``omgbench.call`` span, reduced to what the per-layer
readers and the result's ``breakdown`` take.

The trace is exported as a Chrome trace into ``TMPDIR``, read, and
deleted.  From it:

* the traced window: the first call span's start to the last one's end;
* device busy time: the union of the device's kernel, copy and fill
  intervals inside that window;
* kernels: device kernels that start inside it (copies are not counted);
* device operations by time, under the profiler's names;
* idle gaps (the window less the busy union) summed by what the host was
  doing at each gap's middle: the innermost host op or runtime call there,
  else Python inside a call, else Python between calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile

import torch

CALL_SPAN = "omgbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Summary:
    first: int  # index in the window of the first traced call
    count: int  # traced calls
    window_s: float
    busy_s: float
    kernels: int
    device_ops: list  # [[name, seconds], ...], most time first
    idle_gaps: list  # [[host activity, seconds], ...], most time first


class Tracer:
    """Profiles calls ``skip`` … ``skip + calls − 1`` of a window: call
    :meth:`before` and :meth:`after` around call ``i`` and run the call
    inside :meth:`span`; :meth:`finish` after the window."""

    def __init__(self, device: torch.device, skip: int, calls: int):
        self.cuda = device.type == "cuda"
        self.skip, self.calls = skip, calls
        self.prof = None
        self.active = False
        self.first, self.count = None, 0

    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self, fn) -> None:
        """Run ``fn`` under a profiler whose trace is dropped: the first
        start of the device tracer in a process takes seconds, which
        belongs to set-up, not to the window."""
        with self._profile():
            fn()

    @property
    def done(self) -> bool:
        return self.calls <= 0 or (self.prof is not None and not self.active)

    def before(self, i: int) -> None:
        if self.prof is None and i >= self.skip and self.calls > 0:
            self.prof = self._profile()
            self.prof.__enter__()
            self.active, self.first = True, i

    def span(self):
        if self.active:
            return torch.profiler.record_function(CALL_SPAN)
        return contextlib.nullcontext()

    def after(self, i: int) -> None:
        if self.active:
            self.count += 1
            if self.count >= self.calls:
                self._stop()

    def _stop(self) -> None:
        self.prof.__exit__(None, None, None)
        self.active = False

    def finish(self) -> Summary | None:
        if self.prof is None:
            return None
        if self.active:
            self._stop()
        fd, path = tempfile.mkstemp(prefix="omgbench_trace_", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return summarize(events, self.first, self.count)


def _intervals(events, cats):
    out = []
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in cats:
            t0 = float(e["ts"]) * 1e-6
            out.append((t0, t0 + float(e.get("dur", 0.0)) * 1e-6,
                        str(e.get("name", ""))[:NAME_CHARS], str(e["cat"]).lower()))
    return out


def union(intervals, w0, w1):
    """Merged ``(start, end)`` pieces of ``intervals`` clipped to
    ``[w0, w1]``, in order."""
    merged = []
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e, *_ in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def gaps(busy, w0, w1):
    """The pieces of ``[w0, w1]`` that ``busy`` (merged, in order) leaves."""
    out, t = [], w0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def label_gaps(idle, host):
    """Seconds of ``idle`` by the innermost ``host`` event (``(start, end,
    name, cat)``) that holds each gap's middle."""
    host = sorted(host, key=lambda h: (h[0], -(h[1] - h[0])))
    out, stack, k = {}, [], 0
    for g0, g1 in idle:
        t = 0.5 * (g0 + g1)
        while k < len(host) and host[k][0] <= t:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if not stack:
            label = "host: Python between calls"
        elif stack[-1][2] == CALL_SPAN:
            label = "host: Python inside a call"
        else:
            label = f"host: {stack[-1][2]}"
        out[label] = out.get(label, 0.0) + (g1 - g0)
    return out


def top(sums: dict):
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(events, first: int, count: int) -> Summary | None:
    calls = [h for h in _intervals(events, ("user_annotation",)) if h[2] == CALL_SPAN]
    if not calls:
        return None
    w0 = min(h[0] for h in calls)
    w1 = max(h[1] for h in calls)
    dev = [d for d in _intervals(events, DEVICE_CATS) if d[1] > w0 and d[0] < w1]
    busy = union(dev, w0, w1)
    by_op = {}
    for s, e, name, _ in dev:
        by_op[name] = by_op.get(name, 0.0) + (min(e, w1) - max(s, w0))
    host = [h for h in _intervals(events, HOST_CATS) if h[1] > w0 and h[0] < w1]
    return Summary(
        first=first,
        count=count,
        window_s=w1 - w0,
        busy_s=sum(e - s for s, e in busy),
        kernels=sum(1 for s, _, _, cat in dev if cat == "kernel" and s >= w0),
        device_ops=top(by_op),
        idle_gaps=top(label_gaps(gaps(busy, w0, w1), host)),
    )
