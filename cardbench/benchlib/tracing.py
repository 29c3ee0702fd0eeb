"""The traced run: spans around the port's entries, the profiler over the
window, and the reduction of its events to what the metric readers read.

A metric file names the spans it reads in ``SPANS``: {target: work},
``target`` a ``"module:attribute"`` of the port (``AdamW.update`` for a
method) and ``work`` None or a function of the call's arguments giving
its (FLOPs, bytes).  While the window is traced each target is wrapped in
a ``torch.profiler.record_function`` range named by the target, and the
wrapper adds up its calls and work.  A span's device time is the sum of
the device activities whose launching operator started inside one of
its ranges on the same thread (kernels that autograd launches from its
own thread in the backward pass are not in any span).
"""
from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Span:
    calls: int = 0
    works: list = field(default_factory=list)   # (FLOPs, bytes) a call
    device_s: float = 0.0


class Spans:
    """Wraps each target in a record_function range while open."""

    def __init__(self, targets: dict):
        self.targets = dict(targets)
        self.spans = {t: Span() for t in self.targets}
        self._saved = []

    def __enter__(self):
        for target, work in self.targets.items():
            mod, _, attr = target.partition(":")
            owner = importlib.import_module(mod)
            *path, name = attr.split(".")
            for p in path:
                owner = getattr(owner, p)
            fn = owner.__dict__[name] if isinstance(owner, type) else \
                getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(target, fn, work))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()

    def _wrap(self, target, fn, work):
        span = self.spans[target]

        def wrapped(*args, **kwargs):
            span.calls += 1
            if work is not None:
                span.works.append(work(*args, **kwargs))
            with torch.profiler.record_function(target):
                return fn(*args, **kwargs)

        return wrapped


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    spans: dict = field(default_factory=dict)     # target -> Span
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    linked: tuple = (0, 0)          # device activities with an operator


def traced(fn, targets: dict, device: str) -> tuple:
    """Run ``fn()`` under the profiler with ``targets`` spanned; returns
    (fn's result, Trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with Spans(targets) as sp:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            if device == "cuda":
                torch.cuda.synchronize()
            window = time.perf_counter() - t0
    trace = reduce_events(prof.profiler.kineto_results.events(), window,
                          set(targets))
    for t, s in sp.spans.items():
        s.device_s = trace.spans.get(t, Span()).device_s
    trace.spans = sp.spans
    return out, trace


def _union_s(intervals) -> tuple[float, list]:
    """Length in seconds of the union of [start, end) ns intervals, and
    the gaps between its parts as (gap ns, index of the interval after
    the gap)."""
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    busy, gaps, end = 0, [], None
    for i in order:
        s, e = intervals[i]
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, i))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9, gaps


def activity(e, span_names=()) -> str:
    """A Kineto event's kind, as ``activity_type()`` names it where the
    torch build has that method, else from its device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    from torch.autograd import DeviceType
    note = getattr(e, "is_user_annotation", None)
    note = note() if note is not None else e.name() in span_names
    name = e.name()
    if e.device_type() == DeviceType.CPU:
        if note:
            return "user_annotation"
        return "cuda_runtime" if name.startswith("cu") else "cpu_op"
    if note or name in span_names:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def reduce_events(events, window_s: float, span_names: set) -> Trace:
    """Kineto events -> Trace.  Device activities (kernels, copies, sets)
    give the busy time (their union), the time by name, and each span's
    device time; idle gaps between them are named by the operator that
    launched the activity that ends the gap."""
    ops = {}            # operator correlation -> (start ns, thread, name)
    launches = {}       # runtime call correlation -> (start ns, thread, name)
    ranges = defaultdict(list)                 # (span, tid) -> [(start, end)]
    device = []         # (start, end, name, operator or launch)
    for e in events:
        kind = activity(e, span_names)
        if kind in ("cpu_op", "user_annotation"):
            ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id(),
                                       e.name())
            if e.name() in span_names:
                ranges[(e.name(), e.start_thread_id())].append(
                    (e.start_ns(), e.end_ns()))
        elif kind == "cuda_runtime":
            launches[e.correlation_id()] = (e.start_ns(),
                                            e.start_thread_id(), e.name())
        elif kind in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.name(), (e.linked_correlation_id(),
                                      e.correlation_id())))
    device = [(s, e, name, (ops.get(link) if link else None) or
               launches.get(corr))
              for s, e, name, (link, corr) in device]
    trace = Trace(window_s)
    if not device:
        return trace
    trace.busy_s, gaps = _union_s([(s, e) for s, e, _, _ in device])
    by_name = defaultdict(float)
    for s, e, name, _ in device:
        by_name[name] += (e - s) / 1e9
    trace.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = defaultdict(float)
    for gap, i in gaps:
        op = device[i][3]
        idle[op[2] if op else "(no operator)"] += gap / 1e9
    trace.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    starts = {k: ([s for s, _ in sorted(v)], sorted(v))
              for k, v in ranges.items()}
    linked = 0
    for s, e, _, op in device:
        if op is None:
            continue
        linked += 1
        for name in span_names:
            key = (name, op[1])
            if key not in starts:
                continue
            firsts, spans = starts[key]
            j = bisect.bisect_right(firsts, op[0]) - 1
            if j >= 0 and spans[j][0] <= op[0] <= spans[j][1]:
                trace.spans.setdefault(name, Span()).device_s += \
                    (e - s) / 1e9
    trace.linked = (linked, len(device))
    return trace
