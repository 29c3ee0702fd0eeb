"""The port's own spans and counters, read from the traced window.

The port opens a ``record_function`` range at each of its layers while a
profiler records (``repro_torch.obs.spans``; ``NAMES`` lists them) and
counts the MoE pairs it routes and drops (``repro_torch.models.moe``).
The harness hands a metric reader the totals of its own spans
(``tracing.Span``), not the profiler's events, so a metric file that
reads the port's spans or counters names ``SPANS = program.SPANS``: one
target, ``torch.profiler.profile.start``, wrapped while the window is
traced as every target is.  Its work function resets the port's
counters as the window opens and keeps the profiler, whose events
``of(reading)`` reduces once the window has closed.  The target's own
range opens before the profiler records, so it is not in the trace.
(Once ``tracing.traced`` hands readers its events, the hook can go.)

The reduction lays the port's ranges over the device activities
(kernels, copies, sets; annotations are none of them, on either path of
``activity``):

- each activity belongs to the stack of port spans that the thread
  which launched it was inside when its launching operator started
  (``device_s``), so kernels that autograd launches from its own thread
  belong to the spans on that thread;
- each gap between activities (between the parts of their union, as
  ``tracing`` finds them) is split by the stack of port spans that the
  thread which launched the activity after the gap was inside over it
  (``idle_s``): every second of idle is put down to what that thread was
  doing, the caller's code where it was inside no span.

Against a port without spans or counters every reader returns None.
"""
from __future__ import annotations

import bisect
import importlib
import itertools
import sys
from collections import defaultdict
from dataclasses import dataclass, field

from benchlib.tracing import DEVICE_ACTIVITIES, activity

HOOK = "torch.profiler:profile.start"
CALLER = "(caller)"
UNLINKED = "(no operator)"


def port_names() -> tuple:
    """The port's span names; empty for a port without spans."""
    try:
        return tuple(importlib.import_module("repro_torch.obs.spans").NAMES)
    except ImportError:
        return ()


def _moe():
    try:
        mod = importlib.import_module("repro_torch.models.moe")
    except ImportError:
        return None
    return mod if hasattr(mod, "pair_counts") else None


def counters() -> dict | None:
    """The port's counters since the window opened; None without them."""
    moe = _moe()
    return None if moe is None else moe.pair_counts()


def _open_window(prof):
    moe = _moe()
    if moe is not None:
        moe.reset_pair_counts()
    return prof


SPANS = {HOOK: _open_window}


@dataclass
class Program:
    """The traced window's device and idle seconds by stack of port
    spans (outermost first; () outside every span)."""
    device_s: dict = field(default_factory=dict)
    idle_s: dict = field(default_factory=dict)
    idle_total_s: float = 0.0
    gaps: int = 0

    def device_in(self, names) -> float:
        """Device seconds of the activities whose innermost span is one
        of ``names``."""
        return sum(s for stack, s in self.device_s.items()
                   if stack and stack[-1] in names)

    def idle_within(self, name: str) -> float:
        """Idle seconds during which the launching thread was inside
        ``name`` (at any depth)."""
        return sum(s for stack, s in self.idle_s.items() if name in stack)

    def idle_by_span(self) -> dict:
        """Idle seconds by the innermost span over them, ``CALLER``
        outside every span."""
        out = defaultdict(float)
        for stack, s in self.idle_s.items():
            out[stack[-1] if stack else CALLER] += s
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def line(self) -> str:
        return (f"idle by span: {self.idle_total_s:.6f} s in {self.gaps} "
                f"gaps; " + ", ".join(f"{k} {v:.6f} s" for k, v in
                                      self.idle_by_span().items()))


class _Timeline:
    """One thread's port ranges as sorted boundaries, with the stack of
    ranges open between each boundary and the next."""

    def __init__(self, ranges):
        marks = sorted([(e, 0, i) for i, (_, e, _) in enumerate(ranges)] +
                       [(s, 1, i) for i, (s, _, _) in enumerate(ranges)])
        open_, self.bounds, self.stacks = {}, [], []
        for t, group in itertools.groupby(marks, key=lambda m: m[0]):
            for _, starts, i in group:
                if starts:
                    open_[i] = ranges[i]
                else:
                    open_.pop(i, None)
            self.bounds.append(t)
            self.stacks.append(tuple(r[2] for r in sorted(
                open_.values(), key=lambda r: (r[0], -r[1]))))

    def at(self, t) -> tuple:
        j = bisect.bisect_right(self.bounds, t) - 1
        return self.stacks[j] if j >= 0 else ()

    def split(self, a, b, out: dict) -> None:
        """Add to ``out`` the seconds of [a, b) under each stack."""
        j = bisect.bisect_right(self.bounds, a) - 1
        while a < b:
            end = self.bounds[j + 1] if j + 1 < len(self.bounds) else b
            end = min(end, b)
            stack = self.stacks[j] if j >= 0 else ()
            out[stack] = out.get(stack, 0.0) + (end - a) / 1e9
            a, j = end, j + 1


def reduce(events, names, notes=()) -> Program:
    """Kineto events -> Program for the port's span ``names``; ``notes``
    names the other ranges of the trace (the harness's targets), which
    ``activity`` needs on a build without ``activity_type``."""
    names = set(names)
    notes = names | set(notes)
    ops = {}            # operator correlation -> (start ns, thread)
    launches = {}       # runtime call correlation -> (start ns, thread)
    ranges = defaultdict(list)      # thread -> [(start, end, name)]
    device = []         # (start, end, (linked correlation, correlation))
    for e in events:
        kind = activity(e, notes)
        if kind in ("cpu_op", "user_annotation"):
            ops[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
            if e.name() in names:
                ranges[e.start_thread_id()].append(
                    (e.start_ns(), e.end_ns(), e.name()))
        elif kind == "cuda_runtime":
            launches[e.correlation_id()] = (e.start_ns(),
                                            e.start_thread_id())
        elif kind in DEVICE_ACTIVITIES:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           (e.linked_correlation_id(), e.correlation_id())))
    prog = Program()
    lines = {tid: _Timeline(rs) for tid, rs in ranges.items()}
    empty = _Timeline([])
    launcher = []       # (start ns, thread) of each activity's operator
    for s, e, (link, corr) in device:
        op = (ops.get(link) if link else None) or launches.get(corr)
        launcher.append(op)
        if op is not None:
            stack = lines.get(op[1], empty).at(op[0])
            prog.device_s[stack] = prog.device_s.get(stack, 0.0) + \
                (e - s) / 1e9
    order = sorted(range(len(device)), key=lambda i: device[i][0])
    end = None
    for i in order:
        s, e, _ = device[i]
        if end is not None and s > end:
            prog.gaps += 1
            prog.idle_total_s += (s - end) / 1e9
            op = launcher[i]
            if op is None:
                prog.idle_s[(UNLINKED,)] = prog.idle_s.get(
                    (UNLINKED,), 0.0) + (s - end) / 1e9
            else:
                lines.get(op[1], empty).split(end, s, prog.idle_s)
        end = e if end is None else max(end, e)
    return prog


_last = [None, None]        # the profiler last reduced, its Program


def of(r) -> Program | None:
    """The port's spans in the reading's traced window (reduced once a
    window, its idle line then written to stderr); None for a port
    without spans or a reading without the hook's profiler."""
    span = r.spans.get(HOOK)
    names = port_names()
    if span is None or not span.works or not names:
        return None
    prof = span.works[-1]
    if _last[0] is not prof:
        _last[:] = [prof, reduce(prof.profiler.kineto_results.events(),
                                 names, r.spans)]
        print(_last[1].line(), file=sys.stderr)
    return _last[1]


def span_ms_per_unit(r, names) -> float | None:
    """Device milliseconds a unit of the activities whose innermost port
    span is one of ``names``; None where there are none."""
    prog = of(r)
    if prog is None or r.units <= 0:
        return None
    s = prog.device_in(set(names))
    return 1e3 * s / r.units if s > 0 else None
