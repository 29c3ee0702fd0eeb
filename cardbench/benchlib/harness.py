"""One run of a cell: set-up, the window, the traced reading, the check.

``run_cell`` is the whole of a run after the look for a card, so that a
test can drive it on the CPU at a small size (``arch`` and overrides of
the configuration and the traffic), with a fault planted in the timed
path (``fault``), and see what ``correct`` comes out as.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass

import torch

from benchlib import port, tracing, work
from benchlib.loops import loop_for
from benchlib.spec import Benchmark, Cell

# a fault planted in the timed path, for the tests and the fault readings
FAULTS = ("unchanged", "half_batch", "altered")
# the traced window's length at most, in seconds: it bounds the
# profiler's events and the time to reduce them
TRACE_S = 10


@dataclass
class Run:
    cell: Cell
    config: dict
    traffic: dict
    arch: object            # the port's ArchConfig
    seed: int
    device: str
    reference: object       # reference/<config>.py
    fault: str | None = None

    @contextlib.contextmanager
    def faults(self):
        """A train step that returns its state unchanged: the optimizer's
        update does nothing while this is open under that fault."""
        if self.fault != "unchanged" or self.traffic["kind"] != "train":
            yield
            return
        from repro_torch.optim.adamw import AdamW
        update = AdamW.update
        AdamW.update = lambda self, grads, opt_state, params, norm=None: (
            params, opt_state)
        try:
            yield
        finally:
            AdamW.update = update


@dataclass
class Reading:
    """What a per-layer metric reader reads (``metrics/<name>.py``).  A
    traced run runs the window twice: first untraced, for what the host
    clock reads (the profiler's cost would distort it), then traced for
    ``TRACE_S`` seconds at most."""
    window_s: float         # the untraced window, host clock
    least_s: float | None   # its work at the card's peaks
    host_call_s: list       # its steps' host time from call to return
    trace_s: float          # the traced window, host clock
    busy_s: float           # device busy in it (union of activities)
    units: int              # steps or requests done in it
    trace_least_s: float | None     # their work at the card's peaks
    spans: dict             # target -> tracing.Span, in it
    peaks: dict | None      # the card's (work.PEAKS), None if unknown


def make_run(bench: Benchmark, name: str, seed: int, device: str, *,
             arch=None, config=None, traffic=None, fault=None) -> Run:
    cell = bench.cell(name)
    config = {**cell.config, **(config or {})}
    traffic = {**cell.traffic, **(traffic or {})}
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")
    return Run(cell, config, traffic, port.arch_config(config, arch), seed,
               device, bench.reference(cell.config["name"]), fault)


def run_cell(bench: Benchmark, run: Run, seconds: float, trace: bool,
             t_start: float, log=print) -> dict:
    """The result of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, maybe ``breakdown``, and ``checks`` last)."""
    from reference.plain import Float32
    cuda = run.device == "cuda"
    loop = loop_for(run.traffic["kind"])(run)
    t0 = time.perf_counter()
    loop.setup()
    if cuda:
        torch.cuda.synchronize()
    # what set-up made stays alive: keep it out of the collector's full
    # passes, which would otherwise pause the window's host path
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"setup: {t0 - t_start:.2f} s before the cell's own, "
        f"{setup_s - (t0 - t_start):.2f} s in it", file=sys.stderr)
    before = port.launches(loop.per_unit)
    readers = {m: bench.metric_reader(m) for m in run.cell.per_layer} \
        if trace else {}
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    pk = work.peaks(kind)
    loop.window(seconds)
    if trace:
        host = (loop.window_s, loop.least_s(pk) if pk else None,
                list(getattr(loop, "host_s", [])), loop.units)
        targets = {}
        for r in readers.values():
            targets.update(getattr(r, "SPANS", {}))
        _, tr = tracing.traced(lambda: loop.window(min(seconds, TRACE_S)),
                               targets, run.device)
    gc.unfreeze()
    counts = {k: v - before[k]
              for k, v in port.launches(loop.per_unit).items()}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": 1,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                    if cuda else 0)}
    result = {"attempted": loop.attempted, "failed": loop.failed}
    if trace:
        reading = Reading(*host[:3], tr.window_s, tr.busy_s,
                          loop.units - host[3],
                          loop.least_s(pk) - host[1] if pk else None,
                          tr.spans, pk)
        metrics = {}
        for m, r in readers.items():
            value = r.read(reading)
            if value is not None:
                metrics[m] = {"value": value, "unit": bench.units[m]}
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
        log(f"trace: {tr.linked[0]} of {tr.linked[1]} device activities "
            f"linked to an operator; spans " + ", ".join(
                f"{t}: {s.calls} calls, {s.device_s:.6f} s"
                for t, s in tr.spans.items()), file=sys.stderr)
    else:
        e2e = loop.e2e()
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in run.cell.end_to_end:
            if m != "setup_s":
                metrics[m] = {"value": e2e[m], "unit": bench.units[m]}
    result.update(metrics=metrics, device=device)

    # the check: the program's outputs against the plain reference
    per_unit = {k: v / max(loop.units, 1) for k, v in counts.items()}
    log(f"launches per {loop.unit}: " + ", ".join(
        f"{k} {v:g} (expected {loop.per_unit[k] if cuda else 0})"
        for k, v in per_unit.items()), file=sys.stderr)
    prog = loop.kept()
    loop.release()
    t0 = time.perf_counter()
    numbers = loop.compare(prog, loop.reference(Float32, prog))
    for k, v in per_unit.items():
        numbers[f"{k}_launch_gap"] = abs(v - (loop.per_unit[k] if cuda
                                             else 0))
    log(f"reference: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    checks = {k: {"value": v, "limit": run.cell.limits.get(k)}
              for k, v in numbers.items()}
    correct = loop.failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return {"correct": correct, **result, "checks": checks}
