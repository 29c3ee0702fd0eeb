"""The readers of the port's own spans and counters
(``benchlib.program`` and the four metrics that use it), on synthetic
Kineto-like events and on a traced smoke run on the CPU."""
import json
import time

import pytest

import smoke
from benchlib import harness, program, tracing
from benchlib.harness import Reading

NEW = {"attn_bwd_ms.train": ("program_span", "granite-moe-3b.train-4x1024"),
       "moe_dispatch_ms.train": ("program_span",
                                 "granite-moe-3b.train-4x1024"),
       "moe_drop_share.train": ("program_counter",
                                "granite-moe-3b.train-4x1024"),
       "program_idle_share.decode": ("program_span",
                                     "qwen2-7b.decode-24x32k")}
MAIN, AUTOGRAD = 11, 22


class Untyped:
    """One Kineto event of a torch build without ``activity_type``: the
    accessors the reductions call, the kind left to ``activity``'s
    fallback (from the device and the name)."""

    def __init__(self, kind, name, start, end, tid=MAIN, corr=0, link=0,
                 device=False):
        self.kind, self._name, self.s, self.e = kind, name, start, end
        self.tid, self.corr, self.link, self.device = tid, corr, link, device

    def name(self):
        return self._name

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.device else DeviceType.CPU

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def duration_ns(self):
        return self.e - self.s

    def start_thread_id(self):
        return self.tid

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link


class Ev(Untyped):
    """The same event where the build names its kind."""

    def activity_type(self):
        return self.kind


def span(name, s, e, tid=MAIN, cls=Ev, **kw):
    return cls("user_annotation", name, s, e, tid, **kw)


def op(name, s, e, corr, tid=MAIN, cls=Ev, **kw):
    return cls("cpu_op", name, s, e, tid, corr=corr, **kw)


def kernel(name, s, e, link, cls=Ev, **kw):
    return cls("kernel", name, s, e, corr=1000 + link, link=link,
               device=True, **kw)


def test_a_span_on_autograds_thread_gets_its_kernels():
    events = [
        span("train.step", 0, 1000),
        op("aten::mm", 10, 20, corr=1),
        span("moe.dispatch.backward", 300, 400, tid=AUTOGRAD),
        op("aten::_index_put_impl_", 310, 320, corr=2, tid=AUTOGRAD),
        op("aten::mm", 500, 510, corr=3, tid=AUTOGRAD),
        kernel("gemm", 30, 80, link=1),
        kernel("indexing_backward_kernel", 330, 390, link=2),
        kernel("gemm_bwd", 520, 600, link=3),
    ]
    prog = program.reduce(events, ("train.step", "moe.dispatch.backward"))
    assert prog.device_in({"moe.dispatch.backward"}) == pytest.approx(60e-9)
    # the main thread's step does not take autograd's kernels
    assert prog.device_in({"train.step"}) == pytest.approx(50e-9)
    assert prog.device_s[()] == pytest.approx(80e-9)


def test_an_idle_gap_is_split_by_the_hosts_span_over_it():
    events = [
        span("serve.decode_step", 5, 25),
        span("layer.mixer", 12, 20),
        op("aten::mm", 1, 2, corr=1),
        op("aten::argmax", 29, 30, corr=2),
        op("aten::mm", 41, 42, corr=3, tid=AUTOGRAD),
        kernel("a", 0, 10, link=1),
        kernel("b", 30, 40, link=2),
        kernel("c", 35, 45, link=3),     # overlaps b: no gap
        kernel("d", 50, 55, link=3),     # launched from a thread in no span
    ]
    prog = program.reduce(events, ("serve.decode_step", "layer.mixer"))
    assert prog.gaps == 2
    assert prog.idle_total_s == pytest.approx(25e-9)
    by = prog.idle_by_span()
    assert by == pytest.approx({"layer.mixer": 8e-9,
                                "serve.decode_step": 7e-9,
                                program.CALLER: 10e-9})
    assert sum(by.values()) == pytest.approx(prog.idle_total_s)
    assert prog.idle_within("serve.decode_step") == pytest.approx(15e-9)
    assert "layer.mixer 0.000000 s" in prog.line()
    # the harness's own reduction finds the same gaps
    trace = tracing.reduce_events(events, 1.0, set())
    assert sum(s for _, s in trace.idle_gaps) == pytest.approx(25e-9)


@pytest.mark.parametrize("cls", [Ev, Untyped])
def test_gpu_annotations_count_as_no_busy_time(cls):
    events = [
        span("moe.combine", 0, 100, cls=cls),
        span("repro_torch.models.moe:route", 0, 100, cls=cls),
        op("aten::mul", 10, 20, corr=1, cls=cls),
        kernel("mul", 30, 40, link=1, cls=cls),
        kernel("mul", 60, 70, link=1, cls=cls),
        cls("gpu_user_annotation", "moe.combine", 30, 70, device=True),
        cls("gpu_user_annotation", "repro_torch.models.moe:route", 30, 70,
            device=True),
    ]
    prog = program.reduce(events, ("moe.combine",),
                          ("repro_torch.models.moe:route",))
    assert prog.device_in({"moe.combine"}) == pytest.approx(20e-9)
    assert prog.gaps == 1 and prog.idle_total_s == pytest.approx(20e-9)


def _reading(spans, units=2):
    return Reading(window_s=1.0, least_s=None, host_call_s=[], trace_s=1.0,
                   busy_s=0.0, units=units, trace_least_s=None, spans=spans,
                   peaks=None)


class _Prof:
    """What the hook keeps: a profiler whose events are given."""

    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "K", (), {"events": staticmethod(lambda: events)})})


def test_the_readers_against_a_port_with_and_without_spans(bench,
                                                           monkeypatch):
    events = [
        span("serve.decode_step", 0, 50), span("attn.flash_bwd", 100, 200),
        span("moe.combine.backward", 300, 400),
        op("a", 10, 11, corr=1), op("b", 110, 111, corr=2),
        op("c", 310, 311, corr=3), op("d", 60, 61, corr=4),
        kernel("k", 20, 30, link=1), kernel("k", 120, 160, link=2),
        kernel("k", 320, 340, link=3), kernel("k", 70, 80, link=4),
    ]
    r = _reading({program.HOOK: tracing.Span(1, [_Prof(events)])})
    readers = {m: bench.metric_reader(m) for m in NEW}

    def read_all():
        program._last[:] = [None, None]
        return {m: rd.read(r) for m, rd in readers.items()}

    monkeypatch.setattr(program, "counters", lambda: {
        "moe.pairs_routed": 400, "moe.pairs_dropped": 30})
    got = read_all()
    assert got["attn_bwd_ms.train"] == pytest.approx(1e3 * 40e-9 / 2)
    assert got["moe_dispatch_ms.train"] == pytest.approx(1e3 * 20e-9 / 2)
    assert got["moe_drop_share.train"] == pytest.approx(7.5)
    # gaps: 30-70 (the thread in serve.decode_step 30-50), 80-120, 160-320
    assert got["program_idle_share.decode"] == pytest.approx(
        100 * 20 / (40 + 40 + 160))
    # a port without the spans and counters (an older one)
    monkeypatch.undo()
    monkeypatch.setattr(program, "port_names", lambda: ())
    monkeypatch.setattr(program, "_moe", lambda: None)
    assert program.counters() is None
    assert read_all() == {m: None for m in NEW}
    # a reading without the hook's profiler
    monkeypatch.undo()
    r = _reading({})
    assert all(v is None for m, v in read_all().items()
               if m != "moe_drop_share.train")


def test_the_spec_has_the_new_entries(bench):
    doc = json.loads((smoke.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in doc["per_layer"]}
    for name, (source, cell) in NEW.items():
        m = per_layer[name]
        assert m["source"] == source and m["workloads"] == [cell]
        assert name in bench.cell(cell).per_layer
        assert bench.metric_reader(name).SPANS == program.SPANS
    assert list(per_layer)[-4:] == list(NEW)


def test_a_traced_smoke_run_reads_the_ports_counters(bench, capsys):
    """On the CPU the port's ranges hold no device activity; the drop
    share is the window's own: the counters reset as it opens."""
    from repro_torch.models import moe
    moe._count_pairs(__import__("torch").zeros(50, dtype=bool))
    run = smoke.smoke_run(bench, "granite-moe-3b.train-4x1024", 2 ** 31 + 5)
    res = harness.run_cell(bench, run, 0.2, True, time.perf_counter())
    assert res["correct"], res["checks"]
    err = capsys.readouterr().err
    assert "idle by span: 0.000000 s in 0 gaps" in err
    share = res["metrics"]["moe_drop_share.train"]["value"]
    assert 0 < share < 100
    counts = moe.pair_counts()
    assert share == pytest.approx(100 * counts["moe.pairs_dropped"] /
                                  counts["moe.pairs_routed"])
    assert counts["moe.pairs_routed"] % (run.traffic["batch"] *
                                         run.traffic["seq"]) == 0
    assert "moe_route_ms.train" not in res["metrics"]      # no device here
