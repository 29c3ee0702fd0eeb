"""Chrome trace-event export for the flight recorder + telemetry state.

Builds the JSON object format of the Trace Event spec (the one Perfetto
and ``chrome://tracing`` load): ``{"traceEvents": [...]}`` where each
event carries a phase ``ph`` — ``M`` metadata, ``i`` instants (flight-
recorder entries), ``C`` counters (telemetry series samples), ``X``
complete spans with durations (lineage stage transitions).  Timestamps
are sim-time seconds scaled to microseconds, so the timeline you open
is the *simulated* timeline, not wall clock.

Run a demo and export a trace::

    PYTHONPATH=src python -m repro_torch.obs.trace run.json

Validate an existing file against the schema subset we emit::

    PYTHONPATH=src python -m repro_torch.obs.trace --validate run.json

The export is a pure function of telemetry state, so for a fixed
(spec, seed) the JSON is byte-identical across processes — trace files
are fingerprintable artifacts like everything else.
"""
from __future__ import annotations

import argparse
import json
import sys

_PID = 1
_TID_FLIGHT = 1
_TID_LINEAGE0 = 100          # one virtual thread per traced record

_PHASES = {"M", "i", "I", "C", "X", "B", "E"}


def _us(t: float) -> float:
    return t * 1e6


def chrome_trace(engine) -> dict:
    """Build the Chrome trace-event object for an engine run.

    Requires telemetry enabled on the engine (``spec.set_telemetry``);
    raises ``RuntimeError`` otherwise.
    """
    tel = getattr(engine, "telemetry", None)
    if tel is None:
        raise RuntimeError(
            "telemetry disabled: call spec.set_telemetry(...) before "
            "building the engine to record a trace")
    ev: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
         "args": {"name": "stream2gym-sim"}},
        {"ph": "M", "name": "thread_name", "pid": _PID,
         "tid": _TID_FLIGHT, "args": {"name": "flight-recorder"}},
    ]
    # flight-recorder entries -> instant events
    for t, kind, args in tel.recorder.entries():
        ev.append({"ph": "i", "name": kind, "cat": "flight", "s": "t",
                   "pid": _PID, "tid": _TID_FLIGHT, "ts": _us(t),
                   "args": dict(args)})
    # telemetry series -> counter tracks; sample j (0-based over the
    # whole run) was taken at t = (j + 1) * interval_s
    interval = tel.cfg.interval_s
    for name in sorted(tel._series):
        s = tel._series[name]
        ring = s.ring()
        first = s.n - len(ring)
        for i, v in enumerate(ring):
            ev.append({"ph": "C", "name": name, "cat": "telemetry",
                       "pid": _PID, "tid": 0,
                       "ts": _us((first + i + 1) * interval),
                       "args": {"value": float(v)}})
    # lineage traces -> one virtual thread of X spans per record
    for k, tr in enumerate(tel.lineage_traces()):
        tid = _TID_LINEAGE0 + k
        ev.append({"ph": "M", "name": "thread_name", "pid": _PID,
                   "tid": tid,
                   "args": {"name": f"{tr['topic']} msg {tr['msg_id']}"}})
        stages = tr["stages"]
        for (stage, t0), (_nxt, t1) in zip(stages, stages[1:]):
            ev.append({"ph": "X", "name": stage, "cat": "lineage",
                       "pid": _PID, "tid": tid, "ts": _us(t0),
                       "dur": _us(t1 - t0),
                       "args": {"msg_id": tr["msg_id"],
                                "topic": tr["topic"]}})
        if stages:
            stage, t_last = stages[-1]
            ev.append({"ph": "i", "name": stage, "cat": "lineage",
                       "s": "t", "pid": _PID, "tid": tid,
                       "ts": _us(t_last),
                       "args": {"msg_id": tr["msg_id"]}})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_trace(engine, path: str) -> dict:
    """Export ``chrome_trace(engine)`` to ``path``; returns the object."""
    obj = chrome_trace(engine)
    with open(path, "w") as f:
        json.dump(obj, f, indent=None, separators=(",", ":"))
    return obj


def validate_chrome_trace(obj) -> list[str]:
    """Check an object against the trace-event schema subset we emit.

    Returns a list of problems (empty == valid).  Used by the obs-smoke
    CI gate and the ``--validate`` CLI mode.
    """
    problems: list[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    if not evs:
        problems.append("traceEvents is empty")
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            problems.append(f"{where}: name missing or not a string")
        if not isinstance(e.get("pid"), int):
            problems.append(f"{where}: pid missing or not an int")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"{where}: ts missing or negative")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event needs dur >= 0")
        if ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                problems.append(f"{where}: C event needs numeric args")
    return problems


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _demo_engine(horizon: float, interval: float, chaos: bool):
    # lazy imports keep repro_torch.obs free of sweep/engine dependencies for
    # library users who only validate traces
    from repro_torch.core.engine import Engine
    from repro_torch.sweep.scenarios import build_scenario

    params = {
        "topology": "geo_wan", "n_hosts": 8, "n_brokers": 3,
        "replication": 3, "n_topics": 2, "n_producers": 2,
        "rate_kbps": 256.0, "msg_size": 512, "consumer_cost": 0.02,
        "queue_bytes": 16 << 10, "chaos": 1 if chaos else 0,
        "horizon": horizon, "seed": 0,
        "telemetry": interval, "lineage_k": 4,
    }
    spec = build_scenario(params)
    eng = Engine(spec, seed=0)
    eng.run(until=horizon)
    return eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description="Export (demo run) or validate Chrome trace JSON.")
    ap.add_argument("path", help="trace file to write (or check with "
                                 "--validate)")
    ap.add_argument("--validate", action="store_true",
                    help="validate an existing trace file instead of "
                         "running the demo scenario")
    ap.add_argument("--horizon", type=float, default=8.0)
    ap.add_argument("--interval", type=float, default=0.5,
                    help="telemetry sampling interval (sim seconds)")
    ap.add_argument("--no-chaos", action="store_true",
                    help="run the demo without the chaos fault plan")
    args = ap.parse_args(argv)

    if args.validate:
        with open(args.path) as f:
            obj = json.load(f)
        problems = validate_chrome_trace(obj)
        for p in problems:
            print(f"INVALID: {p}")
        if not problems:
            print(f"{args.path}: valid "
                  f"({len(obj['traceEvents'])} events)")
        return 1 if problems else 0

    eng = _demo_engine(args.horizon, args.interval, not args.no_chaos)
    obj = write_trace(eng, args.path)
    problems = validate_chrome_trace(obj)
    if problems:
        for p in problems:
            print(f"INVALID: {p}")
        return 1
    print(f"wrote {args.path}: {len(obj['traceEvents'])} events, "
          f"{eng.telemetry.n_samples} samples, "
          f"{eng.telemetry.recorder.n} flight records")
    print("open in https://ui.perfetto.dev  (Open trace file) or "
          "chrome://tracing")
    return 0


if __name__ == "__main__":
    sys.exit(main())
