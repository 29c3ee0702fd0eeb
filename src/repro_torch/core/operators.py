"""Composable stream operators: the SPE's dataflow graph layer.

An SPE runtime executes an :class:`OperatorChain` — an ordered list of
:class:`Operator` stages — over :class:`Element` streams.  Elements carry
``(payload, size, event_time, key)``; stateless stages (``Map`` /
``FlatMap`` / ``Filter``) transform them, ``KeyBy`` attaches keys, and the
window stages (``TumblingWindow`` / ``SlidingWindow``) buffer elements
into per-``(key, window_start)`` *panes* that fire when the runtime's
**event-time watermark** passes the window end (plus allowed lateness).
``WindowAggregate`` reduces a fired pane to one result element through a
bucket-padded jitted computation (see :func:`jit_bucket`), and ``Sink``
runs terminal side effects (external stores).

Determinism contract (the sweep fingerprint relies on it):

- Pane firing is driven by :meth:`OperatorChain.advance_watermark` with a
  watermark the *runtime* computes as the min over its owned partitions'
  running-max event times.  Due panes fire in sorted
  ``(window_start, repr(key))`` order, never in dict/set iteration order,
  so firing sequences are identical across processes and across the
  ``poll``/``wakeup`` delivery modes.
- Lateness is classified per *partition* (against the partition's own
  running max, upstream in the runtime), not against the cross-partition
  watermark — the cross-partition interleaving differs between delivery
  modes, the per-partition sequence does not.  A record that arrives
  after its window fired is therefore always late (see the proof sketch
  in ``core/spe.py``), which is what makes window *contents* a pure
  function of the record streams.

State + checkpointing: every stateful operator keeps its mutable state in
``self.state`` (a dict) so :meth:`Operator.snapshot` /
:meth:`Operator.restore` round-trip it through a
:class:`~repro_torch.core.state.StateBackend` snapshot; ``reset`` models the
state loss of a host failure.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.kernels import cohort as cohort_kernels


def shed_keep(sizes: list, space: int, policy: str
              ) -> tuple[str, Any, int]:
    """Load shedding: which rows of an over-budget batch to keep.

    ``sizes`` are the per-row byte sizes, ``space`` the remaining queue
    budget.  Returns ``(kind, sel, kept_bytes)``:

    - ``("slice", (lo, hi), kb)`` for the contiguous policies —
      ``drop_newest`` keeps the longest fitting prefix, ``drop_oldest``
      the longest fitting suffix;
    - ``("indices", [i, ...], kb)`` for ``sample`` — an evenly spread
      selection chosen by a byte-ratio accumulator (keep a row whenever
      doing so keeps kept/total ≤ space/batch), **pure integer
      arithmetic, no RNG**, so shed decisions are bit-identical across
      processes and never perturb any client RNG stream.

    The kept bytes never exceed ``space``; callers account them against
    the queue bound.
    """
    n = len(sizes)
    if policy == "drop_newest":
        k = kb = 0
        for s in sizes:
            if kb + s > space:
                break
            k += 1
            kb += s
        return "slice", (0, k), kb
    if policy == "drop_oldest":
        k = kb = 0
        for s in reversed(sizes):
            if kb + s > space:
                break
            k += 1
            kb += s
        return "slice", (n - k, n), kb
    if policy == "sample":
        nb = sum(sizes)
        keep: list[int] = []
        kb = tot = 0
        for i, s in enumerate(sizes):
            tot += s
            if kb + s <= space and (kb + s) * nb <= space * tot:
                keep.append(i)
                kb += s
        return "indices", keep, kb
    raise ValueError(f"unknown shed policy {policy!r}")


def jit_bucket(n: int, min_bucket: int = 16) -> int:
    """Pad a batch length to its power-of-two bucket.

    Jitted window computations see only bucket sizes, so the number of
    XLA compilations is O(log max_window) instead of one per distinct
    window length (which recompiled nearly every window in long runs).
    Padding must never change real-row outputs — assert that property in
    tests whenever a new computation is bucketed.
    """
    if n <= min_bucket:
        return min_bucket
    return 1 << (n - 1).bit_length()


@dataclass
class Element:
    """One in-flight stream element between operators.

    ``window`` is set by the window stages on fired results:
    ``(key_repr, start, end)`` — the emission identity used for
    duplicate accounting after recovery.
    """

    payload: Any
    size: int
    event_time: float = 0.0
    key: Any = None
    window: Optional[tuple] = None


class ColumnBatch:
    """Columnar element batch: the allocation-free fast path between
    operators.

    Parallel columns (payload/size/event_time/key, python scalars) stand
    in for a list of :class:`Element` objects on the SPE ingest path.
    Operators that implement ``process_cols`` (``Map`` / ``Filter`` /
    ``KeyBy`` / the window assigners) transform the batch without
    materializing per-row objects; :meth:`OperatorChain.process_cols`
    falls back to :meth:`elements` at the first stage that doesn't
    (``StatefulMap`` / ``FlatMap`` / ``BatchOp`` / arbitrary UDF stages)
    — results are identical either way, only the allocations differ.
    """

    __slots__ = ("payloads", "sizes", "event_times", "keys")

    def __init__(self, payloads: list, sizes: list, event_times: list,
                 keys: Optional[list] = None) -> None:
        self.payloads = payloads
        self.sizes = sizes
        self.event_times = event_times
        self.keys = keys if keys is not None else [None] * len(payloads)

    def __len__(self) -> int:
        return len(self.payloads)

    def elements(self) -> list[Element]:
        """Materialize classic elements (the per-element fallback)."""
        return [Element(p, s, t, k)
                for p, s, t, k in zip(self.payloads, self.sizes,
                                      self.event_times, self.keys)]


@dataclass
class OpContext:
    """Per-call context handed to operators (engine/runtime may be None
    in unit tests — operators must guard their monitor/store access)."""

    eng: Any = None
    runtime: Any = None

    @property
    def name(self) -> str:
        return getattr(self.runtime, "name", "spe")

    @property
    def host(self) -> Optional[str]:
        return getattr(self.runtime, "host", None)

    def event(self, kind: str, **kw) -> None:
        if self.eng is not None:
            self.eng.monitor.event(self.eng.now, kind, **kw)


class Operator:
    """One stage of an operator chain.

    ``process`` transforms a batch of elements; ``on_watermark`` lets
    window stages fire due panes.  Mutable state lives in ``self.state``
    so snapshot/restore/reset are uniform.
    """

    def __init__(self) -> None:
        self.state: dict = {}

    def open(self, ctx: OpContext) -> None:
        """Called once when the runtime starts (lazy heavy init)."""

    def process(self, elems: list[Element], ctx: OpContext
                ) -> list[Element]:
        return elems

    def on_watermark(self, wm: float, ctx: OpContext) -> list[Element]:
        """Fire anything due at watermark ``wm``; default: nothing."""
        return []

    # -- state lifecycle (checkpoint / recovery) ------------------------

    def snapshot(self) -> dict:
        return copy.deepcopy(self.state)

    def restore(self, snap: dict) -> None:
        self.state = copy.deepcopy(snap)

    def reset(self) -> None:
        """Volatile-state loss (host failure): start empty."""
        self.state = {}


class Map(Operator):
    """Per-element transform.  ``fn(payload) -> payload | (payload, size)``;
    when only a payload is returned the input size is kept."""

    def __init__(self, fn: Callable[[Any], Any]):
        super().__init__()
        self.fn = fn

    def process(self, elems, ctx):
        out = []
        for e in elems:
            r = self.fn(e.payload)
            if isinstance(r, tuple):
                payload, size = r
            else:
                payload, size = r, e.size
            out.append(Element(payload, size, e.event_time, e.key,
                               e.window))
        return out

    def process_cols(self, cols: ColumnBatch, ctx) -> ColumnBatch:
        """Columnar fast path: same per-payload fn calls, in the same
        order, but no Element objects."""
        fn = self.fn
        pays: list = []
        sizes: list = []
        in_sizes = cols.sizes
        for i, p in enumerate(cols.payloads):
            r = fn(p)
            if isinstance(r, tuple):
                pays.append(r[0])
                sizes.append(r[1])
            else:
                pays.append(r)
                sizes.append(in_sizes[i])
        return ColumnBatch(pays, sizes, cols.event_times, cols.keys)


class StatefulMap(Operator):
    """Per-element transform with chain-checkpointed state:
    ``fn(state_dict, payload) -> payload | (payload, size)``."""

    def __init__(self, fn: Callable[[dict, Any], Any]):
        super().__init__()
        self.fn = fn

    def process(self, elems, ctx):
        out = []
        for e in elems:
            r = self.fn(self.state, e.payload)
            if isinstance(r, tuple):
                payload, size = r
            else:
                payload, size = r, e.size
            out.append(Element(payload, size, e.event_time, e.key,
                               e.window))
        return out


class FlatMap(Operator):
    """``fn(payload) -> list of payload | (payload, size)``."""

    def __init__(self, fn: Callable[[Any], list]):
        super().__init__()
        self.fn = fn

    def process(self, elems, ctx):
        out = []
        for e in elems:
            for r in self.fn(e.payload):
                if isinstance(r, tuple):
                    payload, size = r
                else:
                    payload, size = r, e.size
                out.append(Element(payload, size, e.event_time, e.key,
                                   e.window))
        return out


class Filter(Operator):
    def __init__(self, pred: Callable[[Any], bool]):
        super().__init__()
        self.pred = pred

    def process(self, elems, ctx):
        return [e for e in elems if self.pred(e.payload)]

    def process_cols(self, cols: ColumnBatch, ctx) -> ColumnBatch:
        """Columnar fast path: one pred pass, mask-compress the columns."""
        pred = self.pred
        mask = [bool(pred(p)) for p in cols.payloads]
        if all(mask):
            return cols
        keep = [i for i, m in enumerate(mask) if m]
        return ColumnBatch([cols.payloads[i] for i in keep],
                           [cols.sizes[i] for i in keep],
                           [cols.event_times[i] for i in keep],
                           [cols.keys[i] for i in keep])


class KeyBy(Operator):
    """Attach a key: a field name (dict payloads) or a callable."""

    def __init__(self, key: Any):
        super().__init__()
        if callable(key):
            self.fn = key
        elif key is None:
            self.fn = lambda p: None
        else:
            self.fn = lambda p, k=key: (p.get(k) if isinstance(p, dict)
                                        else None)

    def process(self, elems, ctx):
        for e in elems:
            e.key = self.fn(e.payload)
        return elems

    def process_cols(self, cols: ColumnBatch, ctx) -> ColumnBatch:
        fn = self.fn
        cols.keys = [fn(p) for p in cols.payloads]
        return cols


class BatchOp(Operator):
    """Whole-batch compat stage: ``fn(elems, ctx) -> [(payload, size)]``.

    The legacy ``Query`` bodies (one output list per delivered batch)
    plug in here unchanged; 1:1 outputs keep their input event times so
    downstream windows still see the stamped times.
    """

    def __init__(self, fn: Callable[[list, OpContext], list]):
        super().__init__()
        self.fn = fn

    def process(self, elems, ctx):
        if not elems:
            return []
        results = self.fn(elems, ctx)
        out = []
        one_to_one = len(results) == len(elems)
        max_et = max(e.event_time for e in elems)
        for i, (payload, size) in enumerate(results):
            src = elems[i] if one_to_one else None
            out.append(Element(
                payload, size,
                src.event_time if src is not None else max_et,
                src.key if src is not None else None))
        return out


class _WindowBase(Operator):
    """Shared pane bookkeeping for the window assigners.

    ``state["panes"]`` maps ``(key, window_start)`` -> list of buffered
    payload/size/event_time triples.  Keys must repr deterministically
    (str/int/tuple); firing order sorts on ``(start, repr(key))``.
    """

    def __init__(self, size_s: float, lateness_s: float = 0.0):
        super().__init__()
        assert size_s > 0, "window size must be positive"
        self.size_s = float(size_s)
        self.lateness_s = float(lateness_s)
        self.state = {"panes": {}}

    def _starts(self, et: float) -> list[float]:
        raise NotImplementedError

    def reset(self) -> None:
        self.state = {"panes": {}}

    def process(self, elems, ctx):
        panes = self.state["panes"]
        for e in elems:
            for start in self._starts(e.event_time):
                panes.setdefault((e.key, start), []).append(
                    (e.payload, e.size, e.event_time))
        return []                     # elements leave via on_watermark

    def process_cols(self, cols: ColumnBatch, ctx) -> ColumnBatch:
        """Columnar pane assignment: identical pane contents/order as the
        per-element path, no Element objects."""
        panes = self.state["panes"]
        for p, s, et, k in zip(cols.payloads, cols.sizes,
                               cols.event_times, cols.keys):
            for start in self._starts(et):
                panes.setdefault((k, start), []).append((p, s, et))
        return ColumnBatch([], [], [])

    def on_watermark(self, wm, ctx):
        panes = self.state["panes"]
        due = [kw for kw in panes
               if kw[1] + self.size_s + self.lateness_s <= wm]
        if not due:
            return []
        out = []
        # sorted (start, repr(key)) order: firing sequences must not
        # depend on dict insertion or per-process hash order
        for key, start in sorted(due, key=lambda kw: (kw[1], repr(kw[0]))):
            rows = panes.pop((key, start))
            end = start + self.size_s
            ctx.event("window_fired", spe=ctx.name, key=repr(key),
                      start=start, end=end, n=len(rows))
            out.append(Element(
                {"key": key, "window_start": start, "window_end": end,
                 "records": [p for p, _, _ in rows],
                 "sizes": [s for _, s, _ in rows],
                 "event_times": [t for _, _, t in rows]},
                sum(s for _, s, _ in rows), event_time=end, key=key,
                window=(repr(key), start, end)))
        return out


class TumblingWindow(_WindowBase):
    """Fixed, non-overlapping event-time windows of ``size_s``."""

    def _starts(self, et):
        return [math.floor(et / self.size_s) * self.size_s]

    def process_cols(self, cols: ColumnBatch, ctx) -> ColumnBatch:
        """Vectorized assignment: one ``floor`` pass computes every pane
        start (``float(math.floor(q)) * w == np.floor(q) * w`` — the
        same IEEE ops, so pane keys are bit-identical to ``_starts``).
        The arithmetic lives in ``kernels/cohort.py`` (the Pallas-ready
        cohort seam, shared with the fused fetch path)."""
        n = len(cols)
        if n < 8:
            return _WindowBase.process_cols(self, cols, ctx)
        panes = self.state["panes"]
        starts = cohort_kernels.pane_starts(
            cols.event_times, self.size_s).tolist()
        for p, s, et, k, start in zip(cols.payloads, cols.sizes,
                                      cols.event_times, cols.keys,
                                      starts):
            panes.setdefault((k, start), []).append((p, s, et))
        return ColumnBatch([], [], [])


class SlidingWindow(_WindowBase):
    """Overlapping windows: ``size_s`` long, one every ``slide_s``."""

    def __init__(self, size_s: float, slide_s: float,
                 lateness_s: float = 0.0):
        super().__init__(size_s, lateness_s)
        assert 0 < slide_s <= size_s, "need 0 < slide <= size"
        self.slide_s = float(slide_s)

    def _starts(self, et):
        # all starts k*slide with k*slide <= et < k*slide + size
        first = math.floor((et - self.size_s) / self.slide_s) + 1
        last = math.floor(et / self.slide_s)
        return [k * self.slide_s for k in range(first, last + 1)]


class WindowAggregate(Operator):
    """Reduce a fired pane to one result element.

    ``agg`` is ``"count"`` / ``"sum"`` / ``"mean"`` (``value_field``
    extracts the numeric from dict payloads) or a callable
    ``fn(payloads) -> value``.  The numeric aggregates run a float32
    masked reduction (torch, on the CPU: a tiny host-side sum, not a
    kernel) over a :func:`jit_bucket`-padded batch; padded rows are
    masked out and must never change the real-row result.  Float sums
    agree with the JAX reference only to float32 rounding (ROADMAP C3).
    """

    OUT_SIZE = 24

    def __init__(self, agg: Any = "count",
                 value_field: Optional[str] = None):
        super().__init__()
        self.agg = agg
        self.value_field = value_field

    def _value(self, payload) -> float:
        if self.value_field is not None and isinstance(payload, dict):
            return float(payload.get(self.value_field, 0.0))
        try:
            return float(payload)
        except (TypeError, ValueError):
            return 0.0

    @staticmethod
    def _reduce(vals: np.ndarray, mask: np.ndarray) -> tuple[float, float]:
        import torch
        v = torch.from_numpy(vals)
        m = torch.from_numpy(mask)
        zero = torch.zeros((), dtype=torch.float32)
        kept = torch.where(m, v, zero)
        return (float(torch.sum(kept)),
                float(torch.sum(torch.where(m, 1.0, zero))))

    def _aggregate(self, payloads: list) -> tuple[float, int]:
        n = len(payloads)
        if callable(self.agg):
            return float(self.agg(payloads)), n
        b = jit_bucket(n)
        vals = np.zeros((b,), np.float32)
        mask = np.zeros((b,), bool)
        if self.agg in ("sum", "mean"):
            vals[:n] = [self._value(p) for p in payloads]
        mask[:n] = True
        s, cnt = self._reduce(vals, mask)
        if self.agg == "count":
            return float(cnt), n
        if self.agg == "sum":
            return float(s), n
        if self.agg == "mean":
            return float(s) / max(1, n), n
        raise ValueError(f"unknown aggregate {self.agg!r}")

    def process(self, elems, ctx):
        out = []
        for e in elems:
            p = e.payload
            if not (isinstance(p, dict) and "records" in p):
                out.append(e)         # not a fired pane: pass through
                continue
            value, n = self._aggregate(p["records"])
            out.append(Element(
                {"key": p["key"], "window": [p["window_start"],
                                             p["window_end"]],
                 "agg": self.agg if not callable(self.agg) else "custom",
                 "value": value, "n": n},
                self.OUT_SIZE, event_time=e.event_time, key=e.key,
                window=e.window))
        return out


class Sink(Operator):
    """Terminal side effect: ``fn(elem, ctx)``.  Swallows elements
    unless ``passthrough`` (runtimes emit whatever leaves the chain)."""

    def __init__(self, fn: Callable[[Element, OpContext], None],
                 passthrough: bool = False):
        super().__init__()
        self.fn = fn
        self.passthrough = passthrough

    def process(self, elems, ctx):
        for e in elems:
            self.fn(e, ctx)
        return elems if self.passthrough else []


class OperatorChain:
    """An ordered operator list executed over element batches."""

    def __init__(self, ops: list[Operator]):
        self.ops = list(ops)

    def open(self, ctx: OpContext) -> None:
        for op in self.ops:
            op.open(ctx)

    def process(self, elems: list[Element], ctx: OpContext
                ) -> list[Element]:
        for op in self.ops:
            if not elems:
                break
            elems = op.process(elems, ctx)
        return elems

    def process_cols(self, cols: ColumnBatch, ctx: OpContext
                     ) -> list[Element]:
        """Columnar execution: run ``process_cols`` fast paths while the
        stages support them, materialize :class:`Element`\\ s at the
        first stage that doesn't (the arbitrary-UDF fallback) and finish
        per-element.  Output equals :meth:`process` over
        ``cols.elements()`` exactly — stage order, per-payload call
        order and pane contents are identical; only the per-row object
        allocations differ."""
        elems: Optional[list[Element]] = None
        for op in self.ops:
            if elems is None:
                pc = getattr(op, "process_cols", None)
                if pc is not None:
                    cols = pc(cols, ctx)
                    if not len(cols):
                        return []
                    continue
                elems = cols.elements()
            if not elems:
                break
            elems = op.process(elems, ctx)
        # whatever leaves the chain is emitted as Elements either way
        return cols.elements() if elems is None else elems

    def advance_watermark(self, wm: float, ctx: OpContext
                          ) -> list[Element]:
        """Fire due panes at every stage; fired elements flow through
        the remainder of the chain (downstream of their stage)."""
        outs: list[Element] = []
        for i, op in enumerate(self.ops):
            fired = op.on_watermark(wm, ctx)
            for op2 in self.ops[i + 1:]:
                if not fired:
                    break
                fired = op2.process(fired, ctx)
            outs.extend(fired)
        return outs

    def snapshot(self) -> list[dict]:
        return [op.snapshot() for op in self.ops]

    def restore(self, snaps: list[dict]) -> None:
        for op, s in zip(self.ops, snaps):
            op.restore(s)

    def reset(self) -> None:
        for op in self.ops:
            op.reset()
