"""Event-queue backends for the engine: adaptive calendar queue + heap.

The engine's scheduled-event set is dominated by *near-future* timers:
linger flushes, fetch holds, poll retries, network transfer landings and
zero-delay wakeups all land within a fraction of a second of "now", while
only a thin tail (producer ``delivery_timeout`` retries, long fault
timers) reaches seconds ahead.  A global binary heap pays O(log n) per
push/pop against the *whole* outstanding set; a calendar queue pays only
against the handful of events sharing one short time bucket.

In CPython the crossover is real but high: ``heapq`` is C-implemented,
so a few hundred outstanding events (a 400-node geo-WAN run sits near
~800) pop faster from one big heap than through any Python-level bucket
arithmetic — the wheel only wins once the set reaches the ~10k range
(measured in ``tests/test_calendar_queue.py``'s workload shape).
:class:`CalendarQueue` is therefore **adaptive**: it starts as a plain
heap and *promotes* — once, O(n) — to the bucketed wheel when the
outstanding set crosses ``promote_n``.  Small runs keep exact heap
speed; event-dense fleets get O(1) near-future scheduling.

The wheel itself is a single-level calendar over fixed-width buckets
plus an overflow heap beyond the wheel horizon:

- ``push`` appends to the target bucket (O(1)); only pushes into the
  *current* bucket — zero-delay wakeups — pay a heap insert against that
  bucket's few entries.
- ``pop`` drains the cursor bucket in ``(t, seq)`` order: the bucket is
  heapified lazily when the cursor enters it (one O(b) pass), then
  popped at O(log b).
- Entries past the wheel horizon wait in the overflow heap and are
  re-bucketed when the wheel rotates into their window; an empty wheel
  fast-forwards whole windows at O(1) per window.

**Determinism contract** — the pop sequence is *bit-identical* to the
global heap's, in every mode and across promotion: entries are
``(t, seq, handle)`` tuples under the same ``(t, seq)`` total order,
buckets partition the time axis (equal times always share a bucket),
and bucket classification is monotone in ``t``, so cross-bucket order
is time order and within-bucket order is heap order.  The pop sequence
is a pure function of the pushed set — independent of the backing
structure — which is what makes promotion safe at any point.
``tests/test_calendar_queue.py`` fuzzes all of this against a heap
reference; every pinned event-stream test runs on top of it.

Cancellation stays O(1) and *lazy* exactly as before: a cancelled
handle's entry is left in place and skipped by the engine at pop time.
"""
from __future__ import annotations

from heapq import heapify, heappop, heappush


class HeapQueue:
    """The legacy global binary heap (kept for parity checks)."""

    __slots__ = ("_q",)

    def __init__(self) -> None:
        self._q: list = []

    def push(self, t: float, seq: int, h) -> None:
        heappush(self._q, (t, seq, h))

    def pop(self):
        q = self._q
        return heappop(q) if q else None

    def __len__(self) -> int:
        return len(self._q)


class CalendarQueue:
    """Adaptive calendar queue over ``(t, seq, handle)`` entries.

    Heap-backed until the outstanding set exceeds ``promote_n``, then a
    bucketed timing wheel (see module doc).  ``promote_n=0`` starts on
    the wheel immediately (tests force this to exercise the wheel).
    """

    PROMOTE_N = 8192        # measured CPython heap/wheel crossover region

    __slots__ = ("_w", "_nb", "_span", "_buckets", "_cur", "_base",
                 "_far", "_n", "_heaped", "_heap", "_last_t", "_pn")

    def __init__(self, bucket_s: float = 0.02, n_buckets: int = 512,
                 promote_n: int | None = None) -> None:
        assert bucket_s > 0 and n_buckets > 0
        self._w = float(bucket_s)
        self._nb = int(n_buckets)
        self._span = self._w * self._nb
        self._n = 0
        self._last_t = 0.0              # last popped time (monotone)
        promote_n = self.PROMOTE_N if promote_n is None else promote_n
        self._pn = promote_n
        if promote_n > 0:
            self._heap: list | None = []        # compact mode
            self._buckets: list[list] = []
            self._far: list = []
        else:
            self._heap = None                   # wheel mode from the start
            self._init_wheel(0.0)
        self._cur = 0
        self._base = 0.0
        self._heaped = False

    def __len__(self) -> int:
        return self._n

    def _init_wheel(self, t0: float) -> None:
        self._buckets = [[] for _ in range(self._nb)]
        self._far = []
        self._cur = 0
        self._base = int(t0 / self._w) * self._w
        self._heaped = False

    # -- compact -> wheel promotion (one-way, order-invariant) ----------

    def _promote(self) -> None:
        """Move every heap entry onto the wheel.  The pop sequence is a
        pure function of the entry set, so promoting between any two
        pops cannot change it."""
        heap, self._heap = self._heap, None
        self._init_wheel(self._last_t)
        base, w, nb = self._base, self._w, self._nb
        buckets, far = self._buckets, self._far
        for e in heap:
            i = int((e[0] - base) / w)
            if i >= nb:
                far.append(e)
            else:
                buckets[i if i > 0 else 0].append(e)
        heapify(far)

    # -- push -----------------------------------------------------------

    def push(self, t: float, seq: int, h) -> None:
        heap = self._heap
        if heap is not None:
            heappush(heap, (t, seq, h))
            self._n += 1
            if self._n > self._pn:
                self._promote()
            return
        i = int((t - self._base) / self._w)
        if i >= self._nb:
            heappush(self._far, (t, seq, h))
        else:
            cur = self._cur
            if i <= cur:
                # the current bucket (zero-delay wakeups) — or, as a
                # floating-point guard, a boundary division that rounded
                # below the cursor (time never runs backwards): the
                # cursor bucket's heap order absorbs either case
                if self._heaped:
                    heappush(self._buckets[cur], (t, seq, h))
                else:
                    self._buckets[cur].append((t, seq, h))
            else:
                self._buckets[i].append((t, seq, h))
        self._n += 1

    # -- pop ------------------------------------------------------------

    def pop(self):
        """Next ``(t, seq, handle)`` entry in (t, seq) order, or None."""
        heap = self._heap
        if heap is not None:
            if not heap:
                return None
            self._n -= 1
            e = heappop(heap)
            self._last_t = e[0]
            return e
        b = self._buckets[self._cur]
        if b and self._heaped:          # hot path: drain the cursor heap
            self._n -= 1
            e = heappop(b)
            self._last_t = e[0]
            return e
        return self._pop_scan()

    def _pop_scan(self):
        if self._n == 0:
            return None
        buckets = self._buckets
        while True:
            b = buckets[self._cur]
            if b:
                heapify(b)
                self._heaped = True
                self._n -= 1
                e = heappop(b)
                self._last_t = e[0]
                return e
            self._cur += 1
            self._heaped = False
            if self._cur >= self._nb:
                self._rotate()

    def _rotate(self) -> None:
        """Advance the wheel one window; re-bucket due overflow entries.

        Only called with every wheel bucket empty, so re-bucketed far
        entries cannot interleave behind surviving wheel entries.
        """
        self._base += self._span
        far = self._far
        if far:
            # empty wheel: skip whole windows until the overflow's
            # earliest entry lands inside (idx is monotone in t, so the
            # heap's min bounds every other entry's index too)
            while int((far[0][0] - self._base) / self._w) >= self._nb:
                self._base += self._span
            buckets, nb, w, base = self._buckets, self._nb, self._w, \
                self._base
            # drain the due prefix; int(q) <= q < nb keeps indices valid
            while far and (far[0][0] - base) / w < nb:
                t, seq, h = heappop(far)
                buckets[int((t - base) / w)].append((t, seq, h))
        self._cur = 0
        self._heaped = False


def make_queue(kind: str):
    """Queue factory: ``"calendar"`` (default hot path) or ``"heap"``."""
    if kind == "calendar":
        return CalendarQueue()
    if kind == "heap":
        return HeapQueue()
    raise ValueError(f"unknown scheduler {kind!r} "
                     "(expected 'calendar' or 'heap')")
