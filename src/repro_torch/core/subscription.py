"""Subscriber delivery loops: event-driven wakeups or legacy polling.

Both consumer stubs and SPE runtimes subscribe to topics and pull records
through ``Cluster.fetch``.  This mixin owns the *scheduling* of those
fetches in the two delivery modes (``spec.delivery``):

``wakeup`` (default)
    After an empty fetch the subscriber parks as a cluster *waiter*; the
    cluster wakes it when any of the topic's partition high watermarks
    advances past its offset (or leadership changes, or its consumer
    group rebalances).  An idle subscriber costs **zero** events — the
    old ``poll_interval=0.1`` path generated millions of no-op events
    over long sweeps.  When a fetch is *blocked* (leader unreachable,
    election in progress, stale metadata, lost response) the loop
    degrades to interval retries, so fault scenarios behave like polling
    until the cluster is healthy again.

One ``Cluster.fetch`` call serves every partition the subscriber
currently owns (its group assignment), returning one combined status, so
the per-(subscriber, topic) invariant below is unchanged by partitioning:
a group rebalance simply makes the next fetch read a different partition
set, and ``_notify`` wakes parked members so none hangs on a stale
assignment.

``poll``
    The legacy fixed-interval loop, kept behind the spec flag for parity
    checks (see ``tests/test_wakeup_parity.py``).

The busy gate mirrors Kafka's synchronous poll loop: a subscriber whose
host is still processing the previous batch defers its next fetch until
the processing completes (``_busy_horizon``).
"""
from __future__ import annotations

from repro_torch.core.broker import (
    FETCH_DELIVERED, FETCH_DELIVERED_MORE, FETCH_EMPTY, BatchView,
)
from repro_torch.core.operators import shed_keep


class DeliveryLoop:
    """Mixin driving Cluster.fetch for a subscriber runtime.

    :meth:`init_subscriber` installs the shared subscriber surface —
    ``name`` / ``host`` / ``group`` / ``poll_interval`` / ``busy_until``
    — used by both consumer stubs and SPE runtimes (hoisted here so a
    new runtime kind never re-implements the delivery plumbing); the
    host class provides ``on_records(eng, records)``.

    The busy gate mirrors Kafka's synchronous poll loop: a subscriber
    that sets ``busy_until`` past *now* (consumers do after each
    processed batch; SPE runtimes deliberately do not — their service
    time is modeled on the host compute queue instead) defers its next
    fetch until processing completes.
    """

    def init_subscriber(self, comp, host: str, topics) -> None:
        """Shared subscriber state (consumer stubs + SPE runtimes)."""
        self.comp = comp
        self.host = host
        self.name = comp.name
        self.topics = list(topics)
        # consumer group: members sharing a group split partitions and
        # share committed offsets; None = implicit solo group
        self.group = comp.get("group")
        self.poll_interval = float(comp.get("pollInterval", 0.1))
        self.busy_until = 0.0
        # backpressure / load shedding (0 = unbounded, the default — in
        # that case every bp_* hook below is a no-op and the delivery
        # loop is byte- and event-identical to the unbounded build)
        self.queue_bytes_max = int(comp.get("queueBytes", 0))
        self.shed_policy = str(comp.get("shedPolicy", "pause"))
        self._q_used = 0            # bytes admitted but not yet processed
        self._q_peak = 0
        self.n_shed = 0
        self.bytes_shed = 0
        self.n_pauses = 0
        self.pause_s = 0.0
        self._bp_paused: dict = {}  # loop key -> pause start time
        self._bp_epoch = 0          # bumps on reset; stale drains ignored
        self._bp_starved = False    # broker found rows the budget can't
                                    # admit: pause instead of busy-poll

    def start_delivery(self, eng, topics) -> None:
        topics = list(topics)
        for t in topics:
            eng.cluster.subscribe(self, t)
        # random initial phase (real subscribers are not synchronized)
        rng = eng.client_rng(self.name)
        if eng.delivery_mode == "wakeup":
            for t in topics:
                eng.schedule(rng.uniform(0, self.poll_interval),
                             lambda t=t: self._fetch_once(eng, t))
        else:
            eng.schedule(rng.uniform(0, self.poll_interval),
                         lambda: self._poll(eng, topics))

    def _busy_horizon(self, eng) -> float:
        """Time until which fetches must be deferred (0 = never busy)."""
        return getattr(self, "busy_until", 0.0)

    # -- backpressure / load shedding ----------------------------------
    #
    # A bounded subscriber (``queueBytes > 0``) accounts every admitted
    # byte in ``_q_used`` and drains it when the batch finishes
    # processing.  Under the default ``pause`` policy the *fetch side*
    # is throttled: ``fetch_budget`` caps the broker's take (strict —
    # never overshoots, except for a single record larger than the whole
    # bound) and a full queue parks the delivery loop in a third state —
    # paused — replacing both the scheduled-event and the cluster-waiter
    # legs of the invariant; ``bp_drain`` resumes it with a zero-delay
    # fetch.  Shed policies instead fetch normally and drop at
    # *admission*: offsets have already advanced, so shed rows are
    # consumed-but-dropped and never replayed, and the bounded queue
    # never touches rows that were delivered downstream.

    def fetch_budget(self):
        """Remaining ingest-queue bytes, or None when unthrottled."""
        if self.queue_bytes_max > 0 and self.shed_policy == "pause":
            return self.queue_bytes_max - self._q_used
        return None

    def queue_empty(self) -> bool:
        return self._q_used <= 0

    def bp_reserve(self, nbytes: int) -> None:
        """Account bytes taken by the broker on our behalf (pause
        policy: the reservation covers in-flight + queued bytes)."""
        if self.queue_bytes_max > 0 and self.shed_policy == "pause":
            self._q_used += nbytes
            if self._q_used > self._q_peak:
                self._q_peak = self._q_used

    def _bp_full(self) -> bool:
        return (self.queue_bytes_max > 0 and self.shed_policy == "pause"
                and self._q_used >= self.queue_bytes_max)

    def bp_starve(self) -> None:
        """Broker callback: data is committed but the remaining budget
        cannot admit the next record — the loop should pause."""
        self._bp_starved = True

    def _bp_pause(self, eng, key) -> None:
        if key not in self._bp_paused:
            self._bp_paused[key] = eng.now
            self.n_pauses += 1
            tel = eng.telemetry
            if tel is not None:
                tel.flight(eng.now, "bp_pause", sub=self.name,
                           queued_bytes=self._q_used)

    def bp_drain(self, eng, nbytes: int, epoch=None) -> None:
        """Release queue bytes after processing; resume paused loops."""
        if epoch is not None and epoch != self._bp_epoch:
            return      # reserved before a reset: already zeroed
        self._q_used = max(0, self._q_used - nbytes)
        if self._bp_paused and self._q_used < self.queue_bytes_max:
            self._bp_resume(eng)

    def _bp_resume(self, eng) -> None:
        paused, self._bp_paused = self._bp_paused, {}
        tel = eng.telemetry
        if tel is not None and paused:
            tel.flight(eng.now, "bp_resume", sub=self.name,
                       queued_bytes=self._q_used)
        for key, since in paused.items():
            self.pause_s += eng.now - since
            if isinstance(key, tuple):      # poll mode: whole topic list
                eng.schedule(0.0, lambda k=key: self._poll(eng, list(k)))
            else:                           # wakeup mode: one topic
                eng.schedule(0.0,
                             lambda k=key: self._fetch_once(eng, k))

    def bp_reset(self, eng) -> None:
        """Host crash: queued-but-unprocessed bytes die with the host."""
        self._bp_epoch += 1
        self._q_used = 0
        if self._bp_paused:
            self._bp_resume(eng)

    def bp_admit(self, eng, records):
        """Admission control for shed policies; pass-through otherwise.

        Returns the (possibly reduced) batch to process.  The decision
        is pure integer arithmetic over the size prefix (no RNG, even
        for ``sample``), so shed counts are bit-identical across
        processes and schedulers.
        """
        if self.queue_bytes_max <= 0 or self.shed_policy == "pause":
            return records
        if isinstance(records, BatchView):
            sizes = records.sizes()
        else:
            sizes = [r.size for r in records]
        total = sum(sizes)
        space = max(0, self.queue_bytes_max - self._q_used)
        if total <= space:
            self._q_used += total
            if self._q_used > self._q_peak:
                self._q_peak = self._q_used
            return records
        how, sel, kept_bytes = shed_keep(sizes, space, self.shed_policy)
        n = len(sizes)
        if how == "slice":
            lo, hi = sel
            if isinstance(records, BatchView):
                kept = records.subview(lo, hi)
            else:
                kept = records[lo:hi]
            k = hi - lo
        else:   # explicit indices (sample)
            if isinstance(records, BatchView):
                kept = [records.record_at(i) for i in sel]
            else:
                kept = [records[i] for i in sel]
            k = len(sel)
        self.n_shed += n - k
        self.bytes_shed += total - kept_bytes
        self._q_used += kept_bytes
        if self._q_used > self._q_peak:
            self._q_peak = self._q_used
        eng.monitor.event(eng.now, "records_shed", sub=self.name,
                          n=n - k, bytes=total - kept_bytes,
                          policy=self.shed_policy)
        return kept

    # -- legacy polling -------------------------------------------------

    def _poll(self, eng, topics) -> None:
        if self._bp_full():
            # paused replaces the scheduled poll event; bp_drain resumes
            self._bp_pause(eng, tuple(topics))
            return
        busy = self._busy_horizon(eng)
        if busy > eng.now:
            eng.schedule(busy - eng.now, lambda: self._poll(eng, topics))
            return
        for t in topics:
            eng.cluster.fetch(self, t)
        if self._bp_starved:
            self._bp_starved = False
            self._bp_pause(eng, tuple(topics))
            return
        eng.schedule(self.poll_interval, lambda: self._poll(eng, topics))

    # -- event-driven wakeups ------------------------------------------
    #
    # Invariant: per (subscriber, topic) exactly one of {scheduled fetch
    # event, cluster waiter registration} is outstanding, so fetches are
    # never duplicated and never dropped.

    def _fetch_once(self, eng, topic) -> None:
        if self._bp_full():
            # paused replaces both the fetch event and the waiter slot
            # (no waiter is parked at this point per the invariant above)
            self._bp_pause(eng, topic)
            return
        busy = self._busy_horizon(eng)
        if busy > eng.now:
            eng.schedule(busy - eng.now,
                         lambda: self._fetch_once(eng, topic))
            return
        status = eng.cluster.fetch(self, topic)
        if self._bp_starved:
            # a partition has rows the ingest budget can't admit yet:
            # park paused (replacing the fetch event) until bp_drain
            # frees space, instead of spinning zero-row fetches
            self._bp_starved = False
            self._bp_pause(eng, topic)
            return
        if status == FETCH_EMPTY or status == FETCH_DELIVERED:
            # drained to the high watermark: park until it advances
            eng.cluster.wait_for_data(self, topic)
        elif status == FETCH_DELIVERED_MORE:
            # byte-capped response: drain the remainder at the polling
            # cadence, exactly like the legacy loop — the in-flight batch
            # must land (and set the busy horizon) before the next fetch,
            # otherwise a big backlog is pulled in one sim instant
            eng.schedule(self.poll_interval,
                         lambda: self._fetch_once(eng, topic))
        else:   # blocked: fall back to interval retries under faults
            eng.schedule(self.poll_interval,
                         lambda: self._fetch_once(eng, topic))

    def on_wakeup(self, eng, topic) -> None:
        """Cluster callback: the topic may have data past our offset."""
        self._fetch_once(eng, topic)

    # -- cohort ingest (fetch_mode="fused") ----------------------------

    def on_records_cohort(self, eng, batches) -> None:
        """Ingest every view of one same-tick deliver cohort.

        Default: per-view ``on_records`` in landing order — identical
        to the per-partition deliver events it replaces.  Processing
        MUST stay per-view: each view's float accounting (histogram
        inserts, watermark advances, busy-horizon chaining) has an
        order the fused/legacy parity contract pins; only per-cohort
        *invariants* (attribute lookups, alive checks — anything no
        event can change mid-cohort) may be hoisted by overrides (see
        SPERuntime.on_records_cohort and the ROADMAP cohort contract).
        """
        on = self.on_records
        for b in batches:
            on(eng, b)
