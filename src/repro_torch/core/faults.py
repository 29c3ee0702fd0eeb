"""Fault injection: link failures, host crashes, gray failures, chaos.

The engine schedules each ``FaultCfg`` from the spec; ``duration > 0``
schedules the automatic heal.  Gray failures (paper §III-C) are modeled
as elevated link loss or extra per-host transfer delay rather than hard
down.

Overlap safety: chaos plans routinely schedule overlapping faults on the
same link or host (a flapping link inside a correlated outage, two gray
ramps crossing).  Every fault therefore applies through a per-target
*stack* — link/host down states are depth-counted (the target comes back
up only when the last overlapping fault heals) and gray/slow intensities
take the max over the active entries, restoring the captured baseline
when the stack empties.  A heal never clobbers a still-active fault's
effect, which is the regression the old captured-``prev`` closures had.

Chaos plans (``PipelineSpec.chaos``) expand at install time into
concrete ``FaultCfg`` entries drawn from the dedicated
``Engine.client_rng("chaos")`` stream — fixed category order, sorted
candidate lists, absolute times — so the schedule is bit-identical
across processes, schedulers and delivery modes for one (spec, seed).
"""
from __future__ import annotations

import random

from repro_torch.core.spec import ChaosCfg, FaultCfg


def install(engine, faults: list[FaultCfg]) -> None:
    chaos = getattr(engine.spec, "chaos", None)
    expanded: list[FaultCfg] = []
    if chaos is not None:
        expanded = expand_chaos(engine.spec, chaos,
                                engine.client_rng("chaos"))
    engine.n_chaos_faults = len(expanded)
    for f in list(faults) + expanded:
        engine.schedule(f.at, lambda f=f: _apply(engine, f))


# ---------------------------------------------------------------------------
# Chaos plan expansion (deterministic: one RNG stream, fixed draw order)
# ---------------------------------------------------------------------------


def expand_chaos(spec, chaos: ChaosCfg,
                 rng: random.Random) -> list[FaultCfg]:
    """Expand a :class:`ChaosCfg` into concrete fault events.

    Draw order is part of the determinism contract: flapping →
    correlated → gray → slow → crash, each sampling from *sorted*
    candidate lists.  All times are absolute offsets into the run, so
    the resulting schedule is independent of anything the engine does
    while running.
    """
    g = spec.network.g
    out: list[FaultCfg] = []
    links = sorted(tuple(sorted((a, b))) for a, b in g.edges)
    protect = set(chaos.protect)
    hosts = [h for h in sorted(spec.hosts) if h not in protect]
    core = set(getattr(spec, "core_hosts", ()) or ())
    # correlated failures hit the access tier when the topology has a
    # core/access split (geo_wan); otherwise any component host
    access = [h for h in hosts if h not in core] or hosts
    t0, span = chaos.start, chaos.duration

    def when(slack: float) -> float:
        return t0 + rng.uniform(0.0, max(0.0, span - slack))

    if links:
        for _ in range(chaos.flap_links):
            a, b = links[rng.randrange(len(links))]
            period = chaos.flap_period_s
            down = period * chaos.flap_duty
            t = t0 + rng.uniform(0.0, period)
            while t < t0 + span:
                out.append(FaultCfg(t, "link_down", (a, b),
                                    duration=down))
                t += period
        for _ in range(chaos.correlated if access else 0):
            h = access[rng.randrange(len(access))]
            t = when(chaos.correlated_duration_s)
            for nbr in sorted(g.neighbors(h)):
                out.append(FaultCfg(
                    t, "link_down", (h, nbr),
                    duration=chaos.correlated_duration_s))
        for _ in range(chaos.gray):
            a, b = links[rng.randrange(len(links))]
            steps = max(1, chaos.gray_steps)
            t = when(steps * chaos.gray_step_s)
            # overlapping steps of increasing loss, all healing together
            # at ramp end: exercises the stacked-restore path by design
            for i in range(steps):
                out.append(FaultCfg(
                    t + i * chaos.gray_step_s, "gray_loss", (a, b),
                    duration=(steps - i) * chaos.gray_step_s,
                    loss_pct=chaos.gray_max_loss_pct * (i + 1) / steps))
    if hosts:
        for _ in range(chaos.slow):
            h = hosts[rng.randrange(len(hosts))]
            out.append(FaultCfg(when(chaos.slow_duration_s), "slow_host",
                                (h,), duration=chaos.slow_duration_s,
                                delay_s=chaos.slow_delay_s))
        for _ in range(chaos.crashes):
            h = hosts[rng.randrange(len(hosts))]
            out.append(FaultCfg(when(chaos.crash_downtime_s),
                                "host_down", (h,),
                                duration=chaos.crash_downtime_s))
    return out


# ---------------------------------------------------------------------------
# Fault application (overlap-safe via per-target stacks)
# ---------------------------------------------------------------------------


def _stacks(engine) -> dict:
    st = getattr(engine, "_fault_stacks", None)
    if st is None:
        st = engine._fault_stacks = {}
    return st


def _push(engine, key: tuple, baseline, value) -> list:
    """Register one active fault on ``key``; returns the active list."""
    ent = _stacks(engine).setdefault(
        key, {"baseline": baseline, "active": []})
    ent["active"].append(value)
    return ent["active"]


def _pop(engine, key: tuple, value):
    """Retire one active fault; returns (remaining_active, baseline)."""
    ent = _stacks(engine)[key]
    ent["active"].remove(value)
    return ent["active"], ent["baseline"]


def _apply(engine, f: FaultCfg) -> None:
    net = engine.net
    mon = engine.monitor
    t = engine.now
    if f.kind == "link_down":
        a, b = f.target
        key = ("link",) + tuple(sorted((a, b)))
        if len(_push(engine, key, True, f)) == 1:
            net.set_link_up(a, b, False)
        mon.event(t, "link_down", a=a, b=b)
        if f.duration:
            engine.schedule(f.duration,
                            lambda: _heal_link(engine, key, a, b, f))
    elif f.kind == "host_down":
        (h,) = f.target
        key = ("host", h)
        if len(_push(engine, key, True, f)) == 1:
            net.set_host_up(h, False)
            # volatile runtime state dies with the host (SPE operator
            # state, uncommitted outputs); checkpoints live in the
            # engine's durable state backend and survive
            engine.host_transition(h, up=False)
        mon.event(t, "host_down", host=h)
        if f.duration:
            engine.schedule(f.duration,
                            lambda: _heal_host(engine, key, h, f))
    elif f.kind == "gray_loss":
        a, b = f.target
        link = net.link(a, b)
        key = ("gray",) + tuple(sorted((a, b)))
        active = _push(engine, key, link.loss_pct, f)
        # the effective loss is the max over the overlapping faults (and
        # never below the spec baseline); applied through the network's
        # loss seam so routing tables drop their composed keep rows
        net.set_link_loss(a, b,
                          max(_stacks(engine)[key]["baseline"],
                              max(x.loss_pct for x in active)))
        mon.event(t, "gray_loss", a=a, b=b, loss=f.loss_pct)
        if f.duration:
            engine.schedule(f.duration,
                            lambda: _heal_gray(engine, key, a, b, f))
    elif f.kind == "slow_host":
        (h,) = f.target
        key = ("slow", h)
        active = _push(engine, key, 0.0, f)
        net.set_host_slow(h, max(x.delay_s for x in active))
        mon.event(t, "slow_host", host=h, delay_s=f.delay_s)
        if f.duration:
            engine.schedule(f.duration,
                            lambda: _heal_slow(engine, key, h, f))
    else:
        raise ValueError(f"unknown fault kind {f.kind!r}")


def _heal_link(engine, key: tuple, a: str, b: str, f: FaultCfg) -> None:
    active, _ = _pop(engine, key, f)
    if not active:
        engine.net.set_link_up(a, b, True)
        engine.monitor.event(engine.now, "link_up", a=a, b=b)


def _heal_host(engine, key: tuple, h: str, f: FaultCfg) -> None:
    active, _ = _pop(engine, key, f)
    if not active:
        engine.net.set_host_up(h, True)
        engine.monitor.event(engine.now, "host_up", host=h)
        # recovery: runtimes restore their latest checkpoint (if any) and
        # seek their input offsets back to the checkpointed positions
        engine.host_transition(h, up=True)


def _heal_gray(engine, key: tuple, a: str, b: str, f: FaultCfg) -> None:
    active, baseline = _pop(engine, key, f)
    if active:
        engine.net.set_link_loss(a, b,
                                 max(baseline,
                                     max(x.loss_pct for x in active)))
    else:
        engine.net.set_link_loss(a, b, baseline)
        engine.monitor.event(engine.now, "gray_heal", a=a, b=b)


def _heal_slow(engine, key: tuple, h: str, f: FaultCfg) -> None:
    active, _ = _pop(engine, key, f)
    if active:
        engine.net.set_host_slow(h, max(x.delay_s for x in active))
    else:
        engine.net.set_host_slow(h, 0.0)
        engine.monitor.event(engine.now, "slow_heal", host=h)
