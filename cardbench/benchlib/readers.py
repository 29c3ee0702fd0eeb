"""Arithmetic the metric readers share (``metrics/*.py``)."""
from __future__ import annotations

from benchlib import work


def mfu(r):
    """The untraced window's work at the card's peaks over its time, in
    percent: the share of the peak that the whole step (or request)
    reaches, whichever of its FLOPs and bytes bounds it."""
    if r.least_s is None:
        return None
    return 100.0 * r.least_s / r.window_s


def idle_share(r):
    """The share of the untraced window in which no device activity ran,
    in percent: the traced window's device busy time (the union of its
    activities) per unit of its work at the card's peaks, times the
    untraced window's work, over the untraced window.  The profiler slows
    the host but not the device, so the traced window's own idle share
    overstates a host-paced step's."""
    if r.busy_s <= 0 or not r.least_s or not r.trace_least_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.trace_least_s * r.least_s
                    / r.window_s)


def span_ms_per_unit(r, target):
    """A span's device milliseconds per step of the traced window."""
    span = r.spans.get(target)
    if span is None or span.calls == 0 or span.device_s <= 0:
        return None
    return 1e3 * span.device_s / r.units


def roofline(r, target):
    """Of a kernel entry's calls: their least time at the card's peaks
    (the work counted from each call's shapes) over their device time, in
    percent."""
    span = r.spans.get(target)
    if span is None or span.device_s <= 0 or r.peaks is None:
        return None
    least = sum(work.least_s(f, b, r.peaks) for f, b in span.works)
    return 100.0 * least / span.device_s
