"""Observability exports: Chrome trace building and validation.

The sim-side state (rings, histograms, flight recorder) lives in
:mod:`repro_torch.core.telemetry`; this package turns that state into
artifacts a human can open — Chrome trace-event JSON loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

:mod:`repro_torch.obs.spans` names the port's layers in a torch
profiler's trace.  It imports torch, so this package does not import it:
the emulator imports ``obs`` without torch.
"""
from repro_torch.obs.trace import chrome_trace, validate_chrome_trace, write_trace

__all__ = ["chrome_trace", "validate_chrome_trace", "write_trace"]
