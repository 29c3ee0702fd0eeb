"""Observability exports: Chrome trace building and validation.

The sim-side state (rings, histograms, flight recorder) lives in
:mod:`repro_torch.core.telemetry`; this package turns that state into
artifacts a human can open — Chrome trace-event JSON loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
"""
from repro_torch.obs.trace import chrome_trace, validate_chrome_trace, write_trace

__all__ = ["chrome_trace", "validate_chrome_trace", "write_trace"]
