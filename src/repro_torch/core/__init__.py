"""stream2gym core: pipeline gym for distributed stream processing.

The paper's primary contribution: a high-level pipeline description API
(GraphML + YAML or programmatic), a discrete-event emulation engine with a
replicated-log event streaming substrate, network condition modeling,
fault injection, and monitoring.  A copy of ``repro.core`` (the JAX
package is the reference), with imports rewritten to ``repro_torch``.
"""
from repro_torch.core.spec import (
    PipelineSpec, Component, TopicCfg, FaultCfg, HostSpec, from_graphml,
    PRODUCER, CONSUMER, BROKER, SPE, STORE,
)
from repro_torch.core.netem import Network, LinkCfg, one_big_switch, star
from repro_torch.core.engine import Engine, EventHandle
from repro_torch.core.broker import RecordBatch
from repro_torch.core.monitor import Monitor
from repro_torch.core.operators import (
    Element, Filter, FlatMap, KeyBy, Map, OperatorChain, Sink,
    SlidingWindow, StatefulMap, TumblingWindow, WindowAggregate,
)
from repro_torch.core.state import (
    FileStateBackend, MemoryStateBackend, StateBackend,
)
from repro_torch.core.telemetry import (
    LatencyHistogram, Profiler, Telemetry, TelemetryCfg,
)

__all__ = [
    "PipelineSpec", "Component", "TopicCfg", "FaultCfg", "HostSpec",
    "from_graphml", "Network", "LinkCfg", "one_big_switch", "star",
    "Engine", "EventHandle", "RecordBatch", "Monitor",
    "PRODUCER", "CONSUMER", "BROKER", "SPE", "STORE",
    "Element", "Filter", "FlatMap", "KeyBy", "Map", "OperatorChain",
    "Sink", "SlidingWindow", "StatefulMap", "TumblingWindow",
    "WindowAggregate", "StateBackend", "MemoryStateBackend",
    "FileStateBackend", "TelemetryCfg", "Telemetry", "LatencyHistogram",
    "Profiler",
]
