"""The observability plane (counterpart of ``repro.obs``, ported part):

- trace:     ring-bounded structured events across the decision path,
             exportable as JSONL and Chrome trace_event JSON
- registry:  counters/gauges/histograms with percentile sketches and a
             Prometheus text exporter
- slo:       rolling-window SLO monitors and the lag-ratio monitor
- audit:     prediction ledger joining planner forecasts with outcomes
- calibrate: transfer probes of the memory kinds (``TierProbe``,
             ``measure_transfer_probes``)

The cost-model calibrator and the QoS plane are not ported yet.
"""
from .audit import DriftDetector, PredictionLedger, PredictionRecord
from .calibrate import measure_transfer_probes, TierProbe
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       PercentileSketch)
from .slo import LagRatioMonitor, SLOMonitor, SLOTarget
from .trace import qos_chains, replan_chains, TraceEvent, TraceRecorder

__all__ = [
    "TraceEvent", "TraceRecorder", "qos_chains", "replan_chains",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "PercentileSketch",
    "LagRatioMonitor", "SLOMonitor", "SLOTarget",
    "DriftDetector", "PredictionLedger", "PredictionRecord",
    "measure_transfer_probes", "TierProbe",
]
