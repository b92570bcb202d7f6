"""The observability plane (counterpart of ``repro.obs``, ported part):

- trace:     ring-bounded structured events across the decision path,
             exportable as JSONL and Chrome trace_event JSON
- registry:  counters/gauges/histograms with percentile sketches and a
             Prometheus text exporter
- slo:       rolling-window SLO monitors and the lag-ratio monitor
- audit:     prediction ledger joining planner forecasts with outcomes
- calibrate: transfer probes of the memory kinds, and the cost-model
             calibrator fitting per-link corrections from them and
             online EWMA scales from audit residuals
- qos:       interference-class QoS plane: blame attribution of SLO
             violations to links and noisy neighbours, and
             violation-predictive admission
"""
from .audit import DriftDetector, PredictionLedger, PredictionRecord
from .calibrate import (CostModelCalibrator, LinkCorrection,
                        measure_transfer_probes, probe_testbed,
                        probed_kind_bases, TierProbe)
from .qos import (BlameLedger, Excursion, QOS_VIOLATION_MODEL,
                  QOS_VIOLATION_TOLERANCE, ViolationPredictor)
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       PercentileSketch)
from .slo import LagRatioMonitor, SLOMonitor, SLOTarget
from .trace import qos_chains, replan_chains, TraceEvent, TraceRecorder

__all__ = [
    "TraceEvent", "TraceRecorder", "qos_chains", "replan_chains",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "PercentileSketch",
    "LagRatioMonitor", "SLOMonitor", "SLOTarget",
    "DriftDetector", "PredictionLedger", "PredictionRecord",
    "CostModelCalibrator", "LinkCorrection", "TierProbe",
    "measure_transfer_probes", "probe_testbed", "probed_kind_bases",
    "BlameLedger", "Excursion", "QOS_VIOLATION_MODEL",
    "QOS_VIOLATION_TOLERANCE", "ViolationPredictor",
]
