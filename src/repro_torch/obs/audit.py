"""PyTorch-port copy of ``repro.obs.audit`` (framework-free).

Prediction audit plane: every planner forecast meets its outcome.

The control plane is full of predictions — ``MigrationExecutor`` prices
a delta before moving a byte, ``plan_step_cost`` promises a step time,
the predictive ``TierBudgetArbiter`` grants fast capacity for demand it
expects next epoch, and ``PhaseDetector.expected_signature`` names the
phase about to run.  "Dissecting CXL Memory Performance at Scale"
(arxiv 2409.14317) argues the measure->model->optimize loop is what
makes such models trustworthy off-simulator; this module is the
*measure* half of that loop for the repro's own models:

- :class:`PredictionLedger` records each predicted quantity under a
  ``(model, join key)`` pair and later joins the realized outcome,
  emitting the signed relative-error residual into a DDSketch histogram
  (``prediction.residual.<model>``) in the shared ``MetricsRegistry``
  and a ``prediction.audit`` trace event per join;
- a rolling-window :class:`DriftDetector` per model fires (counter +
  ``prediction.drift`` trace event) when the window's p95 *absolute*
  relative error exceeds a bound — the signal that a cost model has
  drifted from the hardware and needs recalibration;
- residuals are optionally *attributed* to the resources (links/tiers)
  the predicted quantity crossed, in the spirit of CXL-Interference
  (arxiv 2411.18308): a shared UPI hop that consistently runs slower
  than modeled shows up as that link's residual bias, which the
  ``CostModelCalibrator`` consumes.

Everything is zero-dependency, bounded-memory, and clock-injected.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import (Any, Deque, Dict, Hashable, Iterable, List, Mapping,
                    Optional, Tuple, Union)

__all__ = ["PredictionRecord", "DriftDetector", "PredictionLedger"]

ResourceKey = Hashable
Resources = Union[Iterable[ResourceKey], Mapping[ResourceKey, float]]


@dataclasses.dataclass
class PredictionRecord:
    """One audited prediction (realized fields filled at the join)."""

    model: str                      # e.g. "migration.move_time"
    key: Hashable                   # join key within the model
    predicted: float
    epoch: Optional[int] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    realized: Optional[float] = None
    rel_err: Optional[float] = None   # signed (realized-predicted)/|pred|

    @property
    def matched(self) -> bool:
        return self.realized is not None

    @property
    def abs_rel_err(self) -> Optional[float]:
        return None if self.rel_err is None else abs(self.rel_err)


class DriftDetector:
    """Rolling-window p95 absolute-relative-error bound check.

    ``observe`` returns True exactly when the window (once it holds
    ``min_samples``) crosses from compliant to drifting — edge-
    triggered, so one sustained drift fires once, not once per sample;
    ``drifting`` stays True until the window recovers.
    """

    def __init__(self, bound: float = 0.5, window: int = 64,
                 min_samples: int = 8):
        if bound <= 0.0:
            raise ValueError("drift bound must be positive")
        self.bound = float(bound)
        self.window: Deque[float] = deque(maxlen=int(window))
        self.min_samples = int(min_samples)
        self.drifting = False
        self.fires = 0

    def p95(self) -> Optional[float]:
        if not self.window:
            return None
        vals = sorted(self.window)
        rank = 0.95 * (len(vals) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def observe(self, abs_rel_err: float) -> bool:
        self.window.append(abs(float(abs_rel_err)))
        if len(self.window) < self.min_samples:
            return False
        over = self.p95() > self.bound
        fired = over and not self.drifting
        self.drifting = over
        if fired:
            self.fires += 1
        return fired


class PredictionLedger:
    """Join predicted quantities with realized outcomes, per model.

    ``predict(model, key, value)`` files a pending prediction;
    ``realize(model, key, value)`` joins it, computes the signed
    relative-error residual, and feeds the registry histograms, the
    accuracy gauges, the drift detector, and (when ``resources`` are
    given) the per-link/tier residual attribution.

    Edge cases are first-class observables, not errors:

    - a realized outcome with no pending prediction counts as
      ``unmatched`` (and returns None) — the producer side lost it;
    - a duplicate join key *overwrites* the stale pending prediction
      and counts as ``duplicate`` — latest forecast wins;
    - a prediction of exactly zero cannot define a relative error: the
      join is recorded with ``rel_err=None`` and counted as
      ``zero_predicted`` instead of dividing by zero.
    """

    def __init__(self, registry=None, tracer=None,
                 tolerance: float = 0.25,
                 model_tolerance: Optional[Mapping[str, float]] = None,
                 drift_bound: float = 0.5, drift_window: int = 64,
                 drift_min_samples: int = 8,
                 max_pending: int = 4096, max_records: int = 4096):
        if not 0.0 < tolerance:
            raise ValueError("tolerance must be positive")
        self.registry = registry
        self.tracer = tracer
        self.tolerance = float(tolerance)
        # per-model accuracy tolerances: a tail-latency predictor is
        # judged looser than a byte-counting move-time model
        self.model_tolerance: Dict[str, float] = {
            str(m): float(t) for m, t in (model_tolerance or {}).items()}
        for t in self.model_tolerance.values():
            if not t > 0.0:
                raise ValueError("model tolerance must be positive")
        self._drift_bound = float(drift_bound)
        self._drift_window = int(drift_window)
        self._drift_min = int(drift_min_samples)
        self.max_pending = int(max_pending)
        # pending predictions by (model, key); insertion-ordered so the
        # oldest forecast expires first when the bound is hit
        self._pending: Dict[Tuple[str, Hashable], PredictionRecord] = {}
        self._records: Dict[str, Deque[PredictionRecord]] = {}
        self._max_records = int(max_records)
        self._drift: Dict[str, DriftDetector] = {}
        # per-resource residual attribution: key -> [mean signed err, n]
        self._resource_err: Dict[ResourceKey, List[float]] = {}
        self.predictions = 0
        self.matched = 0
        self.unmatched = 0
        self.duplicates = 0
        self.zero_predicted = 0
        self.expired = 0

    # ------------------------------------------------------------------ #
    # record / join                                                      #
    # ------------------------------------------------------------------ #
    def predict(self, model: str, key: Hashable, value: float,
                epoch: Optional[int] = None,
                **meta: Any) -> PredictionRecord:
        rec = PredictionRecord(str(model), key, float(value), epoch,
                               dict(meta))
        pkey = (rec.model, key)
        if pkey in self._pending:
            self.duplicates += 1
            self._count(f"prediction.duplicate.{rec.model}",
                        "stale pending prediction overwritten")
        self._pending[pkey] = rec
        self.predictions += 1
        self._count(f"prediction.predicted.{rec.model}",
                    "predictions filed for audit")
        if len(self._pending) > self.max_pending:
            oldest = next(iter(self._pending))
            del self._pending[oldest]
            self.expired += 1
            self._count("prediction.expired",
                        "pending predictions evicted unjoined")
        return rec

    def has_pending(self, model: str, key: Hashable) -> bool:
        return (str(model), key) in self._pending

    def pending_count(self, model: Optional[str] = None) -> int:
        if model is None:
            return len(self._pending)
        return sum(1 for m, _ in self._pending if m == model)

    def realize(self, model: str, key: Hashable, value: float,
                resources: Optional[Resources] = None
                ) -> Optional[PredictionRecord]:
        """Join one realized outcome; returns the completed record, or
        None when no prediction was pending under ``(model, key)``."""
        model = str(model)
        rec = self._pending.pop((model, key), None)
        if rec is None:
            self.unmatched += 1
            self._count(f"prediction.unmatched.{model}",
                        "realized outcomes with no pending prediction")
            self._event(model, key, None, float(value), None)
            return None
        rec.realized = float(value)
        if rec.predicted != 0.0:
            rec.rel_err = (rec.realized - rec.predicted) \
                / abs(rec.predicted)
        else:
            self.zero_predicted += 1
            self._count(f"prediction.zero_predicted.{model}",
                        "joins whose predicted value was zero")
        self.matched += 1
        self._count(f"prediction.matched.{model}",
                    "prediction/outcome joins completed")
        recs = self._records.get(model)
        if recs is None:
            recs = self._records[model] = deque(maxlen=self._max_records)
        recs.append(rec)
        if rec.rel_err is not None:
            if self.registry is not None:
                self.registry.histogram(
                    f"prediction.residual.{model}",
                    help="absolute relative error of audited "
                         "predictions").observe(abs(rec.rel_err))
                acc = self.accuracy(model)
                if acc is not None:
                    tol = self.model_tolerance.get(model, self.tolerance)
                    self.registry.gauge(
                        f"prediction.accuracy.{model}",
                        help=f"fraction of joins within "
                             f"{tol:.0%} relative error"
                    ).set(acc)
            det = self._drift.get(model)
            if det is None:
                det = self._drift[model] = DriftDetector(
                    self._drift_bound, self._drift_window,
                    self._drift_min)
            if det.observe(abs(rec.rel_err)):
                self._count(f"prediction.drift.{model}",
                            "rolling p95 relative error crossed the "
                            "drift bound")
                if self.tracer is not None:
                    self.tracer.event(
                        "prediction.drift", cat="audit", model=model,
                        p95_rel_err=det.p95(), bound=det.bound,
                        window=len(det.window))
            if resources is not None:
                self._attribute(resources, rec.rel_err)
        self._event(model, key, rec.predicted, rec.realized, rec.rel_err)
        return rec

    def _attribute(self, resources: Resources, rel_err: float) -> None:
        """Spread one residual over the resources the prediction
        crossed, weighted by each resource's modeled occupancy share —
        the per-link bias the calibrator reads."""
        if isinstance(resources, Mapping):
            items = [(k, float(w)) for k, w in resources.items()
                     if w > 0.0]
            total = sum(w for _, w in items)
            if total <= 0.0:
                return
            weighted = [(k, w / total) for k, w in items]
        else:
            keys = list(resources)
            if not keys:
                return
            weighted = [(k, 1.0 / len(keys)) for k in keys]
        for k, w in weighted:
            ent = self._resource_err.setdefault(k, [0.0, 0.0])
            ent[1] += w
            ent[0] += w * (rel_err - ent[0]) / ent[1]

    def _count(self, name: str, help: str = "") -> None:
        if self.registry is not None:
            self.registry.counter(name, help=help).inc()

    def _event(self, model, key, predicted, realized, rel_err) -> None:
        if self.tracer is not None:
            self.tracer.event(
                "prediction.audit", cat="audit", model=model,
                key=str(key), predicted=predicted, realized=realized,
                rel_err=rel_err, matched=predicted is not None)

    # ------------------------------------------------------------------ #
    # queries                                                            #
    # ------------------------------------------------------------------ #
    def models(self) -> List[str]:
        return sorted(self._records)

    def records(self, model: str) -> List[PredictionRecord]:
        return list(self._records.get(str(model), ()))

    def rel_errors(self, model: str,
                   last: Optional[int] = None) -> List[float]:
        errs = [r.rel_err for r in self._records.get(str(model), ())
                if r.rel_err is not None]
        return errs[-last:] if last else errs

    def p95_abs_rel_err(self, model: str,
                        last: Optional[int] = None) -> Optional[float]:
        errs = sorted(abs(e) for e in self.rel_errors(model, last))
        if not errs:
            return None
        rank = 0.95 * (len(errs) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(errs) - 1)
        frac = rank - lo
        return errs[lo] * (1.0 - frac) + errs[hi] * frac

    def set_model_tolerance(self, model: str, tolerance: float) -> None:
        if not tolerance > 0.0:
            raise ValueError("model tolerance must be positive")
        self.model_tolerance[str(model)] = float(tolerance)

    def accuracy(self, model: str,
                 tolerance: Optional[float] = None) -> Optional[float]:
        """Fraction of joined predictions within ``tolerance`` relative
        error (None before the first joinable residual).  The tolerance
        defaults to the model's registered override, then the global."""
        if tolerance is None:
            tol = self.model_tolerance.get(str(model), self.tolerance)
        else:
            tol = float(tolerance)
        errs = self.rel_errors(model)
        if not errs:
            return None
        return sum(1 for e in errs if abs(e) <= tol) / len(errs)

    def resource_bias(self) -> Dict[ResourceKey, float]:
        """Mean signed relative error attributed per resource."""
        return {k: v[0] for k, v in self._resource_err.items()
                if v[1] > 0.0}

    def drifting(self) -> List[str]:
        return sorted(m for m, d in self._drift.items() if d.drifting)

    # ------------------------------------------------------------------ #
    # export                                                             #
    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        """Flat numeric summary (telemetry / gauge publication)."""
        out: Dict[str, float] = {
            "audit.predictions": float(self.predictions),
            "audit.matched": float(self.matched),
            "audit.unmatched": float(self.unmatched),
            "audit.pending": float(len(self._pending)),
            "audit.duplicates": float(self.duplicates),
            "audit.zero_predicted": float(self.zero_predicted),
        }
        for model in self.models():
            errs = self.rel_errors(model)
            if errs:
                p95 = self.p95_abs_rel_err(model)
                out[f"audit.{model}.p95_rel_err"] = float(p95)
                out[f"audit.{model}.joins"] = float(len(errs))
                acc = self.accuracy(model)
                if acc is not None:
                    out[f"prediction.accuracy.{model}"] = float(acc)
            det = self._drift.get(model)
            if det is not None:
                out[f"audit.{model}.drift_fires"] = float(det.fires)
        return out

    def report(self) -> Dict[str, Any]:
        """JSON-able residual report (the ``--audit-out`` artifact)."""
        models: Dict[str, Any] = {}
        for model in self.models():
            errs = self.rel_errors(model)
            det = self._drift.get(model)
            models[model] = {
                "joins": len(self._records.get(model, ())),
                "residuals": len(errs),
                "p50_rel_err": self._quantile(errs, 0.50),
                "p95_rel_err": self.p95_abs_rel_err(model),
                "mean_rel_err": (sum(errs) / len(errs)) if errs else None,
                "accuracy": self.accuracy(model),
                "drifting": bool(det.drifting) if det else False,
                "drift_fires": det.fires if det else 0,
            }
        return {
            "tolerance": self.tolerance,
            "model_tolerance": dict(self.model_tolerance),
            "drift_bound": self._drift_bound,
            "totals": {
                "predictions": self.predictions,
                "matched": self.matched,
                "unmatched": self.unmatched,
                "pending": len(self._pending),
                "duplicates": self.duplicates,
                "zero_predicted": self.zero_predicted,
                "expired": self.expired,
            },
            "models": models,
            "resource_bias": {str(k): v for k, v
                              in sorted(self.resource_bias().items(),
                                        key=lambda kv: str(kv[0]))},
        }

    @staticmethod
    def _quantile(errs: List[float], q: float) -> Optional[float]:
        vals = sorted(abs(e) for e in errs)
        if not vals:
            return None
        rank = q * (len(vals) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac
