"""The multi-host serving plane: replicas + shared ledger + router
(counterpart of ``repro.cluster.plane``).

:class:`ClusterPlane` composes:

* a :func:`~repro_torch.topology.multi_host_pod` testbed — one global
  inter-host graph for routing, one local graph per replica — built
  from transfer probes of the first device, taken once;
* ``n`` :class:`~repro_torch.cluster.replica.Replica`\\ s, each a
  serving engine on its mesh of ``devices``
  (``cluster.sharding.replica_meshes``), its params split under the
  active axis mapping (``shard_model``), and a pool that registers in
  ONE **shared** :class:`~repro_torch.pool.ResidencyLedger` under its
  ``<replica>/<tenant>`` namespace.  With fewer devices than replicas
  they share a device and its weights, each with its own paged pool;
  ``devices`` may name one card several times (logical devices);
* a :class:`~repro_torch.cluster.router.SessionRouter` placing sessions
  by fast-tier headroom and front-end distance;
* a plane-level :class:`~repro_torch.pool.TierBudgetArbiter` carrying
  ``replica_capacity`` — budget splits water-fill across replica
  groups first (a tenant on host A can never be granted host B's
  memory), then per-tenant within each group.

The invariant: per-replica ledger namespaces sum exactly to the
``*/*`` global aggregate — occupancy is conserved across the namespace
scheme, with no double counting and no leakage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..obs import MetricsRegistry, TraceRecorder
from ..pool import ResidencyLedger, TierBudgetArbiter
from ..serving import ServingConfig
from ..serving.kv_pool import FAST_KIND
from ..topology import (ClusterTestbed, H100_KINDS, multi_host_pod,
                        ROUTER_NODE)
from .replica import Replica
from .router import SessionRequest, SessionRouter
from .sharding import replica_meshes

__all__ = ["ClusterPlane", "ClusterReport"]


@dataclasses.dataclass
class ClusterReport:
    """Aggregate + per-replica outcome of one plane run."""

    summary: Dict[str, float]
    per_replica: Dict[str, object]        # replica -> ServingReport
    routed: Dict[str, int]                # replica -> sessions routed

    def aggregate_throughput(self) -> float:
        return self.summary.get("throughput_tok_s", 0.0)


class ClusterPlane:
    """Front-end + replicas over one shared, namespaced ledger, on
    ``devices`` (every CUDA device by default, as the reference takes
    ``jax.devices()``; entries may repeat a device), replicas run in
    turn; ``shard_model`` splits each replica's params under the active
    axis mapping."""

    def __init__(self, cfg, params,
                 serving: Optional[ServingConfig] = None,
                 n_replicas: int = 2,
                 router_policy: str = "headroom-distance",
                 testbed: Optional[ClusterTestbed] = None,
                 shard_model: bool = True, seed: int = 0,
                 ledger=None, clock=None,
                 devices: Optional[Sequence] = None):
        meshes = replica_meshes(n_replicas, devices=devices)
        if testbed is None:
            # probe the first device once; every host's testbed shares it
            from ..obs.calibrate import measure_transfer_probes
            testbed = multi_host_pod(n_replicas, probes=(
                measure_transfer_probes(kinds=H100_KINDS,
                                        device=meshes[0].first_device)))
        if len(testbed.hosts) < n_replicas:
            raise ValueError(
                f"testbed has {len(testbed.hosts)} hosts for "
                f"{n_replicas} replicas")
        self.testbed = testbed
        self.ledger = ledger if ledger is not None else ResidencyLedger()
        self.registry = MetricsRegistry()
        self.tracer = TraceRecorder()
        self.replicas: Dict[str, Replica] = {}
        for host, mesh in zip(testbed.hosts, meshes):
            self.replicas[host] = Replica(
                host, cfg, params, serving=serving, mesh=mesh,
                ledger=self.ledger, host=host,
                testbed=testbed.replicas.get(host),
                shard_model=shard_model, clock=clock)
        self.router = SessionRouter(router_policy, seed=seed)
        for host, rep in self.replicas.items():
            self.router.register(
                host,
                distance_ns=testbed.distance_ns(ROUTER_NODE, host),
                headroom_fn=rep.fast_headroom_bytes,
                load_fn=rep.active_sessions)
        # plane arbiter: global fast capacity split across replica
        # groups first, then per tenant — per-replica physical limits
        # are what make the hierarchical water-fill non-degenerate
        cap = {h: r.engine.pool.fast_block_budget
               * r.engine.pool.block_nbytes()
               for h, r in self.replicas.items()}
        self.replica_fast_bytes = cap
        self.arbiter = TierBudgetArbiter(
            self.ledger, FAST_KIND,
            capacity_bytes=sum(cap.values()),
            replica_capacity=cap, tracer=self.tracer)
        self._next_sid = 0

    # -- session intake ----------------------------------------------- #
    def _kv_bytes_hint(self, replica: Replica, total_tokens: int) -> int:
        pool = replica.engine.pool
        return pool.blocks_for_tokens(total_tokens) * pool.block_nbytes()

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               arrival_s: float = 0.0, priority: float = 0.0,
               tenant: str = "serving",
               session_id: Optional[str] = None) -> str:
        """Route one session and queue it on the chosen replica.
        Returns ``"<replica>:<rid>"`` so callers can find it again."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        sid = session_id or f"s{self._next_sid}"
        self._next_sid += 1
        any_rep = next(iter(self.replicas.values()))
        req = SessionRequest(
            session_id=sid, tenant=tenant,
            prompt_tokens=int(prompt.shape[0]),
            new_tokens=int(max_new_tokens),
            kv_bytes_hint=self._kv_bytes_hint(
                any_rep, prompt.shape[0] + max_new_tokens))
        target = self.router.route(req)
        rid = self.replicas[target].submit(
            prompt, max_new_tokens, arrival_s=arrival_s,
            priority=priority)
        self.tracer.event("cluster.route", cat="cluster", tid=target,
                          session=sid, replica=target,
                          prompt_tokens=req.prompt_tokens,
                          kv_bytes_hint=req.kv_bytes_hint)
        return f"{target}:{rid}"

    # -- execution ----------------------------------------------------- #
    def run(self, max_iterations: int = 10_000) -> ClusterReport:
        """Drive every replica's trace to completion.

        Replicas are simulated hosts in one process, so they run
        sequentially here; their engines keep independent clocks, so
        per-replica latency statistics are unaffected by the
        serialization.
        """
        self.router.drain_pending()
        reports = {}
        for host in self.testbed.hosts:
            rep = self.replicas[host]
            if rep.engine.sched.active:
                reports[host] = rep.run(max_iterations=max_iterations)
        agg: Dict[str, float] = {
            "replicas": float(len(self.replicas)),
            "throughput_tok_s": 0.0, "decode_tokens": 0.0,
            "requests": 0.0, "finished": 0.0, "preemptions": 0.0,
        }
        worst_p95 = 0.0
        for host, rp in reports.items():
            s = rp.summary
            for k in ("throughput_tok_s", "decode_tokens", "requests",
                      "finished", "preemptions"):
                agg[k] += s.get(k, 0.0)
            worst_p95 = max(worst_p95, s.get("p95_latency_s", 0.0))
        agg["worst_p95_latency_s"] = worst_p95
        self.publish()
        return ClusterReport(summary=agg, per_replica=reports,
                             routed=self.router.routed_counts())

    # -- observability ------------------------------------------------- #
    def publish(self, registry: Optional[MetricsRegistry] = None) -> int:
        """Publish plane state: per-replica gauges under
        ``cluster.<replica>.*`` plus the shared ledger (whose tenant
        gauges already carry ``<replica>/<tenant>`` names)."""
        reg = registry or self.registry
        n = 0
        for host, rep in self.replicas.items():
            n += reg.set_gauges(
                {"fast_headroom_bytes": rep.fast_headroom_bytes(),
                 "active_sessions": rep.active_sessions(),
                 "routed_sessions": self.router.routed_counts()[host],
                 "distance_ns": self.testbed.distance_ns(
                     ROUTER_NODE, host)},
                prefix=f"cluster.{host}")
        n += self.ledger.publish(reg)
        return n

    def merged_trace(self) -> List:
        """All replica control-plane events plus the plane's own, as
        one list: plane events first, then each replica's events in
        host order with ``tid`` prefixed ``<replica>/``.

        Events are concatenated per replica, NOT interleaved by
        timestamp: :func:`repro_torch.obs.qos_chains` pairs a violation
        with the blame event that *follows it in sequence*, so
        per-replica ordering must survive the merge for chains to
        reconstruct.  The replicas' hot-path spans (``trace_spans``)
        follow every control-plane event, in the same host order.
        """
        out = list(self.tracer.events)
        for ring in ("events", "spans"):
            for host in self.testbed.hosts:
                for ev in getattr(self.replicas[host].engine.tracer, ring):
                    out.append(dataclasses.replace(
                        ev, tid=f"{host}/{ev.tid}"))
        return out

    # -- namespace invariant ------------------------------------------ #
    def namespace_conservation(self, tier: str = FAST_KIND
                               ) -> Dict[str, int]:
        """Per-replica ledger bytes plus the global aggregate — the
        acceptance invariant: values sum exactly to ``*/*``."""
        per = {h: self.ledger.bytes_on(tier, f"{h}/*")
               for h in self.replicas}
        per["total"] = self.ledger.bytes_on(tier, "*/*")
        return per
