"""PyTorch-port copy of ``repro.cluster.router`` (framework-free).

Topology-aware session router for the multi-host serving plane.

The front-end decision the paper's capacity story implies: a session's
KV cache must *live* somewhere for its whole lifetime, so placement is
a memory-capacity bet, not a load-balancing round-robin.  The router
prices each replica by

* **fast-tier headroom** — how much of the session's KV footprint the
  replica can keep in its fast tier (the dominant term: a session
  spilled to the CXL-class tier pays the Fig.-2 latency delta on every
  decode step), and
* **topology distance** — unloaded ICI path latency from the
  front-end :data:`~repro_torch.topology.builders.ROUTER_NODE` to the
  replica's host, normalized against the farthest replica (the
  tiebreak: prefer close hosts when headroom is comparable).

Baseline policies (``round-robin``, ``random``, ``least-loaded``) ride
the same interface so the bench compares them on equal footing.
"""
from __future__ import annotations

import dataclasses
import random as _random
from typing import Callable, Dict, List, Optional

from ..serving.config import ROUTER_POLICIES, ConfigError

__all__ = ["ReplicaView", "SessionRequest", "SessionRouter"]

# distance weight in fast-tier-fractions: a replica one full
# normalized-distance unit farther must offer 25 points more headroom
# fraction to win — headroom dominates, distance breaks ties
_DISTANCE_WEIGHT = 0.25


@dataclasses.dataclass(frozen=True)
class SessionRequest:
    """What the router knows about a session before placing it."""

    session_id: str
    tenant: str = "serving"
    prompt_tokens: int = 0
    new_tokens: int = 0
    kv_bytes_hint: Optional[int] = None   # est. KV footprint, if known

    @property
    def total_tokens(self) -> int:
        return self.prompt_tokens + self.new_tokens


@dataclasses.dataclass
class ReplicaView:
    """The router's handle on one replica: live headroom + static
    distance.  ``headroom_fn``/``load_fn`` are polled at each routing
    decision so the view never goes stale."""

    name: str
    distance_ns: float = 0.0
    headroom_fn: Callable[[], int] = lambda: 0
    load_fn: Callable[[], int] = lambda: 0
    routed: int = 0               # sessions this router sent here
    # KV bytes routed here but not yet materialized in the pool: the
    # engine only allocates at admission, so batch submissions would
    # all see identical headroom and pile onto one host without this
    pending_bytes: int = 0


class SessionRouter:
    """Places sessions onto replicas under a pluggable policy."""

    def __init__(self, policy: str = "headroom-distance", seed: int = 0):
        if policy not in ROUTER_POLICIES:
            raise ConfigError(
                f"unknown router policy {policy!r}; choose from "
                f"{', '.join(ROUTER_POLICIES)}")
        self.policy = policy
        self._rng = _random.Random(seed)
        self._views: Dict[str, ReplicaView] = {}
        self._rr = 0              # round-robin cursor

    # -- registry ----------------------------------------------------- #
    def register(self, name: str, *, distance_ns: float = 0.0,
                 headroom_fn: Optional[Callable[[], int]] = None,
                 load_fn: Optional[Callable[[], int]] = None) -> None:
        self._views[name] = ReplicaView(
            name, distance_ns=distance_ns,
            headroom_fn=headroom_fn or (lambda: 0),
            load_fn=load_fn or (lambda: 0))

    @property
    def replicas(self) -> List[str]:
        return list(self._views)

    def routed_counts(self) -> Dict[str, int]:
        return {n: v.routed for n, v in self._views.items()}

    # -- policies ----------------------------------------------------- #
    def route(self, req: SessionRequest) -> str:
        """Pick a replica for ``req``.  Never raises for lack of
        headroom: a full cluster still has to put the session
        *somewhere* (the replica's own admission control queues it),
        so zero-headroom falls back to the least-bad replica."""
        if not self._views:
            raise ConfigError("router has no registered replicas")
        views = list(self._views.values())
        if len(views) == 1:
            views[0].routed += 1
            return views[0].name
        pick = {
            "round-robin": self._round_robin,
            "random": self._random_pick,
            "least-loaded": self._least_loaded,
            "headroom-distance": self._headroom_distance,
        }[self.policy](views, req)
        pick.routed += 1
        pick.pending_bytes += req.kv_bytes_hint or 0
        return pick.name

    def drain_pending(self) -> None:
        """Forget in-flight reservations.  Call when routed sessions
        have materialized in their pools (e.g. at plane ``run()``):
        from then on live pool headroom carries the signal and keeping
        the reservation would double-count it."""
        for v in self._views.values():
            v.pending_bytes = 0

    def _round_robin(self, views, req) -> ReplicaView:
        pick = views[self._rr % len(views)]
        self._rr += 1
        return pick

    def _random_pick(self, views, req) -> ReplicaView:
        return self._rng.choice(views)

    def _least_loaded(self, views, req) -> ReplicaView:
        return min(views, key=lambda v: (v.load_fn(), v.distance_ns))

    def _headroom_distance(self, views, req) -> ReplicaView:
        need = req.kv_bytes_hint or 0
        headroom = {v.name: max(0, int(v.headroom_fn())
                                - v.pending_bytes) for v in views}
        max_head = max(headroom.values())
        max_dist = max(v.distance_ns for v in views)
        if max_head <= 0:
            # zero headroom everywhere: degrade to least-loaded so the
            # overload spreads instead of piling onto one replica
            return self._least_loaded(views, req)

        def score(v: ReplicaView) -> float:
            frac = headroom[v.name] / max_head
            dist = (v.distance_ns / max_dist) if max_dist > 0 else 0.0
            s = frac - _DISTANCE_WEIGHT * dist
            if need and headroom[v.name] < need:
                # can't hold the whole session fast: rank below any
                # replica that can, by how much of it would spill
                s -= 1.0 + (need - headroom[v.name]) / need
            return s

        return max(views, key=lambda v: (score(v), -v.distance_ns,
                                         v.name))
