"""PyTorch-port copy of ``repro.serving.expert_pool`` (framework-free;
the fast set is built once per step, where the reference rebuilds it
per candidate).

ExpertPool: MoE expert weights as first-class tiered objects.

The MoE configs' expert stores dwarf the KV cache (qwen3-moe-30b keeps
128 experts x 48 layers of FFN weight), yet decode activates only
``top_k`` experts per token — exactly the working-set shape the paper's
tiering study rewards: a small hot set earning fast residency while the
cold majority lives on the CXL-class capacity tier.  This module gives
every (layer, expert) weight block the same citizenship KV blocks have:

  * residency is recorded in the shared ``ResidencyLedger`` under the
    pool's tenant namespace, promotions gated by ``can_place`` against
    the arbitrated fast-tier budget;
  * routing decisions feed per-expert heat into an ``AccessTrace``
    (one read event per activation, sized at the expert's weight
    bytes), so phase detection sees expert traffic the same way it
    sees KV traffic;
  * promote/demote deltas flow through the cross-tenant
    ``MoveScheduler`` when one is attached (coalesced, priority-ordered
    and fluid-scheduled with everyone else's moves), falling back to
    direct ledger moves otherwise;
  * the ``predictive`` policy reuses the PR 5 phase machinery: a
    per-recurrence-signature expert-heat table (the expert-level
    ``PhaseDemandTable``) learns which experts each recurring routing
    phase activates, and when the ``PhaseDetector`` predicts a
    *different* signature for the next epoch, that phase's hot experts
    are promoted during the current epoch's slack — so a recurring
    routing burst's first tokens find their experts already fast.

Prefetch efficacy is first-class telemetry: ``prefetch_promotes``
counts experts promoted ahead of a predicted phase, ``prefetch_hits``
how many were then actually routed to while still fast — their ratio
is the bench's ``moe.prefetch_hit_ratio`` headline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from ..core.migration import BlockMove, PlacementDelta
from ..telemetry import AccessTrace, PhaseDetector
from .kv_pool import FAST_KIND

ExpertKey = Tuple[int, int]            # (global moe-layer index, expert)


@dataclasses.dataclass
class ExpertCounters:
    accesses: int = 0          # expert activations observed
    fast_hits: int = 0         # activation found the expert fast-resident
    promoted: int = 0
    demoted: int = 0
    prefetch_promotes: int = 0  # promotions issued for a predicted phase
    prefetch_hits: int = 0      # prefetched experts routed to while fast


class ExpertPool:
    """Tier residency + heat + predictive prefetch for MoE experts.

    ``n_layers`` is the number of MoE layers (global, across units);
    ``fast_expert_budget`` how many experts may be fast-resident at
    once; ``policy`` is ``"lru"`` (recency earns fast residency — the
    expert-cache baseline) or ``"predictive"`` (recency plus
    next-phase prefetch from the signature heat table).
    """

    def __init__(self, n_layers: int, n_experts: int, expert_nbytes: int,
                 *, fast_expert_budget: int, policy: str = "lru",
                 ledger=None, tenant: str = "experts",
                 slow_kind: str = "pinned_host",
                 movesched=None, move_priority: Optional[float] = None,
                 tracer=None, heat_alpha: float = 0.5,
                 max_signatures: int = 32):
        if policy not in ("lru", "predictive"):
            raise ValueError(f"unknown expert policy {policy!r}")
        if n_layers <= 0 or n_experts <= 0:
            raise ValueError("n_layers and n_experts must be positive")
        if expert_nbytes <= 0:
            raise ValueError("expert_nbytes must be positive")
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.expert_nbytes = int(expert_nbytes)
        self.policy = policy
        self.slow_kind = slow_kind
        self.tenant = tenant
        self.movesched = movesched
        self.move_priority = move_priority
        self.tracer = tracer
        from ..pool.ledger import ResidencyLedger
        self.ledger = ledger if ledger is not None else ResidencyLedger()
        self.ledger.register_tenant(tenant)
        self.fast_expert_budget = max(int(fast_expert_budget), 1)
        self.ledger.set_budget(tenant, FAST_KIND,
                               self.fast_expert_budget
                               * self.expert_nbytes)
        # every expert starts on the capacity tier
        self.kinds: Dict[ExpertKey, str] = {}
        for l in range(n_layers):
            for e in range(n_experts):
                key = (l, e)
                self.kinds[key] = slow_kind
                self.ledger.record_alloc(tenant, self._obj(key),
                                         slow_kind, self.expert_nbytes)
        # heat: activation recency/frequency + the expert-level access
        # trace the phase detector watches
        self.trace = AccessTrace()
        self.phases = PhaseDetector(self.trace)
        self.last_step: Dict[ExpertKey, int] = {}
        self.touch_count: Dict[ExpertKey, int] = {}
        self.counters = ExpertCounters()
        self._epoch_counts: Dict[ExpertKey, int] = {}
        self._epoch_slow_bytes = 0
        self._last_slow_bytes = 0          # last closed epoch's misses
        self._last_prefetch_bytes = 0
        # signature -> {expert: EMA activation share} (the expert-level
        # PhaseDemandTable), TTL/size-bounded like the arbiter's
        self.heat_alpha = float(heat_alpha)
        self.max_signatures = int(max_signatures)
        self._sig_heat: Dict[Hashable, Dict[ExpertKey, float]] = {}
        self._sig_seen: Dict[Hashable, int] = {}
        self._prefetched: set = set()      # promoted-ahead, not yet hit

    # ------------------------------------------------------------------ #
    @staticmethod
    def _obj(key: ExpertKey) -> str:
        return f"expert.L{key[0]}.E{key[1]}"

    def kind_of(self, layer: int, expert: int) -> str:
        return self.kinds[(layer, expert)]

    def fast_residents(self) -> int:
        return sum(1 for k in self.kinds.values() if k == FAST_KIND)

    def fast_hit_ratio(self) -> Optional[float]:
        if self.counters.accesses == 0:
            return None
        return self.counters.fast_hits / self.counters.accesses

    def prefetch_hit_ratio(self) -> Optional[float]:
        if self.counters.prefetch_promotes == 0:
            return None
        return (self.counters.prefetch_hits
                / self.counters.prefetch_promotes)

    # ------------------------------------------------------------------ #
    # heat (routing decisions)                                           #
    # ------------------------------------------------------------------ #
    def record_routing(self, layer: int, expert_ids: Sequence[int],
                       step: int) -> None:
        """Account one decode step's routed experts for one MoE layer.

        Each activation reads the expert's weight block once; slow-
        resident activations are the misses the tier link pays for.
        """
        c = self.counters
        for e in expert_ids:
            key = (int(layer), int(e))
            kind = self.kinds[key]
            c.accesses += 1
            if kind == FAST_KIND:
                c.fast_hits += 1
                if key in self._prefetched:
                    c.prefetch_hits += 1
                    self._prefetched.discard(key)
            else:
                self._epoch_slow_bytes += self.expert_nbytes
            self.last_step[key] = step
            self.touch_count[key] = self.touch_count.get(key, 0) + 1
            self._epoch_counts[key] = self._epoch_counts.get(key, 0) + 1
            self.trace.observe(self._obj(key),
                               read_bytes=self.expert_nbytes,
                               phase="decode")

    # ------------------------------------------------------------------ #
    # per-epoch policy step                                              #
    # ------------------------------------------------------------------ #
    def _observe_signature_heat(self, counts: Dict[ExpertKey, int],
                                epoch: int) -> None:
        sig = self.phases.signature
        if sig is None or not counts:
            return
        total = float(sum(counts.values()))
        heat = self._sig_heat.setdefault(sig, {})
        a = self.heat_alpha
        shares = {k: n / total for k, n in counts.items()}
        for k in set(heat) | set(shares):
            heat[k] = heat.get(k, 0.0) + a * (shares.get(k, 0.0)
                                              - heat.get(k, 0.0))
            if heat[k] < 1e-6:
                del heat[k]
        self._sig_seen[sig] = epoch
        if len(self._sig_heat) > self.max_signatures:
            stale = sorted(self._sig_seen, key=self._sig_seen.get)
            for s in stale[: len(self._sig_heat)
                           - self.max_signatures]:
                self._sig_heat.pop(s, None)
                self._sig_seen.pop(s, None)

    def _lru_ranking(self) -> List[ExpertKey]:
        """Every expert ever touched, most recently active first."""
        return sorted(self.last_step,
                      key=lambda k: (-self.last_step[k], k))

    def _predicted_hot(self, epoch: int) -> List[ExpertKey]:
        """Hot experts of the *predicted next* phase (empty when the
        prediction is 'more of the same' or the phase is unknown)."""
        sig = self.phases.signature
        nxt = self.phases.expected_signature(1)
        if nxt is None or nxt == sig:
            return []
        heat = self._sig_heat.get(nxt)
        if not heat:
            return []
        return sorted(heat, key=lambda k: (-heat[k], k))

    def step(self, epoch: int) -> None:
        """Close the epoch: fold heat into the signature table, pick the
        desired fast set, and run the promote/demote delta through the
        move scheduler."""
        counts = self._epoch_counts
        self._epoch_counts = {}
        self._last_slow_bytes = self._epoch_slow_bytes
        self._epoch_slow_bytes = 0
        self.trace.advance_epoch()
        self.phases.update()
        self._observe_signature_heat(counts, epoch)

        budget = self.fast_expert_budget
        prefetch_keys: List[ExpertKey] = []
        if self.policy == "predictive":
            predicted = self._predicted_hot(epoch)
            # the predicted phase's experts take the front of the fast
            # set; present-epoch recency fills whatever is left
            desired = list(predicted[:budget])
            taken = set(desired)
            for k in self._lru_ranking():
                if len(desired) >= budget:
                    break
                if k not in taken:
                    desired.append(k)
                    taken.add(k)
            prefetch_keys = [k for k in predicted[:budget]
                             if self.kinds[k] != FAST_KIND]
        else:
            desired = self._lru_ranking()[:budget]
        desired_set = set(desired)

        fast = [k for k, kind in self.kinds.items() if kind == FAST_KIND]
        fast_set = set(fast)
        to_promote = [k for k in desired if k not in fast_set]
        # demote only to make room: coldest fast residents outside the
        # desired set go first
        overflow = len(fast) + len(to_promote) - budget
        to_demote: List[ExpertKey] = []
        if overflow > 0:
            evictable = sorted(
                (k for k in fast if k not in desired_set),
                key=lambda k: (self.last_step.get(k, -1), k))
            to_demote = evictable[:overflow]

        moves = [BlockMove(self._obj(k), FAST_KIND, self.slow_kind,
                           self.expert_nbytes) for k in to_demote]
        moves += [BlockMove(self._obj(k), self.slow_kind, FAST_KIND,
                            self.expert_nbytes) for k in to_promote]
        if moves:
            self._pending_prefetch = set(prefetch_keys)
            delta = PlacementDelta(moves)
            if self.movesched is not None:
                self.movesched.submit(self.tenant, delta,
                                      move_fn=self._apply_move,
                                      priority=self.move_priority)
                self.movesched.flush(epoch=epoch)
            else:
                for m in delta.moves:
                    self._apply_move(m.obj, m.src, m.dst, m.nbytes)
        n_prefetched = sum(1 for k in prefetch_keys
                           if self.kinds[k] == FAST_KIND)
        self.counters.prefetch_promotes += n_prefetched
        self._prefetched.update(k for k in prefetch_keys
                                if self.kinds[k] == FAST_KIND)
        self._last_prefetch_bytes = n_prefetched * self.expert_nbytes
        if self.tracer is not None and (to_promote or to_demote):
            self.tracer.event(
                "expert.rebalance", cat="expert", epoch=epoch,
                promoted=len(to_promote), demoted=len(to_demote),
                prefetched=n_prefetched,
                fast_residents=self.fast_residents())

    def _parse(self, obj: str) -> Optional[ExpertKey]:
        try:
            l, e = obj.split(".")[1:3]
            return (int(l[1:]), int(e[1:]))
        except (ValueError, IndexError):
            return None

    def _apply_move(self, obj: str, src: str, dst: str,
                    nbytes: int) -> int:
        """MoveScheduler move_fn: one expert's ledger-gated tier move."""
        key = self._parse(obj)
        if key is None or self.kinds.get(key) != src:
            return 0
        if dst == FAST_KIND and not self.ledger.can_place(
                self.tenant, FAST_KIND, nbytes):
            return 0
        self.ledger.record_move(self.tenant, obj, src, dst, nbytes)
        self.kinds[key] = dst
        if dst == FAST_KIND:
            self.counters.promoted += 1
        else:
            self.counters.demoted += 1
            self._prefetched.discard(key)   # unused prefetch = a miss
        return nbytes

    # ------------------------------------------------------------------ #
    # QoS flow publication                                               #
    # ------------------------------------------------------------------ #
    def gather_flows(self, topology, period_s: float = 0.05,
                     cls: str = "read") -> List:
        """Class-tagged expert-gather flows for the contention plane.

        One ``cls`` flow for the last epoch's slow-resident expert
        reads (decode stalls on these), plus a ``prefetch`` flow for
        promoted-ahead bytes — so the blame ledger can tell a victim's
        demand reads from this tenant's optional prefetch traffic.
        """
        if topology is None:
            return []
        from ..topology import Flow
        src = topology.node_of(self.slow_kind)
        dst = topology.node_of(FAST_KIND)
        if src is None or dst is None or src == dst:
            return []
        flows = []
        if self._last_slow_bytes > 0:
            flows.append(Flow(src, dst,
                              self._last_slow_bytes / period_s / 1e9,
                              cls=cls, tenant=self.tenant))
        if self._last_prefetch_bytes > 0:
            flows.append(Flow(src, dst,
                              self._last_prefetch_bytes / period_s / 1e9,
                              cls="prefetch", tenant=self.tenant))
        return flows

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        c = self.counters
        out = {
            "expert.accesses": float(c.accesses),
            "expert.fast_hits": float(c.fast_hits),
            "expert.promoted": float(c.promoted),
            "expert.demoted": float(c.demoted),
            "expert.prefetch_promotes": float(c.prefetch_promotes),
            "expert.prefetch_hits": float(c.prefetch_hits),
            "expert.fast_residents": float(self.fast_residents()),
        }
        r = self.fast_hit_ratio()
        if r is not None:
            out["expert.fast_hit_ratio"] = r
        r = self.prefetch_hit_ratio()
        if r is not None:
            out["expert.prefetch_hit_ratio"] = r
        return out


def expert_nbytes_from_config(cfg) -> int:
    """Weight bytes of ONE expert's FFN block (gate+up+down, bf16)."""
    mats = 3 if cfg.act == "silu" else 2
    return mats * cfg.d_model * cfg.d_ff * 2


def moe_layers_from_config(cfg) -> int:
    """Global count of MoE layers (units x per-unit MoE specs)."""
    per_unit = sum(1 for s in cfg.pattern if s.moe)
    return cfg.n_units * per_unit
