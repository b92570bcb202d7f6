"""One replica of the multi-host serving plane (counterpart of
``repro.cluster.replica``).

A :class:`Replica` owns the full single-host serving stack: params
placed on its own device mesh (split under the active axis mapping, or
replicated), a :class:`~repro_torch.serving.ServingEngine` that
computes on the mesh's first device and keeps its paged KV pool there
(the engine's ``device`` takes the place of the reference's
mesh-placed ``pool_sharding``), and a local topology testbed.

The ownership boundary the namespace scheme encodes: everything the
replica allocates registers in the **shared** residency ledger under
``<replica>/<tenant>`` keys, so the cluster arbiter and the blame
plane see per-replica occupancy without the replica knowing it has
siblings.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..launch.mesh import Mesh
from ..serving import ServingConfig, ServingEngine
from ..serving.kv_pool import FAST_KIND
from .namespace import Namespace
from .sharding import AxisMapping, current_axis_mapping, shard_lm_params

__all__ = ["Replica"]


class Replica:
    """A serving engine on its replica mesh, registered under its
    namespace.  ``shard_model``: split the params under the active axis
    mapping (else replicate them).  Without a mesh the engine runs on
    CUDA and takes ``params`` as they are."""

    def __init__(self, name: str, cfg, params,
                 serving: Optional[ServingConfig] = None,
                 mesh: Optional[Mesh] = None, ledger=None,
                 host: Optional[str] = None, testbed=None,
                 shard_model: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        self.name = name
        self.host = host or name
        self.mesh = mesh
        sv = dataclasses.replace(serving) if serving is not None \
            else ServingConfig()
        # the one rename that makes multi-replica ledgers work: this
        # engine's tenant becomes "<replica>/<tenant>" in the shared
        # ledger, short-form-printable and glob-aggregatable
        base = Namespace.of(sv.tenant or "serving")
        self.ns = Namespace(replica=name, tenant=base.tenant)
        sv.tenant = str(self.ns)
        device = None
        if mesh is not None:
            device = mesh.first_device
            params = shard_lm_params(
                params, mesh,
                current_axis_mapping() if shard_model else AxisMapping())
        self.params = params
        self.engine = ServingEngine(
            cfg, params, serving=sv, clock=clock or time.perf_counter,
            ledger=ledger, device=device)
        if testbed is not None and self.engine.topo is None:
            # adopt the cluster's per-replica local graph so the
            # migration executor / replanner price over its links
            topo = testbed.graph
            topo.alias_tier(testbed.fast, FAST_KIND)
            topo.alias_tier(testbed.capacity_tier,
                            self.engine.pool.slow_kind)
            self.engine.topo = topo
        self.testbed = testbed

    # -- the router's live signals ------------------------------------ #
    def fast_headroom_bytes(self) -> int:
        """Unused fast-tier capacity — the router's dominant term."""
        pool = self.engine.pool
        free = max(0, pool.fast_block_budget - pool.fast_used())
        return free * pool.block_nbytes()

    def active_sessions(self) -> int:
        sched = self.engine.sched
        return len(sched.running) + len(sched.waiting)

    # -- serving pass-throughs ---------------------------------------- #
    def submit(self, prompt, max_new_tokens: int,
               arrival_s: float = 0.0, priority: float = 0.0) -> int:
        return self.engine.submit(prompt, max_new_tokens,
                                  arrival_s=arrival_s, priority=priority)

    def run(self, max_iterations: int = 10_000):
        return self.engine.run(max_iterations=max_iterations)

    def __repr__(self) -> str:
        nd = self.mesh.devices.size if self.mesh is not None else 0
        return (f"Replica({self.name!r}, ns={str(self.ns)!r}, "
                f"mesh_devices={nd})")
