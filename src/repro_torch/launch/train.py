"""Training CLI of the port: config-driven, checkpointed, with adaptive
optimizer-state placement, on CUDA unless ``--device cpu``
(counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 50 --ckpt-dir /tmp/ck --device cpu

``--adaptive`` records the per-phase traffic of every step, re-plans the
placement of the fp32 optimizer state (Adam master, m, v) online, and
moves it for real through a ``pool.TieredStateStore``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --smoke --steps 6 --adaptive --replan-every 2 --device cpu

Without ``--topology`` the replanner plans over two tiers built from
transfer probes of this machine (``probed_train_tiers``): HBM (the
device kind) and HOST (page-locked host memory), with the card's and
the host's memory as capacities.  ``--topology h100-node`` plans over
the card's testbed (rates probed on it), and the paper's testbeds are
there too.  ``--ckpt-dir`` writes checkpoints in the reference's format
(``checkpoint.store``) and resumes from the latest one.

The train step is ``launch.steps.make_train_step`` with the plain AdamW
and the plain ``chunked_attention``, as the reference's is: this path
launches no hand-written kernel.  ``--mesh`` places the parameters and
the optimizer state as the reference does (``launch.mesh``,
``models.shardings.param_pspecs``, ``to_named``: FSDP over ``data``, TP
over ``model``), the batch splits over the data axes, and a checkpoint
restores onto whatever mesh is given (elastic).  One process drives the
whole mesh.  ``run(args, devices=...)`` lays the mesh over a list of
devices, which may name one device several times (logical devices):

    run(parse_args(["--arch", "llama3-8b", "--smoke", "--mesh", "2x4",
                    "--device", "cpu"]), devices=["cpu"] * 8)

Without ``devices`` a mesh needs as many devices as it has entries, as
the reference's does, and raises naming
``launch.mesh.MULTI_DEVICE_ITEM`` where the machine has fewer.
``--adaptive`` on a mesh of more than one device raises, as the
reference's fails there (``SPLIT_ADAPTIVE_FAULT``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch
import torch.utils._pytree as pytree

from ..checkpoint import store
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.migration import MigrationExecutor
from ..core.tiered_array import DeviceLike, resolve_device
from ..core.tiers import GiB, MemoryTier
from ..data.pipeline import DataConfig, DataIterator
from ..models import lm, psharding as PS, shardings as sh
from ..obs import (BlameLedger, CostModelCalibrator, measure_transfer_probes,
                   MetricsRegistry, PredictionLedger, probed_kind_bases,
                   TierProbe, TraceRecorder)
from ..offload.train_engine import emit_step_traffic
from ..optim import AdamConfig, init_state, init_state_shapes
from ..pool import ResidencyLedger, TieredStateStore
from ..telemetry import (AccessSampler, AccessTrace, AdaptiveReplanner,
                         PhaseDetector, ReplanConfig, SamplerConfig)
from ..topology import build_topology, Flow, TOPOLOGY_CHOICES
from . import steps as steps_mod
from .mesh import dp_axes, make_mesh, Mesh, MULTI_DEVICE_ITEM

# what --adaptive on a mesh of more than one device raises with: the
# reference's launcher fails there (its TieredStateStore puts pinned-host
# blocks beside device-sharded ones), and the port keeps the failure
SPLIT_ADAPTIVE_FAULT = ("ROADMAP section 3, faults of the reference the "
                        "port keeps: --adaptive under a split mesh")


def parse_mesh(spec: str, device: DeviceLike = None,
               devices=None) -> Mesh:
    """The ``--mesh`` spec as a mesh, the reference's axis names, over
    ``devices`` (a list, which may repeat a device) or, without it,
    ``device`` on the CPU and every CUDA device otherwise.  A mesh of
    more entries than there are devices raises ``ValueError``, naming
    the ROADMAP item that runs over several physical devices."""
    dims = tuple(int(x) for x in spec.split("x"))
    axes = {1: ("model",), 2: ("data", "model"),
            3: ("pod", "data", "model")}.get(len(dims))
    if axes is None:
        raise ValueError(f"--mesh {spec!r}: give 1 to 3 axis sizes")
    if devices is None:
        dev = resolve_device(device)
        devices = [dev] if dev.type == "cpu" else None
    try:
        return make_mesh(dims, axes, devices=devices)
    except ValueError as e:
        raise ValueError(f"--mesh {spec}: {e} ({MULTI_DEVICE_ITEM})") \
            from e


def _capacities(device: DeviceLike) -> Dict[str, int]:
    """Bytes of the device's memory and of the host's."""
    dev = resolve_device(device)
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    card = (torch.cuda.get_device_properties(dev).total_memory
            if dev.type == "cuda" else host)
    return {"device": card, "host": host}


def probed_train_tiers(device: DeviceLike) -> Dict[str, MemoryTier]:
    """The two tiers the adaptive launcher plans over without a
    topology: HBM (the device kind) and HOST (page-locked host memory),
    built from transfer probes of ``device`` (``obs.probed_kind_bases``),
    with the card's memory and the host's as capacities.  Under a CPU
    engine both are logical CPU memory."""
    base = probed_kind_bases(("device", "pinned_host"), device)
    cap = _capacities(device)
    return {"HBM": dataclasses.replace(base["device"], name="HBM",
                                       capacity_GiB=cap["device"] / GiB),
            "HOST": dataclasses.replace(base["pinned_host"], name="HOST",
                                        capacity_GiB=cap["host"] / GiB)}


class _TrainTelemetry:
    """Telemetry + placement sidecar for the training loop (--adaptive).

    Records the step's per-phase traffic (params fwd/bwd, grad transfer,
    optimizer sweep over the fp32 state) through a sampling front-end,
    runs phase detection, and periodically re-plans the training-state
    placement from the *measured* traffic, printing every
    costmodel-gated decision.

    The fp32 optimizer state (Adam master/m/v) is mirrored into a
    ``TieredStateStore`` registered under the ``tenant`` namespace of a
    ``ResidencyLedger``, and the replanner's ``MigrationExecutor``
    executes applied deltas through the store's ``move_fn``: real block
    copies between memory kinds, refreshed with the live optimizer
    values right before each due replan and recorded in the ledger.
    """

    OPT_OBJ = "opt_state_fp32"

    def __init__(self, params, opt, replan_every: int, sample_rate: float,
                 topology: str = None, tenant: str = "train",
                 predictive: bool = False, calibrate: bool = False,
                 device: DeviceLike = None):
        self.trace = AccessTrace()
        self.sampler = AccessSampler(
            self.trace, SamplerConfig(sample_rate=sample_rate))
        self.phases = PhaseDetector(self.trace)
        # observability plane: control-plane trace (step-indexed clock —
        # the loop drives epochs, not wall time) + metrics registry
        self._epoch = 0
        self.tracer = TraceRecorder(clock=lambda: float(self._epoch))
        self.registry = MetricsRegistry()
        graph, fast = None, "HBM"
        if topology:
            tb = build_topology(topology, device=device)
            graph, fast = tb.graph, tb.fast
            tiers = {k: v for k, v in tb.tiers.items()
                     if v.kind != "nvme"}
            if any(t.capacity_GiB <= 0 for t in tiers.values()):
                # a testbed built from probes carries no capacities:
                # the card's memory and the host's
                cap = _capacities(device)
                tiers = {k: v if v.capacity_GiB > 0 else
                         dataclasses.replace(
                             v, capacity_GiB=cap["device" if v.kind == "hbm"
                                                 else "host"] / GiB)
                         for k, v in tiers.items()}
            for line in tb.describe():
                print(line)
        else:
            tiers = probed_train_tiers(device)
        self.fast = fast
        self.tenant = tenant
        self.predictive = predictive
        self.replan_every = max(replan_every, 1)
        slow = [t for t in tiers if t != fast][-1]
        self.ledger = ResidencyLedger(tiers)
        self.ledger.register_tenant(tenant, trace=self.trace)
        self.store = TieredStateStore(self.ledger, tenant, device=device)
        self.param_bytes = sum(p.nbytes for p in pytree.tree_leaves(params))
        # fp32 optimizer state lives in the store, first-touch on the
        # slow tier (where a host-offload allocator would put it)
        self.store.put(self.OPT_OBJ, self._opt_fp32(opt), [(slow, 1.0)])
        # bf16 params are device-resident by construction: client-origin
        # fast residency the planner may pin but never has to move
        self.ledger.register(tenant, "params_bf16",
                             {fast: self.param_bytes})
        # prediction audit plane: always on — move-time forecasts join
        # wall-clock outcomes (the store's move_fn copies for real)
        self.audit = PredictionLedger(registry=self.registry,
                                      tracer=self.tracer)
        # QoS flow attribution: with a topology, each step's optimizer
        # sweep is published as a write-class flow (fp32 state streamed
        # from its resident tier to the fast tier)
        self.blame = None
        self.graph = graph
        if graph is not None:
            self.blame = BlameLedger(
                graph, registry=self.registry, tracer=self.tracer,
                clock=lambda: float(self._epoch))
        self.calibrator = None
        if calibrate:
            self.calibrator = CostModelCalibrator(tiers, graph=graph)
            # probe each movable tier's memory kind with real copies,
            # then re-key the bandwidth observations by tier name (the
            # fit wants tier-space probes; kinds may be shared)
            tier_kind = {t: self.store._kind(t) for t in tiers if t != fast}
            by_kind = {p.tier: p for p in measure_transfer_probes(
                kinds=sorted(set(tier_kind.values()) - {"device"}),
                n_mb=16, iters=2, device=device)}
            self.calibrator.fit_probes(
                TierProbe(t, by_kind[k].bw_GBps)
                for t, k in sorted(tier_kind.items()) if k in by_kind)
        self.replanner = AdaptiveReplanner(
            self.trace, tiers, fast,
            cfg=ReplanConfig(replan_every=self.replan_every,
                             window_epochs=self.replan_every),
            executor=MigrationExecutor(tiers, move_fn=self.store.move_fn,
                                       topology=graph),
            default_tier=slow,
            topology=graph, ledger=self.ledger, tenant=tenant,
            tracer=self.tracer, audit=self.audit,
            calibrator=self.calibrator)
        self.replanner.executor.tracer = self.tracer
        self.replanner.executor.audit = self.audit
        self.replanner.executor.calibrator = self.calibrator
        # the store's move_fn copies blocks between memory kinds, so
        # executor wall times share the model's unit
        self.replanner.executor.physical_moves = True
        self.replanner.executor.recalibrate()
        self.nbytes = {
            "params_bf16": self.param_bytes,
            "grads_bf16": self.param_bytes,
            self.OPT_OBJ: self.store.nbytes(self.OPT_OBJ),
        }

    @staticmethod
    def _opt_fp32(opt):
        """The movable fp32 subtree of the Adam state."""
        return {k: opt[k] for k in ("master", "m", "v") if k in opt}

    def on_step(self, step: int, opt=None) -> None:
        emit_step_traffic(self.sampler, self.param_bytes)
        self.phases.update()
        epoch = step + 1
        self._epoch = epoch
        self.tracer.event("phase.update", cat="phase", epoch=epoch,
                          label=str(self.phases.label),
                          shifts=len(self.phases.shifts))
        if self.blame is not None:
            self._publish_qos_flows(epoch)
        if opt is not None and epoch % self.replan_every == 0:
            # refresh the mirror so an applied replan migrates the
            # *current* optimizer bytes, not the init-time ones
            self.store.update(self.OPT_OBJ, self._opt_fp32(opt))
        if self.calibrator is not None \
                and epoch % self.replan_every == 0:
            # fold online residual corrections into the planning tiers
            self.replanner.recalibrate()
        d = None
        if self.predictive and self.phases.signature is not None:
            # key plans by recurrence signature; pre-stage the proven
            # plan of a phase predicted to start next epoch
            cur = self.phases.expected_signature(1)
            nxt = self.phases.expected_signature(2)
            if nxt is not None and nxt != cur:
                d = self.replanner.prefetch_phase(epoch, self.nbytes,
                                                  nxt)
            if d is None:
                d = self.replanner.maybe_replan(
                    epoch, self.nbytes, pin_fast=("params_bf16",),
                    phase=cur)
        else:
            d = self.replanner.maybe_replan(epoch, self.nbytes,
                                            pin_fast=("params_bf16",),
                                            phase=self.phases.label)
        if d is not None and d.reason != "initial":
            print(f"  replan@{step}: {'applied' if d.applied else 'kept'} "
                  f"({d.reason}) old={d.old_step_s*1e3:.1f} ms "
                  f"new={d.new_step_s*1e3:.1f} ms "
                  f"migration={d.migration_s*1e3:.1f} ms "
                  f"moved={d.moved_bytes/1e6:.2f} MB")

    def _publish_qos_flows(self, epoch: int) -> None:
        """Publish this step's optimizer-sweep traffic into the blame
        book: the fp32 state resident off the fast tier streams across
        the topology every step (normalized to a 1 s step period, so
        offered GB/s == GB moved per step)."""
        dst = self.graph.node_of(self.fast)
        if dst is None:
            return
        flows = []
        place = self.ledger.placement(self.tenant, self.OPT_OBJ)
        for tier, nbytes in sorted(place.items()):
            src = self.graph.node_of(tier)
            if src is None or src == dst or nbytes <= 0:
                continue
            flows.append(Flow(src, dst, nbytes / 1e9, cls="write",
                              tenant=self.tenant))
        self.blame.publish_flows(self.tenant, flows, now=float(epoch))

    def opt_bytes_on(self, tier: str) -> int:
        """Ledger view of the optimizer state's tier residency."""
        return self.ledger.object_bytes(self.tenant, self.OPT_OBJ, tier)

    def write_artifacts(self, trace_out=None, metrics_out=None,
                        audit_out=None) -> None:
        """--trace-out / --metrics-out / --audit-out exports."""
        if trace_out:
            if trace_out.endswith(".jsonl"):
                n = self.tracer.to_jsonl(trace_out)
                kind = "jsonl"
            else:
                n = self.tracer.to_chrome(trace_out)
                kind = "chrome trace_event"
            print(f"trace: wrote {n} events ({kind}) -> {trace_out}")
        if metrics_out:
            self.registry.set_gauges(self.replanner.summary(),
                                     prefix="train.replan")
            self.registry.set_gauges(
                {"trace_events": float(self.trace.total_events),
                 "profiling_samples": float(self.sampler.samples),
                 "profiling_overhead_s": self.sampler.overhead_s,
                 "phase_shifts": float(len(self.phases.shifts))},
                prefix="train.telemetry")
            self.ledger.publish(self.registry)
            self.registry.set_gauges(self.audit.summary())
            if self.calibrator is not None:
                self.calibrator.publish(self.registry)
            with open(metrics_out, "w") as fh:
                fh.write(self.registry.to_prometheus_text())
            print(f"metrics: wrote {len(self.registry.names())} series "
                  f"(prometheus text) -> {metrics_out}")
        if audit_out:
            payload = {"audit": self.audit.report()}
            if self.calibrator is not None:
                payload["calibration"] = self.calibrator.summary()
            with open(audit_out, "w") as fh:
                json.dump(payload, fh, indent=2, sort_keys=True)
            print(f"audit: wrote prediction residual report -> "
                  f"{audit_out}")

    def report(self) -> None:
        place = self.ledger.placement(self.tenant, self.OPT_OBJ)
        placed = " ".join(f"{t}={b/1e6:.1f}MB"
                          for t, b in sorted(place.items()))
        print(f"telemetry: {self.trace.total_events} events, "
              f"{self.sampler.samples} samples, "
              f"overhead={self.sampler.overhead_s*1e3:.2f} ms, "
              f"phase={self.phases.label} "
              f"(shifts={len(self.phases.shifts)}), "
              f"replans={self.replanner.replans_applied}/"
              f"{len(self.replanner.decisions)} "
              f"(cache_hits={self.replanner.plan_cache_hits}, "
              f"prefetches={self.replanner.prefetches}), "
              f"tier_order={'>'.join(self.replanner.tier_order)}")
        print(f"ledger[{self.tenant}]: opt_state moved="
              f"{self.ledger.counters.migrated_bytes/1e6:.2f} MB "
              f"placement: {placed}")
        if self.audit.matched:
            accs = " ".join(
                f"acc[{m}]={self.audit.accuracy(m):.2f}"
                for m in self.audit.models())
            print(f"audit: joins={self.audit.matched} {accs}"
                  + (f" calib_obs={self.calibrator.observations}"
                     if self.calibrator is not None else ""))


@dataclasses.dataclass
class TrainRun:
    """What one launcher run left: the telemetry sidecar (None without
    ``--adaptive``), each step's loss and wall time by step index (the
    steps this run took), the final params and optimizer state, and the
    step it started from (after a restore, the checkpoint's)."""

    telem: Optional[_TrainTelemetry]
    losses: Dict[int, float]
    step_s: Dict[int, float]
    params: object
    opt: object
    start: int


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's arguments, with every cross-flag check of the
    reference (argparse exits on a violation)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", default="1x1",
                    help="device mesh (DxM or PxDxM): FSDP over data, TP "
                         "over model")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--adaptive", action="store_true",
                    help="record per-phase access telemetry, replan "
                         "host-tier placement online, and migrate the "
                         "fp32 optimizer state through a "
                         "TieredStateStore")
    ap.add_argument("--replan-every", type=int, default=None,
                    help="steps between adaptive replan attempts "
                         "(default 10; requires --adaptive)")
    ap.add_argument("--sample-rate", type=float, default=None,
                    help="telemetry sampling rate (fraction of cache "
                         "lines); 1.0 = full instrumentation, right "
                         "for smoke-scale traffic — drop toward "
                         "PEBS-like 1e-6 on production-size models "
                         "(default 1.0; requires --adaptive)")
    ap.add_argument("--tenant", default=None,
                    help="residency-ledger tenant namespace for this "
                         "run's training state (default: train; "
                         "requires --adaptive)")
    ap.add_argument("--predictive", action="store_true",
                    help="key replans by phase recurrence signature "
                         "and pre-stage the proven plan of a predicted "
                         "next phase (requires --adaptive)")
    ap.add_argument("--trace-out", default=None,
                    help="write the control-plane trace here after the "
                         "run: .jsonl = one event per line, else Chrome "
                         "trace_event JSON (requires --adaptive)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry as Prometheus "
                         "text exposition here (requires --adaptive)")
    ap.add_argument("--calibrate", action="store_true",
                    help="self-calibrating cost model: probe the "
                         "movable tiers' memory kinds with real "
                         "copies at startup and keep correcting "
                         "planning bandwidths online from audited "
                         "move-time residuals (requires --adaptive)")
    ap.add_argument("--audit-out", default=None,
                    help="write the prediction-audit residual report "
                         "(JSON: per-model accuracy, p95 relative "
                         "error, drift state) here (requires "
                         "--adaptive)")
    ap.add_argument("--topology", default=None,
                    choices=list(TOPOLOGY_CHOICES),
                    help="with --adaptive: plan over this machine "
                         "topology (hop distance, link bandwidth) "
                         "instead of the flat HBM/HOST pair; h100-node "
                         "is built from transfer probes of this machine")
    args = ap.parse_args(argv)
    if not args.adaptive:
        # these knobs only affect the adaptive path: accepting them
        # silently would let a typo'd run think it was adaptive
        for flag, val in (("--replan-every", args.replan_every),
                          ("--sample-rate", args.sample_rate),
                          ("--tenant", args.tenant),
                          ("--trace-out", args.trace_out),
                          ("--metrics-out", args.metrics_out),
                          ("--audit-out", args.audit_out)):
            if val is not None:
                ap.error(f"{flag} only takes effect with --adaptive "
                         f"(the telemetry sidecar is what consumes it)")
        if args.predictive:
            ap.error("--predictive requires --adaptive (prediction "
                     "pre-stages the adaptive replanner's phase-cached "
                     "plans)")
        if args.calibrate:
            ap.error("--calibrate requires --adaptive (the corrections "
                     "feed the adaptive replanner's cost model)")
    if args.replan_every is None:
        args.replan_every = 10
    if args.sample_rate is None:
        args.sample_rate = 1.0
    if args.tenant is None:
        args.tenant = "train"
    if not 0.0 < args.sample_rate <= 1.0:
        ap.error(f"--sample-rate must be in (0, 1], "
                 f"got {args.sample_rate}")
    if args.topology and not args.adaptive:
        ap.error("--topology only takes effect with --adaptive (the "
                 "replanner is what plans over the topology)")
    return args


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args: argparse.Namespace, devices=None) -> TrainRun:
    """Train as ``args`` (from ``parse_args``) say, on the ``--mesh``
    laid over ``devices`` (``parse_mesh``): restore the latest
    checkpoint of ``--ckpt-dir`` if there is one, onto that mesh, take
    the steps up to ``--steps``, checkpoint every ``--ckpt-every`` steps
    and at the end."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    mesh = parse_mesh(args.mesh, args.device, devices)
    dev = mesh.first_device
    with PS.use_mesh(mesh, dp=dp_axes(mesh), tp="model"):
        return _train(args, cfg, dev, mesh)


def _train(args: argparse.Namespace, cfg, dev: torch.device,
           mesh: Mesh) -> TrainRun:
    acfg = AdamConfig(lr=args.lr, compress_grads=args.compress_grads)

    params = lm.init_params(cfg, seed=0, device=dev)
    p_specs = sh.param_pspecs(params, mesh)
    params = sh.to_named(params, p_specs, mesh)
    if args.adaptive and mesh.size > 1:
        raise ValueError(f"--adaptive under --mesh {args.mesh}, a mesh of "
                         f"{mesh.size} devices: {SPLIT_ADAPTIVE_FAULT}")
    step_fn = steps_mod.make_train_step(cfg, acfg)

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    it = DataIterator(dc)
    start = 0
    if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
        # restore onto this mesh (elastic), into the state's shapes
        shapes = pytree.tree_map(lambda p: torch.empty(
            tuple(p.shape), dtype=p.dtype, device="meta"), params)
        template = {"params": shapes,
                    "opt": init_state_shapes(shapes, acfg)}
        # the state's specs; err (--compress-grads) is placed as params
        o_specs = sh.opt_state_pspecs(p_specs, mesh)
        placement = sh.named_shardings(
            {"params": p_specs,
             "opt": {k: o_specs.get(k, p_specs) for k in template["opt"]}},
            mesh)
        del params
        state, meta = store.restore(args.ckpt_dir, template,
                                    placement=placement)
        params, opt = state["params"], state["opt"]
        start = int(meta.get("step", 0))
        it.restore({"step": start})
        print(f"restored step {start} (elastic re-shard onto {args.mesh}, "
              f"{mesh.size} entries over {dev})")
    else:
        opt = init_state(params, acfg)

    telem = (_TrainTelemetry(params, opt, args.replan_every,
                             args.sample_rate, args.topology,
                             tenant=args.tenant,
                             predictive=args.predictive,
                             calibrate=args.calibrate, device=dev)
             if args.adaptive else None)
    losses: Dict[int, float] = {}
    step_s: Dict[int, float] = {}
    for i in range(start, args.steps):
        b = next(it)
        t0 = time.perf_counter()
        params, opt, loss = step_fn(
            params, opt, {"tokens": torch.from_numpy(b["tokens"]).to(dev),
                          "labels": torch.from_numpy(b["labels"]).to(dev)})
        losses[i] = float(loss)
        step_s[i] = time.perf_counter() - t0
        if telem is not None:
            telem.on_step(i, opt)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={losses[i]:.4f} "
                  f"({(time.perf_counter()-t0)*1e3:.0f} ms)")
        if args.ckpt_dir and args.ckpt_every and i \
                and i % args.ckpt_every == 0:
            store.save(args.ckpt_dir, i, {"params": params, "opt": opt},
                       metadata={"step": i})
    if args.ckpt_dir:
        store.save(args.ckpt_dir, args.steps,
                   {"params": params, "opt": opt},
                   metadata={"step": args.steps})
    if telem is not None:
        _sync(dev)
        telem.report()
        telem.write_artifacts(args.trace_out, args.metrics_out,
                              args.audit_out)
    print("done")
    return TrainRun(telem, losses, step_s, params, opt, start)


def main(argv=None):
    return run(parse_args(argv)).telem


if __name__ == "__main__":
    main()
