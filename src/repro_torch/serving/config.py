"""PyTorch-port copy of ``repro.serving.config`` (framework-free).

Nested ServingConfig sections + the one place cross-field rules live.

``ServingConfig`` accreted ~25 flat flags across five PRs (tiering,
telemetry, SLO/QoS, MoE experts, calibration); this module groups them
into sections so call sites read by concern:

  * :class:`TieringOptions`  — pool sizing, tiering policy, adaptive
    replanning, calibration, topology;
  * :class:`QoSOptions`      — SLO targets, the interference-class QoS
    plane, the flow class;
  * :class:`ExpertOptions`   — MoE expert residency + the fused
    tiered-gather decode path;
  * :class:`ClusterOptions`  — the multi-host plane: replica count,
    session-router policy, model sharding.

The flat ``ServingConfig`` fields remain valid kwargs: its
``__post_init__`` migrates in both directions (a section passed in
wins over the flat defaults; flat kwargs populate the sections), so
nothing written against the old surface breaks.

``validate_args`` centralizes every cross-field constraint the serve
CLI used to enforce through scattered ``parser.error`` calls
(``--qos`` requires a topology and a decode SLO, ``--predictive``
requires ``--adaptive``, ...), raising :class:`ConfigError` —
``ServingConfig.from_args`` is the one builder both the CLI and
programmatic callers go through.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ClusterOptions", "ConfigError", "ExpertOptions",
           "QoSOptions", "ROUTER_POLICIES", "TieringOptions",
           "validate_args"]

ROUTER_POLICIES = ("headroom-distance", "round-robin", "random",
                   "least-loaded")


class ConfigError(ValueError):
    """A cross-field serving-configuration constraint was violated."""


@dataclasses.dataclass
class TieringOptions:
    """Pool sizing, tiering policy, and the adaptive control plane."""

    policy: str = "tiering08"
    num_blocks: Optional[int] = None
    fast_block_budget: Optional[int] = None
    slow_kind: str = "pinned_host"
    migrate_every: int = 1
    device_budget_bytes: Optional[int] = None
    host_budget_bytes: Optional[int] = None
    adaptive: bool = False
    replan_every: int = 8
    sample_rate: float = 1.0
    predictive: bool = False
    calibrate: bool = False
    topology: Optional[str] = None


@dataclasses.dataclass
class QoSOptions:
    """SLO targets + the interference-class QoS plane."""

    enabled: bool = False          # the old flat ``qos`` switch
    cls: str = "read"              # interference class of KV gathers
    slo_p95_ttft_s: Optional[float] = None
    slo_p95_decode_s: Optional[float] = None
    slo_p99_decode_s: Optional[float] = None
    slo_p999_decode_s: Optional[float] = None
    slo_window: int = 512

    @property
    def decode_slo_s(self) -> Optional[float]:
        """The decode target violation prediction gates on."""
        return self.slo_p99_decode_s or self.slo_p95_decode_s


@dataclasses.dataclass
class ExpertOptions:
    """MoE expert tier residency + fused tiered-gather decode."""

    policy: Optional[str] = None   # None | "lru" | "predictive"
    fast_fraction: float = 0.25
    fused_gather: bool = False


@dataclasses.dataclass
class ClusterOptions:
    """The multi-host serving plane (new in the cluster PR — no flat
    legacy kwargs to migrate)."""

    replicas: int = 1
    router: str = "headroom-distance"
    shard_model: bool = True       # shard params over each replica mesh

    def __post_init__(self):
        if self.replicas < 1:
            raise ConfigError(f"cluster replicas must be >= 1, "
                              f"got {self.replicas}")
        if self.router not in ROUTER_POLICIES:
            raise ConfigError(
                f"unknown router policy {self.router!r}; choose from "
                f"{', '.join(ROUTER_POLICIES)}")


# section field -> flat ServingConfig field, per section attribute
SECTION_FIELDS = {
    "tiering": {
        "policy": "policy", "num_blocks": "num_blocks",
        "fast_block_budget": "fast_block_budget",
        "slow_kind": "slow_kind", "migrate_every": "migrate_every",
        "device_budget_bytes": "device_budget_bytes",
        "host_budget_bytes": "host_budget_bytes",
        "adaptive": "adaptive", "replan_every": "replan_every",
        "sample_rate": "sample_rate", "predictive": "predictive",
        "calibrate": "calibrate", "topology": "topology",
    },
    "qos_options": {
        "enabled": "qos", "cls": "qos_class",
        "slo_p95_ttft_s": "slo_p95_ttft_s",
        "slo_p95_decode_s": "slo_p95_decode_s",
        "slo_p99_decode_s": "slo_p99_decode_s",
        "slo_p999_decode_s": "slo_p999_decode_s",
        "slo_window": "slo_window",
    },
    "experts": {
        "policy": "expert_policy",
        "fast_fraction": "expert_fast_fraction",
        "fused_gather": "fused_gather",
    },
}
_SECTION_TYPES = {"tiering": TieringOptions, "qos_options": QoSOptions,
                  "experts": ExpertOptions}


def sync_sections(cfg) -> None:
    """Two-way section/flat migration for ``ServingConfig.__post_init__``.

    A section the caller passed wins: its values overwrite the flat
    fields every engine code path reads.  A section left at None is
    built from the flat fields, so old flat kwargs fully populate the
    new surface.
    """
    for attr, mapping in SECTION_FIELDS.items():
        section = getattr(cfg, attr)
        if section is not None:
            for sfield, flat in mapping.items():
                setattr(cfg, flat, getattr(section, sfield))
        else:
            setattr(cfg, attr, _SECTION_TYPES[attr](
                **{sfield: getattr(cfg, flat)
                   for sfield, flat in mapping.items()}))


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def validate_args(args) -> None:
    """Every cross-field rule of the serving surface, in one place.

    ``args`` is any namespace shaped like the serve CLI's (missing
    attributes read as their defaults).  Raises :class:`ConfigError`;
    the CLI maps that onto ``parser.error``.
    """
    get = lambda name, default=None: getattr(args, name, default)  # noqa: E731
    scheduler = get("scheduler", "continuous")
    continuous = scheduler == "continuous"

    if get("predictive") and not get("adaptive"):
        raise ConfigError(
            "--predictive requires --adaptive (prediction pre-stages "
            "the adaptive replanner's phase-cached plans)")
    if get("calibrate") and not get("adaptive"):
        raise ConfigError(
            "--calibrate requires --adaptive (the corrections feed "
            "the adaptive replanner's cost model)")
    if not continuous:
        if get("calibrate"):
            raise ConfigError(
                "--calibrate only takes effect with --scheduler "
                "continuous (the calibrator corrects the paged "
                "engine's planning tiers)")
        if get("tenant") is not None:
            raise ConfigError(
                "--tenant only takes effect with --scheduler "
                "continuous (the paged pool is what registers a "
                "ledger tenant)")
        for name in ("trace_out", "metrics_out", "audit_out",
                     "slo_p95_ttft", "slo_p95_decode", "slo_p99_decode",
                     "slo_p999_decode", "expert_policy"):
            if get(name) is not None:
                raise ConfigError(
                    f"{_flag(name)} only takes effect with --scheduler "
                    "continuous (the observability plane instruments "
                    "the paged engine)")
        if get("fused_gather"):
            raise ConfigError(
                "--fused-gather only takes effect with --scheduler "
                "continuous (it rewires the paged decode path)")
        if get("qos"):
            raise ConfigError(
                "--qos only takes effect with --scheduler continuous "
                "(the QoS plane instruments the paged engine's "
                "admission path)")
        if get("topology"):
            raise ConfigError(
                "--topology only takes effect with --scheduler "
                "continuous (contention-aware admission; add "
                "--adaptive to also price replans over it)")
        if get("replicas", 1) and int(get("replicas", 1)) > 1:
            raise ConfigError(
                "--replicas only takes effect with --scheduler "
                "continuous (the cluster plane routes sessions onto "
                "paged engines)")
    if get("qos"):
        if not get("topology") and int(get("replicas", 1) or 1) <= 1:
            raise ConfigError(
                "--qos requires --topology (blame attribution joins "
                "violations to topology links)")
        if get("slo_p99_decode") is None and get("slo_p95_decode") is None:
            raise ConfigError(
                "--qos requires a decode SLO (--slo-p99-decode or "
                "--slo-p95-decode) to predict violations against")
    replicas = int(get("replicas", 1) or 1)
    if replicas > 1:
        # cluster engines shard params over per-replica meshes; the
        # pooled fused-gather / expert stores are still committed to
        # the default device and would make jit see disjoint device
        # sets — gate them out until they are mesh-placed too
        if get("fused_gather"):
            raise ConfigError(
                "--fused-gather is not yet supported with --replicas "
                "> 1 (the pooled KV layout is not mesh-placed)")
        if get("expert_policy"):
            raise ConfigError(
                "--expert-policy is not yet supported with --replicas "
                "> 1 (expert stores are not mesh-placed)")
    router = get("router")
    if router is not None and router not in ROUTER_POLICIES:
        raise ConfigError(
            f"unknown --router policy {router!r}; choose from "
            f"{', '.join(ROUTER_POLICIES)}")
