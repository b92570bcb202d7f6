"""Hierarchical ``replica/tenant/object`` keys for the multi-host plane.

Every accounting plane built so far (``ResidencyLedger`` budgets,
``TierBudgetArbiter`` grants, ``BlameLedger`` attribution) keyed state
by a flat tenant string — fine for one engine on one host, but the
multi-host serving plane multiplies the same tenant across replicas,
and "Dissecting CXL Memory Performance at Scale" (arXiv:2409.14317)
scales its measure→model→place loop exactly along that axis: per-host
pools that must still roll up to one fleet view.  ``Namespace`` is the
structured key that makes both views exact:

  * ``Namespace(replica, tenant, obj)`` — ordered, hashable, and
    round-trippable through ``parse``/``str`` (``parse(str(ns)) == ns``);
  * tenant-level keys render in a **short form** that omits the
    ``default`` replica (``str(Namespace(tenant="a")) == "a"``), so
    single-host callers keep reading the names they always wrote;
  * glob-style patterns (``replica0/*``, ``*/serving``) aggregate
    across the hierarchy — per-replica ledger views sum exactly to the
    global ``*/*`` view because both are reductions over the same keys;
  * bare strings keep working everywhere via :meth:`Namespace.of`,
    which maps ``"t"`` to ``default/t`` and warns once per process
    (the deprecation shim for pre-cluster callers).
"""
from __future__ import annotations

import dataclasses
import warnings
from fnmatch import fnmatchcase
from typing import Dict, Union

DEFAULT_REPLICA = "default"

_GLOB_CHARS = ("*", "?", "[")

# the bare-string deprecation fires once per process, not once per call
# site: pre-cluster code paths touch the ledger thousands of times per
# run and a warning storm would bury the signal
_warned_bare = False
# parse results are memoized — ledger accounting normalizes on every
# record_alloc/record_free, and the distinct key population is tiny
_parse_cache: Dict[str, "Namespace"] = {}


def reset_bare_key_warning() -> None:
    """Re-arm the once-per-process bare-string deprecation (tests)."""
    global _warned_bare
    _warned_bare = False


def is_pattern(s: str) -> bool:
    """True when ``s`` contains glob metacharacters (``* ? [``)."""
    return any(c in s for c in _GLOB_CHARS)


@dataclasses.dataclass(frozen=True, order=True)
class Namespace:
    """Structured ``replica/tenant/obj`` key.

    Ordering is lexicographic over ``(replica, tenant, obj)``, so a
    sorted iteration groups each replica's tenants together — the
    arbiter's per-replica split and the ledger's publish loop both rely
    on that.
    """

    replica: str = DEFAULT_REPLICA
    tenant: str = ""
    obj: str = ""

    def __post_init__(self):
        for part, val in (("replica", self.replica),
                          ("tenant", self.tenant), ("obj", self.obj)):
            if "/" in val:
                raise ValueError(
                    f"namespace {part} component {val!r} may not "
                    f"contain '/'")

    # -------------------------------------------------------------- #
    # parse / format                                                 #
    # -------------------------------------------------------------- #
    @classmethod
    def parse(cls, s: str) -> "Namespace":
        """Parse ``"t"`` | ``"replica/t"`` | ``"replica/t/obj"``."""
        ns = _parse_cache.get(s)
        if ns is not None:
            return ns
        parts = s.split("/")
        if len(parts) == 1:
            ns = cls(tenant=parts[0])
        elif len(parts) == 2:
            ns = cls(replica=parts[0], tenant=parts[1])
        elif len(parts) == 3:
            ns = cls(replica=parts[0], tenant=parts[1], obj=parts[2])
        else:
            raise ValueError(f"namespace {s!r} has more than "
                             f"replica/tenant/obj components")
        _parse_cache[s] = ns
        return ns

    @classmethod
    def of(cls, key: Union[str, "Namespace"]) -> "Namespace":
        """Normalize a ledger key: Namespace passes through; strings
        are parsed, with a **bare** tenant string (no ``/``) mapped to
        ``default/<tenant>`` under a once-per-process
        ``DeprecationWarning`` — the compatibility shim for callers
        written before the cluster plane existed."""
        if isinstance(key, Namespace):
            return key
        if "/" not in key:
            global _warned_bare
            if not _warned_bare and not is_pattern(key):
                _warned_bare = True
                warnings.warn(
                    f"bare tenant key {key!r} interpreted as "
                    f"'{DEFAULT_REPLICA}/{key}'; pass a "
                    f"'replica/tenant' namespace (repro.cluster."
                    f"Namespace) instead", DeprecationWarning,
                    stacklevel=3)
        return cls.parse(key)

    def __str__(self) -> str:
        # short display form: tenant-level keys in the default replica
        # render as the bare tenant name, so every pre-cluster mapping
        # key ("a", "serving", "noisy") is unchanged; parse() of every
        # form round-trips back to self
        if self.obj:
            return f"{self.replica}/{self.tenant}/{self.obj}"
        if self.replica == DEFAULT_REPLICA:
            return self.tenant
        return f"{self.replica}/{self.tenant}"

    @property
    def key(self) -> str:
        """Canonical long form — always ``replica/tenant[/obj]``."""
        base = f"{self.replica}/{self.tenant}"
        return f"{base}/{self.obj}" if self.obj else base

    # -------------------------------------------------------------- #
    # derivation                                                     #
    # -------------------------------------------------------------- #
    def with_obj(self, obj: str) -> "Namespace":
        return dataclasses.replace(self, obj=obj)

    def tenant_key(self) -> "Namespace":
        """This key with the object component dropped."""
        return self if not self.obj else dataclasses.replace(self, obj="")

    def in_replica(self, replica: str) -> "Namespace":
        return dataclasses.replace(self, replica=replica)

    # -------------------------------------------------------------- #
    # glob matching                                                  #
    # -------------------------------------------------------------- #
    def matches(self, pattern: str) -> bool:
        """Component-wise glob match.  A bare pattern addresses the
        default replica (mirroring :meth:`of`); a pattern without an
        object component matches any object."""
        parts = pattern.split("/")
        if len(parts) == 1:
            parts = [DEFAULT_REPLICA, parts[0]]
        if len(parts) > 3:
            raise ValueError(f"pattern {pattern!r} has more than "
                             f"replica/tenant/obj components")
        if not fnmatchcase(self.replica, parts[0]):
            return False
        if not fnmatchcase(self.tenant, parts[1]):
            return False
        if len(parts) == 3 and not fnmatchcase(self.obj, parts[2]):
            return False
        return True
