"""TieredStateStore: ledger-registered tensor trees with a re-place
executor (counterpart of ``repro.pool.state_store``).

The store holds named trees (e.g. the fp32 optimizer state
``opt_state_fp32``) as block-granular ``TieredArray``s whose per-block
*tier labels* live here (a tier name like HOST or CXL maps to a memory
kind only when a block is placed, so logically distinct tiers stay
distinct where two share a kind), and exposes ``move_fn``: the
``MigrationExecutor`` hook that realizes an object-level byte move as
real block re-placements (copies between device, pinned and pageable
host memory), gated per block by the ledger's budgets and recorded
there (the store is the physical client, so it does the recording).

Leaves are visited in the reference's order (dict keys sorted,
sequences by index), so a move of the same bytes re-places the same
blocks in both packages.  Memory kinds are those of an engine on
``device`` (CUDA unless ``"cpu"``; under a CPU engine every kind is
logical CPU memory).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from ..core.interleave import _path_part
from ..core.tiered_array import (DeviceLike, empty_on, LOGICAL_KINDS,
                                 resolve_device, TIER_TO_MEMORY_KIND,
                                 TieredArray)
from .ledger import ResidencyLedger

Share = Tuple[str, float]


@dataclasses.dataclass
class _Leaf:
    """One tree leaf: the placed tensor + per-block tier labels."""

    ta: TieredArray
    labels: List[str]       # tier name of each block (kinds may collide)


def _ordered(tree) -> Tuple[List[torch.Tensor], List[int], object]:
    """(leaves in the reference's order, each one's index in torch's
    flattening, the tree spec)."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    order = sorted(range(len(flat)),
                   key=lambda i: tuple(_path_part(p) for p in flat[i][0]))
    return [flat[i][1] for i in order], order, spec


def _rows(x: torch.Tensor) -> torch.Tensor:
    x = torch.as_tensor(x)
    return x.reshape(1) if x.dim() == 0 else x


class TieredStateStore:
    """Named tensor trees placed across tiers, moved through the
    ledger."""

    def __init__(self, ledger: ResidencyLedger, tenant: str,
                 tier_to_kind: Optional[Mapping[str, str]] = None,
                 block_rows: Optional[int] = None,
                 device: DeviceLike = None):
        self.ledger = ledger
        self.tenant = tenant
        ledger.register_tenant(tenant)
        # tier names map to kinds as the reference maps them; a tier
        # named by its kind (the h100-node testbed's) maps to itself
        self.tier_to_kind = dict(tier_to_kind or {
            **TIER_TO_MEMORY_KIND, **{k: k for k in LOGICAL_KINDS}})
        self.block_rows = block_rows
        self.device = resolve_device(device)
        self._objs: Dict[str, List[_Leaf]] = {}
        self._trees: Dict[str, Tuple[List[int], object]] = {}

    def _kind(self, tier: str) -> str:
        return self.tier_to_kind.get(tier, "device")

    # ------------------------------------------------------------------ #
    def put(self, name: str, tree, shares: Sequence[Share]) -> None:
        """Place every leaf of ``tree`` under ``name`` with tier-name
        ``shares`` (copies: the store never aliases ``tree``) and
        register the residency with the ledger."""
        if name in self._objs:
            self.drop(name)
        flat, order, spec = _ordered(tree)
        leaves: List[_Leaf] = []
        placement: Dict[str, int] = {}
        for x in flat:
            x = _rows(x)
            spans = TieredArray.plan_blocks(x.shape[0], shares,
                                            self.block_rows)
            blocks, kinds, labels = [], [], []
            per_row = x.nbytes // max(x.shape[0], 1)
            for a, b, tier in spans:
                kind = self._kind(tier)
                blk = empty_on(kind, (b - a, *x.shape[1:]), x.dtype,
                               self.device)
                blk.copy_(x[a:b])
                blocks.append(blk)
                kinds.append(kind)
                labels.append(tier)
                placement[tier] = placement.get(tier, 0) \
                    + (b - a) * per_row
            leaves.append(_Leaf(TieredArray(blocks, kinds, tuple(x.shape),
                                            x.dtype, self.device),
                                labels))
        self._objs[name] = leaves
        self._trees[name] = (order, spec)
        if self.ledger.has(self.tenant, name):
            self.ledger.retire(self.tenant, name)
        self.ledger.register(self.tenant, name, placement)

    def drop(self, name: str) -> None:
        self._objs.pop(name, None)
        self._trees.pop(name, None)
        self.ledger.retire(self.tenant, name)

    # ------------------------------------------------------------------ #
    def gather(self, name: str):
        """The object's tree in device memory."""
        order, spec = self._trees[name]
        flat: List[Optional[torch.Tensor]] = [None] * len(order)
        for i, lf in zip(order, self._objs[name]):
            flat[i] = lf.ta.gather()
        return pytree.tree_unflatten(flat, spec)

    def update(self, name: str, tree) -> None:
        """Write fresh values into the blocks, keeping the placement —
        the mid-run refresh that keeps a migration moving *current*
        bytes."""
        flat, _, _ = _ordered(tree)
        leaves = self._objs[name]
        if len(flat) != len(leaves):
            raise ValueError(f"{name}: tree shape changed")
        for lf, x in zip(leaves, flat):
            lf.ta.update(_rows(x))

    def nbytes(self, name: str) -> int:
        return sum(lf.ta.nbytes for lf in self._objs.get(name, ()))

    def bytes_on(self, name: str, tier: str) -> int:
        """Tier occupancy, read through the ledger (single source)."""
        return self.ledger.object_bytes(self.tenant, name, tier)

    def shares(self, name: str) -> List[Share]:
        total = self.nbytes(name)
        place = self.ledger.placement(self.tenant, name)
        return [(t, b / max(total, 1)) for t, b in sorted(place.items())]

    def leaves(self, name: str) -> List[Tuple[TieredArray, List[str]]]:
        """(placed tensor, tier label of each block) of every leaf of
        ``name``, in the reference's leaf order."""
        return [(lf.ta, list(lf.labels)) for lf in self._objs[name]]

    # ------------------------------------------------------------------ #
    def demote_over_budget(self, fast_tier: str, slow_tier: str) -> int:
        """Ledger-driven compliance for training state: when an arbiter
        shrank this tenant's ``fast_tier`` budget below its holdings,
        demote blocks to ``slow_tier`` until the ledger reconciles (the
        state has no queue to re-enter, so it demotes in place).
        Returns the bytes demoted."""
        moved = 0
        for name in sorted(self._objs):
            over = self.ledger.over_budget(self.tenant, fast_tier)
            if over <= 0:
                break
            moved += self.move_fn(name, fast_tier, slow_tier, over)
        return moved

    def move_fn(self, obj: str, src: str, dst: str, nbytes: int) -> int:
        """MigrationExecutor hook: realize an object-level byte move as
        block re-placements.  Budget-gated per block through the ledger;
        returns the bytes actually moved."""
        leaves = self._objs.get(obj)
        if leaves is None or src == dst:
            return 0
        dst_kind = self._kind(dst)
        moved = 0
        for lf in leaves:
            per_row = lf.ta.nbytes // max(lf.ta.shape[0], 1)
            for i, label in enumerate(lf.labels):
                if moved >= nbytes:
                    break
                if label != src:
                    continue
                blk_bytes = lf.ta.blocks[i].shape[0] * per_row
                if moved and moved + blk_bytes > nbytes:
                    break      # the next whole block would overshoot the
                    #            request (a sub-block request may still
                    #            round up to its single first block)
                if not self.ledger.can_place(self.tenant, dst, blk_bytes):
                    break
                lf.ta.move_block(i, dst_kind)
                lf.labels[i] = dst
                self.ledger.record_move(self.tenant, obj, src, dst,
                                        blk_bytes)
                moved += blk_bytes
        return moved
