"""Paged KV-cache block pool with tier-resident blocks (counterpart of
``repro.serving.kv_pool``; ``TieredKVCache`` is not ported yet).

A block holds ``block_tokens`` tokens of K and V for every attention
layer: k/v each ``(U, n_attn, block_tokens, KV, hd)``.  Each block
resides on one memory kind (``core.tiered_array``): ``device`` is the
engine's CUDA device, ``pinned_host``/``unpinned_host`` are page-locked
and pageable CPU memory (all logical under a CPU engine).  A block
table maps ``seq_id -> [block ids]``; per-block access bits feed the
tiering policies; every alloc/free/migrate is recorded in a
``ResidencyLedger`` under the pool's tenant namespace.

Metadata-only mode (``spec=None``) keeps the bookkeeping without
payloads.  Data mode has two layouts:

  * **per-block** (default): each block owns its (k, v) tensors on its
    memory kind; ``migrate`` really moves the bytes, and ``gather_seq``
    copies a sequence's blocks to the device (``non_blocking`` from
    pinned memory) into one contiguous staging buffer.
  * **pooled** (``pooled=True``): payloads live in two persistent
    device stores ``(U, n_attn, num_blocks, bt, KV, hd)`` indexed by
    physical block id, which the fused decode kernel reads through
    ``gather_tables``; residency is the ledger's logical bookkeeping.

Where the reference rebuilds its immutable arrays with ``.at[].set``,
the port writes in place: the stores and block payloads are updated by
slice ``copy_``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.tiered_array import DeviceLike, resolve_device, to_kind
from ..pool.ledger import ResidencyLedger

FAST_KIND = "device"


@dataclasses.dataclass(frozen=True)
class KVBlockSpec:
    """Shape of one pool block (set from the model config)."""

    n_units: int
    n_attn: int          # attention layers per unit
    block_tokens: int
    n_kv: int
    head_dim: int
    dtype: str = "bfloat16"

    @property
    def kv_shape(self) -> Tuple[int, ...]:
        return (self.n_units, self.n_attn, self.block_tokens, self.n_kv,
                self.head_dim)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def nbytes(self) -> int:
        # K and V
        item = torch.empty((), dtype=self.torch_dtype).element_size()
        return 2 * int(np.prod(self.kv_shape)) * item


@dataclasses.dataclass
class KVBlock:
    """One physical block: payload + residency + heat."""

    bid: int
    kind: str                      # current memory kind
    seq_id: Optional[int] = None   # owner sequence (None = free)
    logical_idx: int = -1          # position in the owner's block table
    k: Optional[torch.Tensor] = None   # (U, n_attn, bt, KV, hd)
    v: Optional[torch.Tensor] = None
    touch_count: int = 0
    last_touch_step: int = -(10 ** 9)

    @property
    def free(self) -> bool:
        return self.seq_id is None


class PoolExhausted(Exception):
    """No free blocks left — the scheduler must preempt."""


@dataclasses.dataclass
class PoolCounters:
    allocs: int = 0
    frees: int = 0
    promoted: int = 0
    demoted: int = 0
    migrated_bytes: int = 0
    defrags: int = 0


class PagedKVPool:
    """Fixed-size paged KV pool over tiered memory kinds.

    ``num_blocks`` bounds total KV capacity; ``fast_block_budget`` bounds
    how many blocks may reside on the fast kind at once.  ``device`` is
    the engine's device (CUDA unless ``"cpu"``).
    """

    def __init__(self, num_blocks: int, block_tokens: int,
                 spec: Optional[KVBlockSpec] = None,
                 fast_block_budget: Optional[int] = None,
                 slow_kind: str = "pinned_host",
                 default_kind: Optional[str] = None,
                 ledger=None, tenant: str = "kv",
                 pooled: bool = False, device: DeviceLike = None):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        if block_tokens <= 0:
            raise ValueError("block_tokens must be positive")
        if spec is not None and spec.block_tokens != block_tokens:
            raise ValueError("spec.block_tokens != pool block_tokens")
        if pooled and spec is None:
            raise ValueError("pooled layout needs a data-mode spec")
        self.block_tokens = block_tokens
        self.spec = spec
        self.pooled = pooled
        self.device = (resolve_device(device) if spec is not None
                       else torch.device("cpu"))
        self.k_store = self.v_store = None
        if pooled:
            shape = (spec.n_units, spec.n_attn, num_blocks,
                     block_tokens, spec.n_kv, spec.head_dim)
            self.k_store = torch.zeros(shape, dtype=spec.torch_dtype,
                                       device=self.device)
            self.v_store = torch.zeros_like(self.k_store)
        self.slow_kind = slow_kind
        self.default_kind = default_kind or slow_kind
        self.blocks: List[KVBlock] = [
            KVBlock(bid=i, kind=self.default_kind)
            for i in range(num_blocks)]
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.table: Dict[int, List[int]] = {}   # seq_id -> [bid]
        self.seq_len: Dict[int, int] = {}       # seq_id -> tokens written
        self.counters = PoolCounters()
        self.telemetry = None                   # AccessTrace/AccessSampler
        self.ledger = ledger if ledger is not None else ResidencyLedger()
        self.tenant = tenant
        self.ledger.register_tenant(tenant)
        self.fast_block_budget = (num_blocks if fast_block_budget is None
                                  else fast_block_budget)

    # ------------------------------------------------------------------ #
    # telemetry                                                          #
    # ------------------------------------------------------------------ #
    def attach_telemetry(self, recorder) -> None:
        """Attach an access recorder (anything with ``observe(obj,
        read_bytes, write_bytes, random_fraction, phase)`` — an
        AccessTrace or an AccessSampler front-end)."""
        self.telemetry = recorder

    def _emit(self, seq_id: int, read_bytes: int = 0, write_bytes: int = 0,
              phase: str = "") -> None:
        if self.telemetry is not None and (read_bytes or write_bytes):
            self.telemetry.observe(f"seq{seq_id}", read_bytes, write_bytes,
                                   0.0, phase=phase)

    # ------------------------------------------------------------------ #
    # capacity accounting (occupancy reads/writes go through the ledger) #
    # ------------------------------------------------------------------ #
    def _obj(self, seq_id: int) -> str:
        return f"seq{seq_id}"

    @property
    def fast_block_budget(self) -> int:
        b = self.ledger.budget(self.tenant, FAST_KIND)
        return self.num_blocks if b is None else b // self.block_nbytes()

    @fast_block_budget.setter
    def fast_block_budget(self, n_blocks: int) -> None:
        self.ledger.set_budget(self.tenant, FAST_KIND,
                               int(n_blocks) * self.block_nbytes())

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    def free_block_count(self) -> int:
        return len(self._free)

    def used_block_count(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_on(self, kind: str) -> int:
        return self.ledger.bytes_on(kind, self.tenant) \
            // self.block_nbytes()

    def fast_used(self) -> int:
        return self.blocks_on(FAST_KIND)

    def occupancy(self) -> float:
        return self.used_block_count() / self.num_blocks

    def blocks_for_tokens(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.block_tokens))

    def block_nbytes(self) -> int:
        return self.spec.nbytes if self.spec is not None else 1

    # ------------------------------------------------------------------ #
    # alloc / free                                                       #
    # ------------------------------------------------------------------ #
    def can_alloc(self, n_blocks: int) -> bool:
        return len(self._free) >= n_blocks

    def alloc(self, seq_id: int, n_blocks: int = 1,
              kind=None) -> List[int]:
        """Append ``n_blocks`` fresh blocks to ``seq_id``'s table.

        ``kind`` may be a memory-kind string, ``None`` (pool default),
        or a zero-arg callable evaluated per block.
        """
        if n_blocks > len(self._free):
            raise PoolExhausted(
                f"need {n_blocks} blocks, {len(self._free)} free")
        tbl = self.table.setdefault(seq_id, [])
        self.seq_len.setdefault(seq_id, 0)
        out = []
        bn = self.block_nbytes()
        for _ in range(n_blocks):
            k = kind() if callable(kind) else kind
            bid = self._free.pop()
            b = self.blocks[bid]
            b.seq_id = seq_id
            b.logical_idx = len(tbl)
            b.kind = k or self.default_kind
            b.touch_count = 0
            b.last_touch_step = -(10 ** 9)
            tbl.append(bid)
            out.append(bid)
            self.counters.allocs += 1
            self.ledger.record_alloc(self.tenant, self._obj(seq_id),
                                     b.kind, bn)
        return out

    def free_seq(self, seq_id: int) -> int:
        """Release every block of a sequence; returns #blocks freed."""
        tbl = self.table.pop(seq_id, [])
        self.seq_len.pop(seq_id, None)
        if self.telemetry is not None:
            forget = getattr(self.telemetry, "forget", None)
            if forget is not None:
                forget(f"seq{seq_id}")
        for bid in tbl:
            b = self.blocks[bid]
            b.seq_id = None
            b.logical_idx = -1
            b.k = b.v = None
            self._free.append(bid)
            self.counters.frees += 1
        if tbl:
            self.ledger.retire(self.tenant, self._obj(seq_id))
        return len(tbl)

    def seq_blocks(self, seq_id: int) -> List[KVBlock]:
        return [self.blocks[bid] for bid in self.table.get(seq_id, [])]

    # ------------------------------------------------------------------ #
    # heat                                                               #
    # ------------------------------------------------------------------ #
    def touch_seq(self, seq_id: int, step: int) -> None:
        """Decode reads the whole block table of a sequence each step."""
        tbl = self.table.get(seq_id, [])
        for bid in tbl:
            b = self.blocks[bid]
            b.touch_count += 1
            b.last_touch_step = step
        self._emit(seq_id, read_bytes=len(tbl) * self.block_nbytes(),
                   phase="decode")

    # ------------------------------------------------------------------ #
    # payload I/O (data mode)                                            #
    # ------------------------------------------------------------------ #
    def _zeros(self, tokens: int, device=None) -> torch.Tensor:
        shape = list(self.spec.kv_shape)
        shape[2] = tokens
        return torch.zeros(shape, dtype=self.spec.torch_dtype,
                           device=device or self.device)

    def write_block(self, bid: int, k: torch.Tensor,
                    v: torch.Tensor) -> None:
        """Place (k, v) payloads on the block's current kind."""
        if self.spec is None:
            return
        if self.pooled:
            self.k_store[:, :, bid].copy_(k)
            self.v_store[:, :, bid].copy_(v)
            return
        b = self.blocks[bid]
        dt = self.spec.torch_dtype
        b.k = to_kind(k.to(dt).contiguous(), b.kind, self.device)
        b.v = to_kind(v.to(dt).contiguous(), b.kind, self.device)

    def write_prefill(self, seq_id: int, kv_k: torch.Tensor,
                      kv_v: torch.Tensor, n_tokens: int,
                      kind: Optional[str] = None) -> None:
        """Split a contiguous prefill cache into this sequence's blocks.

        kv_k/kv_v: (U, n_attn, n_tokens, KV, hd) — batch already squeezed.
        Allocates exactly the blocks the tokens need, on ``kind``.
        """
        bt = self.block_tokens
        n_blocks = self.blocks_for_tokens(n_tokens)
        bids = self.alloc(seq_id, n_blocks, kind=kind)
        if self.spec is not None:
            pad = n_blocks * bt - n_tokens
            if pad:
                kv_k = torch.cat([kv_k, self._zeros(pad, kv_k.device)], 2)
                kv_v = torch.cat([kv_v, self._zeros(pad, kv_v.device)], 2)
            for i, bid in enumerate(bids):
                self.write_block(bid, kv_k[:, :, i * bt:(i + 1) * bt],
                                 kv_v[:, :, i * bt:(i + 1) * bt])
        self.seq_len[seq_id] = n_tokens
        self._emit(seq_id, write_bytes=n_blocks * self.block_nbytes(),
                   phase="prefill")

    def append_token(self, seq_id: int, k_tok: torch.Tensor,
                     v_tok: torch.Tensor) -> None:
        """Write one new token's (k, v) at the tail of the sequence, in
        place.  k_tok/v_tok: (U, n_attn, KV, hd).  The caller must have
        allocated a tail block when ``seq_len % block_tokens == 0``."""
        n = self.seq_len[seq_id]
        tbl = self.table[seq_id]
        blk_idx, off = divmod(n, self.block_tokens)
        if blk_idx >= len(tbl):
            raise PoolExhausted(
                f"seq {seq_id}: token {n} has no tail block")
        if self.pooled:
            bid = tbl[blk_idx]
            self.k_store[:, :, bid, off].copy_(k_tok)
            self.v_store[:, :, bid, off].copy_(v_tok)
        elif self.spec is not None:
            b = self.blocks[tbl[blk_idx]]
            if b.k is None:            # fresh tail block
                z = self._zeros(self.block_tokens)
                b.k = to_kind(z, b.kind, self.device)
                b.v = to_kind(z.clone(), b.kind, self.device)
            b.k[:, :, off].copy_(k_tok)
            b.v[:, :, off].copy_(v_tok)
        self.seq_len[seq_id] = n + 1
        self._emit(seq_id,
                   write_bytes=max(self.block_nbytes()
                                   // self.block_tokens, 1),
                   phase="decode")

    def gather_seq(self, seq_id: int, pad_blocks: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Contiguous (k, v) on the device, padded to ``pad_blocks``.

        Returns (k, v) of shape (U, n_attn, pad_blocks*bt, KV, hd).
        Every block's copy is issued before the concatenation; copies
        from pinned memory are ``non_blocking`` and overlap each other.
        """
        assert self.spec is not None, "gather_seq needs a data-mode pool"
        tbl = self.table.get(seq_id, [])
        n_pad = pad_blocks - len(tbl)
        if n_pad < 0:
            raise ValueError(f"seq {seq_id} has {len(tbl)} blocks "
                             f"> pad_blocks={pad_blocks}")
        bt = self.block_tokens
        if not tbl:
            z = self._zeros(pad_blocks * bt)
            return z, z.clone()
        if self.pooled:
            # staging copy out of the pooled stores (the copy the fused
            # path avoids); positions past seq_len may hold a prior
            # owner's stale tokens — every consumer masks by kv_len
            idx = torch.as_tensor(tbl, dtype=torch.int64,
                                  device=self.device)

            def take(store):
                g = store.index_select(2, idx)
                g = g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])
                if n_pad:
                    g = torch.cat([g, self._zeros(n_pad * bt)], 2)
                return g

            return take(self.k_store), take(self.v_store)
        ks, vs = [], []
        for bid in tbl:
            b = self.blocks[bid]
            if b.k is None:            # allocated tail block, not written
                ks.append(self._zeros(bt))
                vs.append(self._zeros(bt))
            else:
                ks.append(to_kind(b.k, FAST_KIND, self.device,
                                  non_blocking=True))
                vs.append(to_kind(b.v, FAST_KIND, self.device,
                                  non_blocking=True))
        if n_pad:
            ks.append(self._zeros(n_pad * bt))
            vs.append(self._zeros(n_pad * bt))
        return torch.cat(ks, dim=2), torch.cat(vs, dim=2)

    def gather_tables(self, seq_ids: Sequence[int], pad_blocks: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Block-index tables for the fused decode kernel.

        Returns ``(tables, lens)``: int32 ``(len(seq_ids), pad_blocks)``
        physical block ids in logical order (pad slots hold block 0 —
        masked by ``lens``), and the per-sequence cached token counts.
        """
        if not self.pooled:
            raise ValueError("gather_tables needs a pooled-layout pool")
        tables = np.zeros((len(seq_ids), pad_blocks), np.int32)
        lens = np.zeros((len(seq_ids),), np.int32)
        for i, sid in enumerate(seq_ids):
            tbl = self.table.get(sid, [])
            if len(tbl) > pad_blocks:
                raise ValueError(f"seq {sid} has {len(tbl)} blocks "
                                 f"> pad_blocks={pad_blocks}")
            tables[i, :len(tbl)] = tbl
            lens[i] = self.seq_len.get(sid, 0)
        return tables, lens

    # ------------------------------------------------------------------ #
    # migration                                                          #
    # ------------------------------------------------------------------ #
    def migrate(self, bid: int, kind: str) -> bool:
        """Move one block to ``kind``; returns False if it's a no-op.
        Promotions are gated by the ledger (``can_place``)."""
        b = self.blocks[bid]
        if b.free or b.kind == kind:
            return False
        bn = self.block_nbytes()
        was_fast = b.kind == FAST_KIND
        if kind == FAST_KIND and not was_fast:
            if not self.ledger.can_place(self.tenant, FAST_KIND, bn):
                return False
            self.counters.promoted += 1
        elif was_fast and kind != FAST_KIND:
            self.counters.demoted += 1
        self.ledger.record_move(self.tenant, self._obj(b.seq_id),
                                b.kind, kind, bn)
        b.kind = kind
        self.counters.migrated_bytes += bn
        # the pooled layout keeps payloads in place (residency is the
        # ledger's); per-block payloads move to the new kind
        if self.spec is not None and not self.pooled and b.k is not None:
            b.k = to_kind(b.k, kind, self.device)
            b.v = to_kind(b.v, kind, self.device)
        return True

    # ------------------------------------------------------------------ #
    # defrag                                                             #
    # ------------------------------------------------------------------ #
    def defrag(self) -> int:
        """Compact live blocks to the lowest physical ids, keeping each
        sequence's blocks contiguous and in logical order.  Payloads and
        residency move with the block.  Returns #blocks relocated."""
        live: List[KVBlock] = []
        for seq_id in sorted(self.table):
            live.extend(self.blocks[bid] for bid in self.table[seq_id])
        moved = 0
        new_blocks = [KVBlock(bid=i, kind=self.default_kind)
                      for i in range(self.num_blocks)]
        new_table: Dict[int, List[int]] = {s: [] for s in self.table}
        for i, old in enumerate(live):
            nb = new_blocks[i]
            if old.bid != i:
                moved += 1
            nb.kind = old.kind
            nb.seq_id = old.seq_id
            nb.logical_idx = old.logical_idx
            nb.k, nb.v = old.k, old.v
            nb.touch_count = old.touch_count
            nb.last_touch_step = old.last_touch_step
            new_table[old.seq_id].append(i)
        if self.pooled and live:
            # permute the store rows with the block ids so slot i still
            # holds the payload of the block now labelled i
            perm = [old.bid for old in live]
            taken = set(perm)
            rest = [i for i in range(self.num_blocks) if i not in taken]
            idx = torch.as_tensor(perm + rest, dtype=torch.int64,
                                  device=self.device)
            self.k_store = self.k_store.index_select(2, idx)
            self.v_store = self.v_store.index_select(2, idx)
        self.blocks = new_blocks
        self.table = new_table
        self._free = list(range(self.num_blocks - 1, len(live) - 1, -1))
        self.counters.defrags += 1
        return moved


def spec_from_config(cfg, block_tokens: int) -> KVBlockSpec:
    """Derive the pool block spec from a ModelConfig (attn layers only)."""
    n_attn = len(cfg.unit_attn_layers)
    if n_attn == 0:
        raise ValueError(f"{cfg.name}: no attention layers to page")
    dtype = "int8" if cfg.kv_cache_dtype == "int8" else "bfloat16"
    return KVBlockSpec(n_units=cfg.n_units, n_attn=n_attn,
                       block_tokens=block_tokens, n_kv=cfg.n_kv,
                       head_dim=cfg.head_dim, dtype=dtype)
