"""Memory kinds on a CUDA host, and ``TieredArray``: block-granular
placement of one tensor across them (counterpart of
``repro.core.tiered_array``).

Memory kinds, the mapping of the reference's ``sharding_for_kind``:

  * ``device``        -> the engine's CUDA device (HBM);
  * ``pinned_host``   -> page-locked CPU memory (``pin_memory``), the
                         CXL-class capacity tier the card reaches by DMA;
  * ``unpinned_host`` -> pageable CPU memory.

Under ``device="cpu"`` all three kinds are logical, as the reference
makes them on a single-memory CPU host: tensors stay in CPU memory and
placement is bookkeeping only.  The paged KV pool places its blocks
with ``to_kind``; the training engine keeps its fp32 optimizer state
and its gradient buffers as ``TieredArray``s.

``TieredArray`` splits a tensor into blocks along axis 0 and keeps each
block on one kind (the paper's page interleaving, at block grain):

  ta = TieredArray.place(x, [("device", .5), ("pinned_host", .5)])
  y  = ta.gather()          # the whole tensor in device memory
  it = ta.prefetch_blocks() # the blocks in device memory, one at a time,
                            # block i+1's copy in flight while i is used
  ta.move_block(i, kind)    # re-place one block onto another kind
  ta.update(new_x)          # write back into the same blocks, in place

Unlike the reference, whose ``update`` re-places every block, ``update``
copies into the blocks it already has: re-allocating gigabytes of pinned
memory every optimizer step would dominate the step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree

LOGICAL_KINDS = ("device", "pinned_host", "unpinned_host")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Raises when CUDA is asked for (or implied) and there
    is none — the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (--device cpu) to run on the "
                               "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_kind(t: torch.Tensor, kind: str, device: torch.device,
            non_blocking: bool = False) -> torch.Tensor:
    """``t`` placed on memory kind ``kind`` of an engine on ``device``
    (returns ``t`` itself when it already lives there).

    Copies into host memory are blocking, so a host-resident payload is
    complete when this returns.  ``non_blocking`` applies to copies onto
    the device; from pinned memory they overlap with host work.
    """
    _check_kind(kind)
    if device.type != "cuda":
        return t.cpu()                       # logical kinds
    if kind == "device":
        return t.to(device, non_blocking=non_blocking)
    if t.device.type == "cpu" and t.is_pinned() == (kind == "pinned_host"):
        return t
    out = empty_on(kind, t.shape, t.dtype, device)
    out.copy_(t)
    return out


def _check_kind(kind: str) -> None:
    if kind not in LOGICAL_KINDS:
        raise ValueError(f"unknown memory kind {kind!r}; "
                         f"choose from {LOGICAL_KINDS}")


def empty_on(kind: str, shape, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """An uninitialized tensor on memory kind ``kind`` of an engine on
    ``device`` (CPU memory for every kind under a CPU engine)."""
    _check_kind(kind)
    if device.type != "cuda":
        return torch.empty(shape, dtype=dtype)
    if kind == "device":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.empty(shape, dtype=dtype,
                       pin_memory=kind == "pinned_host")


# ====================================================================== #
# TieredArray                                                            #
# ====================================================================== #
Share = Tuple[str, float]  # (memory kind, fraction)

# Map tier names (core.tiers) to memory kinds on the accelerator host.
TIER_TO_MEMORY_KIND = {
    "HBM": "device",
    "LDRAM": "device",          # in paper-system replays the fast tier
    "HOST": "pinned_host",
    "RDRAM": "pinned_host",
    "CXL": "unpinned_host",
    "ICI_PEER": "device",
    "HOST_UNPINNED": "unpinned_host",
    "NVMe": "unpinned_host",
}


@dataclasses.dataclass
class TieredArray:
    """A tensor split into per-memory-kind blocks along axis 0, for an
    engine on ``device``."""

    blocks: List[torch.Tensor]    # in order, cat along axis 0 == tensor
    kinds: List[str]              # memory kind of each block
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device

    # ------------------------------------------------------------------ #
    @staticmethod
    def plan_blocks(n_rows: int, shares: Sequence[Share],
                    block_rows: Optional[int] = None
                    ) -> List[Tuple[int, int, str]]:
        """Compute (start, stop, kind) block spans for the share list.

        With `block_rows` set, shares are realized round-robin at block
        granularity (true interleaving); otherwise each share is one
        contiguous span (numactl membind-style).
        """
        shares = [(k, f) for k, f in shares if f > 0]
        if not shares:
            raise ValueError("empty share list")
        total_f = sum(f for _, f in shares)
        shares = [(k, f / total_f) for k, f in shares]
        if block_rows is None:
            spans = []
            start = 0
            for i, (k, f) in enumerate(shares):
                stop = n_rows if i == len(shares) - 1 else min(
                    n_rows, start + max(1, int(round(f * n_rows))))
                if stop > start:
                    spans.append((start, stop, k))
                start = stop
            return spans
        # round-robin interleave at block_rows granularity, weighted by f
        n_blocks = math.ceil(n_rows / block_rows)
        seq: List[str] = []
        counts = {k: 0.0 for k, _ in shares}
        for _ in range(n_blocks):
            # pick kind with largest deficit vs target fraction
            k = max(shares, key=lambda kf: kf[1] * (len(seq) + 1)
                    - counts[kf[0]])[0]
            seq.append(k)
            counts[k] += 1.0
        spans = []
        for i, k in enumerate(seq):
            a, b = i * block_rows, min((i + 1) * block_rows, n_rows)
            spans.append((a, b, k))
        return spans

    @classmethod
    def alloc(cls, shape, dtype: torch.dtype, shares: Sequence[Share],
              block_rows: Optional[int] = None, *,
              device: DeviceLike = None, zero: bool = False
              ) -> "TieredArray":
        """Blocks for a tensor of ``shape`` placed by ``shares``,
        uninitialized unless ``zero`` (a 0-d shape is placed as (1,), as
        the reference does)."""
        dev = resolve_device(device)
        shape = tuple(shape) or (1,)
        blocks, kinds = [], []
        for a, b, kind in cls.plan_blocks(shape[0], shares, block_rows):
            blk = empty_on(kind, (b - a, *shape[1:]), dtype, dev)
            blocks.append(blk.zero_() if zero else blk)
            kinds.append(kind)
        return cls(blocks, kinds, shape, dtype, dev)

    @classmethod
    def place(cls, x: torch.Tensor, shares: Sequence[Share],
              block_rows: Optional[int] = None, *,
              device: DeviceLike = None) -> "TieredArray":
        """A copy of ``x`` placed by ``shares`` (never a view of ``x``)."""
        x = torch.as_tensor(x)
        return cls.alloc(x.shape, x.dtype, shares, block_rows,
                         device=device).update(x)

    @classmethod
    def from_plan(cls, x: torch.Tensor,
                  tier_shares: Sequence[Tuple[str, float]],
                  block_rows: Optional[int] = None, *,
                  device: DeviceLike = None) -> "TieredArray":
        """Place using core.tiers tier *names* (mapped to memory kinds)."""
        merged: Dict[str, float] = {}
        for t, f in tier_shares:
            k = TIER_TO_MEMORY_KIND.get(t, "device")
            merged[k] = merged.get(k, 0.0) + f
        return cls.place(x, list(merged.items()), block_rows, device=device)

    # ------------------------------------------------------------------ #
    def gather(self) -> torch.Tensor:
        """The whole tensor in device memory.  One block that already
        lives there is returned itself (treat it as read-only); otherwise
        every block is copied into a new tensor, asynchronously from
        pinned memory (stream-ordered before any later use)."""
        if len(self.blocks) == 1 and self.blocks[0].device == self.device:
            return self.blocks[0].reshape(self.shape)
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        start = 0
        for blk in self.blocks:
            stop = start + blk.shape[0]
            out[start:stop].copy_(blk, non_blocking=True)
            start = stop
        return out

    def prefetch_blocks(self) -> Iterator[torch.Tensor]:
        """The blocks in device memory, in order: block i+1's copy is
        issued on a side stream before block i is handed out, so it is
        in flight while block i is used (the ZeRO-Offload bucket
        pipeline).  A block already in device memory is handed out
        itself (treat it as read-only).  Each copy is made ready for
        the current stream before it is yielded.  Under a CPU engine
        the blocks are handed out as they are."""
        if self.device.type != "cuda":
            yield from self.blocks
            return
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)

        def issue(blk):
            if blk.device == self.device:
                return blk, None
            side.wait_stream(main)      # the block's last writes first
            with torch.cuda.stream(side):
                out = blk.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
            return out, done

        nxt = issue(self.blocks[0])
        for i in range(len(self.blocks)):
            cur, done = nxt
            if i + 1 < len(self.blocks):
                nxt = issue(self.blocks[i + 1])
            if done is not None:
                main.wait_event(done)
                cur.record_stream(main)
            yield cur

    def move_block(self, i: int, kind: str) -> int:
        """Re-place block ``i`` onto memory kind ``kind``: a copy into a
        new block of that kind (device, pinned or pageable host memory;
        CPU memory for every kind under a CPU engine).  Returns the
        bytes moved (0 when the block already lives there)."""
        if self.kinds[i] == kind:
            return 0
        blk = self.blocks[i]
        new = empty_on(kind, blk.shape, blk.dtype, self.device)
        new.copy_(blk)
        self.blocks[i] = new
        self.kinds[i] = kind
        per_row = self.nbytes // max(self.shape[0], 1)
        return blk.shape[0] * per_row

    def update(self, x: torch.Tensor, non_blocking: bool = False
               ) -> "TieredArray":
        """Write a new value into the existing blocks, in place, keeping
        the placement; returns ``self``.  With ``non_blocking``, copies
        from the device into pinned blocks are only enqueued: the blocks
        hold the new value after the next synchronize."""
        x = x.reshape(self.shape)
        start = 0
        for blk in self.blocks:
            stop = start + blk.shape[0]
            blk.copy_(x[start:stop], non_blocking=non_blocking)
            start = stop
        return self

    # ------------------------------------------------------------------ #
    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def bytes_on(self, kind: str) -> int:
        per_row = self.nbytes // max(self.shape[0], 1)
        return sum(b.shape[0] * per_row
                   for b, k in zip(self.blocks, self.kinds) if k == kind)

    def fast_fraction(self) -> float:
        return self.bytes_on("device") / max(self.nbytes, 1)


def place_pytree(tree, shares_fn, block_rows: Optional[int] = None, *,
                 device: DeviceLike = None):
    """Place every leaf of a tree: shares_fn(path, leaf) -> share list."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    placed = []
    for path, leaf in flat:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        placed.append(TieredArray.place(leaf, shares_fn(name, leaf),
                                        block_rows, device=device))
    return pytree.tree_unflatten(placed, spec)


def gather_pytree(tree):
    return pytree.tree_map(
        lambda t: t.gather() if isinstance(t, TieredArray) else t, tree)
