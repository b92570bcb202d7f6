"""Partition-spec rules of the port: params / optimizer state / cache /
inputs (counterpart of ``repro.models.shardings``).

Layout (the reference's):
  mesh axes: ("pod", "data", "model") multi-pod, ("data", "model") single.
  * DP over pod+data for the batch;
  * FSDP over "data" for parameter storage (all-gathered per scanned unit);
  * TP over "model" for heads / d_ff / experts / vocab.

Every rule is validated against divisibility: a dimension that does not
divide by its assigned axis size is silently replicated instead (e.g.
25 GPT-2 heads over 16-way TP), keeping all (arch x mesh) combinations
valid.

The rules read only shapes and the mesh's ``axis_names`` and
``devices.shape``: they take a tree of tensors, fake tensors (built
under ``torch._subclasses.fake_tensor.FakeTensorMode``, the counterpart
of ``jax.eval_shape``) or anything with a ``shape``, so they run at
production mesh shapes without the devices.

A leaf placed on a mesh of more than one device (``to_named`` for
training, ``cluster.sharding.shard_lm_params`` for serving) is a
:class:`ShardedTensor`, the counterpart of a ``jax.Array`` with a
``NamedSharding``: one local tensor per mesh device.  One process drives
every device of the mesh:

* a split dimension gives each device its block (``shard_tensor``: a
  view of the source where the source lives on that device; for
  training, ``to_named``, a contiguous copy, so each block is its own
  tensor a kernel can take);
* a replicated leaf is kept once per physical device, shared by the
  logical devices on it;
* work on replicated operands runs once, on the mesh's first device;
  sums, gathers and maxima across shards are plain tensor ops there,
  after ``.to(first)`` (in-device on one card, a device-to-device copy
  across cards).

The helpers after it are the few places the model and the serving
engine read a split leaf: :func:`embed_rows` and :func:`vocab_logits`
(``vocab``), :func:`argmax` over vocab shards, :func:`expert_blocks`
(``experts``), :func:`gather` and :func:`compute_view`.  Training reads
one through :func:`local_view`: the global batch splits into
:func:`data_shards` (``batch_pspec``), and each shard gathers a unit's
leaves onto its own devices just before the unit runs (FSDP per
scanned unit), by ``torch.cat`` of the blocks, so that the backward
hands each block the gradient of its part, summed over the data shards
that gathered it (the reduce-scatter).  :func:`per_shard` runs a
function once per distinct block of placed leaves (the optimizer).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.tiered_array import to_kind
from ..launch.mesh import Mesh

F = "__fsdp__"   # placeholder resolved to the fsdp axis
T = "__tp__"     # placeholder resolved to the tp axis


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of
    names, or None (replicated), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# (parent, leaf-name) -> base spec (without the stacked-unit leading axis).
# Fallback: replicate.
_RULES: Dict[Tuple[str, str], Tuple] = {
    ("*", "embed"): (T, F),
    ("*", "lm_head"): (T, F),
    ("*", "pos_emb"): (None, F),
    # attention
    ("attn", "wq"): (F, T), ("attn", "wk"): (F, T), ("attn", "wv"): (F, T),
    ("attn", "wo"): (T, F),
    ("attn", "bq"): (T,), ("attn", "bk"): (T,), ("attn", "bv"): (T,),
    ("cross", "wq"): (F, T), ("cross", "wk"): (F, T),
    ("cross", "wv"): (F, T), ("cross", "wo"): (T, F),
    ("cross", "bq"): (T,), ("cross", "bk"): (T,), ("cross", "bv"): (T,),
    ("xkv", "wk"): (F, T), ("xkv", "wv"): (F, T),
    # dense MLP
    ("mlp", "w_gate"): (F, T), ("mlp", "w_up"): (F, T),
    ("mlp", "w_down"): (T, F),
    # MoE (experts over TP = expert parallelism)
    ("moe", "router"): (F, None),
    ("moe", "w_gate"): (T, F, None), ("moe", "w_up"): (T, F, None),
    ("moe", "w_down"): (T, None, F),
    # mamba
    ("mamba", "w_in"): (F, T), ("mamba", "w_out"): (T, F),
    ("mamba", "conv_w"): (None, T), ("mamba", "conv_b"): (T,),
    ("mamba", "A_log"): (T,), ("mamba", "D"): (T,),
    ("mamba", "dt_bias"): (T,),
    ("norm", "scale"): (T,),   # mamba-internal norm over d_inner
    # rwkv time-mix
    ("tmix", "wr"): (F, T), ("tmix", "wk"): (F, T), ("tmix", "wv"): (F, T),
    ("tmix", "wg"): (F, T), ("tmix", "wo"): (T, F),
    ("tmix", "wA"): (F, None), ("tmix", "wB"): (None, T),
    ("tmix", "w0"): (T,), ("tmix", "u"): (T, None),
    ("ln_x", "scale"): (T,), ("ln_x", "bias"): (T,),
    # rwkv channel-mix
    ("cmix", "wk"): (F, T), ("cmix", "wv"): (T, F),
}


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) or isinstance(
        x, PartitionSpec)


def _map_with_path(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts, lists and
    tuples, keys as strings (list and tuple indices as digits), the
    containers rebuilt (``jax.tree_util.tree_map_with_path``)."""
    if _is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], *(r[k] for r in rest),
                                  path=path + (str(k),))
                for k in tree}
    return type(tree)(_map_with_path(fn, v, *(r[i] for r in rest),
                                     path=path + (str(i),))
                      for i, v in enumerate(tree))


def _base_spec(keys: Tuple[str, ...]) -> Optional[Tuple]:
    name = keys[-1]
    parents = [k for k in keys[:-1] if not k.isdigit()]
    parent = parents[-1] if parents else "*"
    if (parent, name) in _RULES:
        return _RULES[(parent, name)]
    if ("*", name) in _RULES:
        return _RULES[("*", name)]
    return None


def _fit(shape, spec, mesh, fsdp: Optional[str], tp: str) -> P:
    """Resolve placeholders + drop axes that don't divide the dim."""
    axis_size = _axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, spec):
        ax = {F: fsdp, T: tp}.get(ax, ax)
        if ax is None or ax not in axis_size or dim % axis_size[ax] != 0:
            out.append(None)
        else:
            out.append(ax)
    return P(*out)


def param_pspecs(param_shapes: Any, mesh, fsdp: Optional[str] = "data",
                 tp: str = "model") -> Any:
    """PartitionSpec tree mirroring the params (tensors or fake
    tensors).

    fsdp=None replicates over the data axes (inference sharding: weights
    stay resident, no per-step all-gather)."""

    def spec_of(keys, leaf):
        base = _base_spec(keys)
        stacked = "units" in keys
        nd = len(leaf.shape)
        if base is None:
            return P(*([None] * nd))
        if stacked:
            base = (None,) + tuple(base)
        base = tuple(base) + (None,) * (nd - len(base))
        base = base[:nd]
        return _fit(leaf.shape, base, mesh, fsdp, tp)

    return _map_with_path(spec_of, param_shapes)


def opt_state_pspecs(param_specs: Any, mesh) -> Dict[str, Any]:
    """Adam state specs: master/m/v/err shaped like params; scalar step."""
    return {
        "master": param_specs, "m": param_specs, "v": param_specs,
        "step": P(),
    }


def cache_pspecs(cache_shapes: Any, mesh, batch: int,
                 dp_axes: Tuple[str, ...], tp: str = "model") -> Any:
    """Decode-cache specs.

    Two regimes:
      * batch divisible by DP  -> batch-sharded cache, kv-heads over TP if
        divisible (falls back to seq over TP);
      * batch=1 long-context   -> sequence-parallel cache: seq dim sharded
        over (dp + tp) — flash-decode with partial-softmax collectives.
    """
    axis_size = _axis_sizes(mesh)
    dp = [a for a in dp_axes if a in axis_size]
    dp_total = 1
    for a in dp:
        dp_total *= axis_size[a]
    batch_ok = batch % dp_total == 0

    def spec_of(keys, leaf):
        name = keys[0] if keys else ""
        if name == "index":       # the port's cache index is an int
            return P()
        nd = len(leaf.shape)
        if name in ("kv_k_scale", "kv_v_scale"):
            # (U, n, B, S, KV) — follows the value cache's regime
            U, n, B, S, KV = leaf.shape
            if batch_ok:
                kv_ax = tp if KV % axis_size.get(tp, 1) == 0 else None
                seq_ax = None if kv_ax else (
                    tp if S % axis_size.get(tp, 1) == 0 else None)
                return P(None, None, tuple(dp), seq_ax, kv_ax)
            seq_axes = tuple(dp) + ((tp,) if tp in axis_size else ())
            total = 1
            for a in seq_axes:
                total *= axis_size[a]
            if S % total == 0:
                return P(None, None, None, seq_axes, None)
            return P(*([None] * nd))
        if name in ("kv_k", "kv_v", "cross_k", "cross_v"):
            # (U, n, B, S, KV, hd)
            U, n, B, S, KV, hd = leaf.shape
            if batch_ok:
                kv_ax = tp if KV % axis_size.get(tp, 1) == 0 else None
                seq_ax = None if kv_ax else (
                    tp if S % axis_size.get(tp, 1) == 0 else None)
                return P(None, None, tuple(dp), seq_ax, kv_ax, None)
            seq_axes = tuple(dp) + ((tp,) if tp in axis_size else ())
            total = 1
            for a in seq_axes:
                total *= axis_size[a]
            if S % total == 0:
                return P(None, None, None, seq_axes, None, None)
            if S % dp_total == 0:
                return P(None, None, None, tuple(dp), None, None)
            return P(*([None] * nd))
        if name in ("ssm", "wkv"):
            # (U, n, B, H, N, P) / (U, n, B, H, hd, hd)
            U, n, B, H, _, _ = leaf.shape
            b_ax = tuple(dp) if batch_ok else None
            h_ax = tp if H % axis_size.get(tp, 1) == 0 else None
            return P(None, None, b_ax, h_ax, None, None)
        if name == "conv":
            # (U, n, B, K-1, d_inner)
            U, n, B, K1, di = leaf.shape
            b_ax = tuple(dp) if batch_ok else None
            d_ax = tp if di % axis_size.get(tp, 1) == 0 else None
            return P(None, None, b_ax, None, d_ax)
        if name in ("shift_t", "shift_c"):
            U, n, B, D = leaf.shape
            b_ax = tuple(dp) if batch_ok else None
            return P(None, None, b_ax, None)
        return P(*([None] * nd))

    return _map_with_path(spec_of, cache_shapes)


def batch_pspec(batch: int, mesh, dp_axes: Tuple[str, ...]) -> P:
    axis_size = _axis_sizes(mesh)
    dp = [a for a in dp_axes if a in axis_size]
    total = 1
    for a in dp:
        total *= axis_size[a]
    if batch % total == 0:
        return P(tuple(dp))
    # try the first axis alone
    if dp and batch % axis_size[dp[0]] == 0:
        return P(dp[0])
    return P(None)


def _spec_devices(spec, mesh) -> int:
    """How many devices ``spec`` splits a tensor over on ``mesh``."""
    sizes = _axis_sizes(mesh)
    n = 1
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n *= sizes[a]
    return n


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A placement: ``spec`` on ``mesh`` (``jax.sharding.NamedSharding``);
    a leaf of a placement tree (``checkpoint.store.restore``)."""

    mesh: Mesh
    spec: PartitionSpec

    def place(self, t: torch.Tensor):
        """``t`` on the mesh under the spec: on the mesh's first device
        for a one-device mesh or a 0-d ``t`` (the optimizer's step),
        else a :class:`ShardedTensor` of contiguous blocks
        (``shard_tensor``)."""
        if self.mesh.size == 1 or t.dim() == 0:
            dev = self.mesh.first_device
            return t if t.device == dev else t.to(dev)
        return shard_tensor(t, self.mesh, self.spec, contiguous=True)


def named_shardings(specs, mesh) -> Any:
    """The spec tree as a tree of :class:`NamedSharding` on ``mesh``."""
    return _map_with_path(lambda keys, s: NamedSharding(mesh, s), specs)


def to_named(tree, specs, mesh, memory_kind: Optional[str] = None):
    """``tree`` placed on ``mesh`` under ``specs`` (a spec tree mirroring
    it, e.g. ``param_pspecs``).  On a mesh of one device every leaf goes
    to that device and, with ``memory_kind``, to that memory kind
    (``core.tiered_array`` kinds); a leaf already there is returned as
    it is.  On a larger mesh every tensor leaf but a 0-d one becomes a
    :class:`ShardedTensor` of contiguous blocks, each on its device (and
    memory kind); the source is not kept, so placement adds 0 B once
    the caller drops it."""

    def place(keys, leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        placed = NamedSharding(mesh, spec).place(leaf)
        if memory_kind is None:
            return placed
        return per_shard(lambda t: to_kind(t, memory_kind, t.device),
                         placed)

    return _map_with_path(place, tree, specs)


# ---------------------------------------------------------------------- #
# sharded tensors                                                         #
# ---------------------------------------------------------------------- #
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class ShardedTensor:
    """A tensor split over a mesh: its global ``shape``, its ``spec``
    (a ``PartitionSpec`` of one entry per dimension), the ``mesh``, and
    ``shards``, one local tensor per mesh device in ``mesh.devices.flat``
    order.  Entries on one physical device that hold the same block are
    one tensor."""

    def __init__(self, shape, spec, mesh: Mesh, shards: Sequence):
        self.shape = torch.Size(shape)
        self.spec = PartitionSpec(*(tuple(spec)
                                    + (None,) * (len(shape) - len(spec))))
        self.mesh = mesh
        self.shards = list(shards)
        if len(self.spec) != len(self.shape) or \
                len(self.shards) != mesh.size:
            raise ValueError(f"spec {self.spec} / {len(self.shards)} "
                             f"shards for shape {tuple(self.shape)} on "
                             f"a mesh of {mesh.size}")

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """The mesh's first device, where replicated work runs."""
        return self.mesh.first_device

    def parts(self, dim: int) -> int:
        """How many blocks dimension ``dim`` is split into."""
        sizes = dict(self.mesh.shape)
        return math.prod(sizes[a] for a in _axes(self.spec[dim]))

    @property
    def is_split(self) -> bool:
        return any(self.parts(d) > 1 for d in range(self.ndim))

    def block_of(self, i: int, dim: int) -> Tuple[int, int]:
        """The global [lo, hi) of mesh device ``i``'s block along
        ``dim``."""
        names = _axes(self.spec[dim])
        pos = np.unravel_index(i, self.mesh.devices.shape)
        sizes = dict(self.mesh.shape)
        axis = {a: k for k, a in enumerate(self.mesh.axis_names)}
        b = 0
        for a in names:
            b = b * sizes[a] + int(pos[axis[a]])
        n = self.shape[dim] // self.parts(dim)
        return b * n, (b + 1) * n

    def blocks(self, dim: int) -> List[Tuple[int, int, torch.device,
                                             torch.Tensor]]:
        """(lo, hi, device, local) of each distinct block along ``dim``,
        in ascending order, each from the first mesh device holding it."""
        seen: Dict[Tuple[int, int], tuple] = {}
        for i, local in enumerate(self.shards):
            lo, hi = self.block_of(i, dim)
            if (lo, hi) not in seen:
                seen[(lo, hi)] = (lo, hi, self.mesh.devices.flat[i], local)
        return [seen[k] for k in sorted(seen)]

    def shard_shapes(self) -> List[Tuple[int, ...]]:
        return [tuple(t.shape) for t in self.shards]

    def block_key(self, i: int) -> Tuple[Tuple[int, int], ...]:
        """Mesh device ``i``'s block: its global [lo, hi) per dim."""
        return tuple(self.block_of(i, d) for d in range(self.ndim))

    def distinct_blocks(self) -> Dict[tuple, List[torch.Tensor]]:
        """Block key -> the distinct tensors holding that block (one per
        physical device that holds it), in mesh order."""
        out: Dict[tuple, List[torch.Tensor]] = {}
        for i, local in enumerate(self.shards):
            ts = out.setdefault(self.block_key(i), [])
            if all(t is not local for t in ts):
                ts.append(local)
        return out

    def __getitem__(self, i: int) -> "ShardedTensor":
        """Index the leading dimension (the stacked units), which must
        not be split."""
        if not isinstance(i, int) or self.parts(0) > 1:
            raise IndexError(f"a ShardedTensor indexes only an unsplit "
                             f"leading dimension (spec {self.spec})")
        views: Dict[int, torch.Tensor] = {}
        shards = [views.setdefault(id(t), t[i]) for t in self.shards]
        return ShardedTensor(self.shape[1:], self.spec[1:], self.mesh,
                             shards)

    def full(self) -> torch.Tensor:
        """The whole tensor on the first device: the first shard of a
        leaf that nothing splits, else its blocks assembled there."""
        if not self.is_split:
            return self.shards[0]
        first = self.device
        out = torch.empty(self.shape, dtype=self.dtype, device=first)
        for i, local in enumerate(self.shards):
            idx = tuple(slice(*self.block_of(i, d))
                        for d in range(self.ndim))
            out[idx] = local.to(first)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"spec={self.spec}, shards={self.shard_shapes()})")


def shard_tensor(t: torch.Tensor, mesh: Mesh, spec,
                 contiguous: bool = False) -> ShardedTensor:
    """Place ``t`` on ``mesh`` under ``spec`` (padded with None to
    ``t.ndim``).  Each mesh device gets its block: a view of ``t`` where
    ``t`` lives on that device (``t`` itself where nothing splits), else
    the block copied there once per physical device.  With
    ``contiguous`` a block that is not the whole of ``t`` is always a
    contiguous copy of its own."""
    shell = ShardedTensor(t.shape, spec, mesh, [t] * mesh.size)
    spec = shell.spec
    for d in range(t.ndim):
        if t.shape[d] % shell.parts(d):
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"into {shell.parts(d)} under {spec}")
    made: Dict[tuple, torch.Tensor] = {}
    shards = []
    for i, dev in enumerate(mesh.devices.flat):
        idx = tuple(shell.block_of(i, d) for d in range(t.ndim))
        key = (dev, idx)
        if key not in made:
            whole = all(hi - lo == t.shape[d]
                        for d, (lo, hi) in enumerate(idx))
            local = t if whole else t[tuple(slice(*b) for b in idx)]
            if local.device != dev:
                local = local.to(dev)
            elif contiguous and not whole:
                local = local.clone(memory_format=torch.contiguous_format)
            made[key] = local
        shards.append(made[key])
    return ShardedTensor(t.shape, spec, mesh, shards)


def is_split(t) -> bool:
    return isinstance(t, ShardedTensor) and t.is_split


def gather(t) -> torch.Tensor:
    """``t`` whole on the first device (a plain tensor as it is)."""
    return t.full() if isinstance(t, ShardedTensor) else t


def compute_view(tree):
    """The tree the model computes on: a leaf split over more than one
    block stays a ``ShardedTensor``; every other placed leaf is its
    first device's local (the whole tensor)."""
    def view(path, leaf):
        if isinstance(leaf, ShardedTensor) and not leaf.is_split:
            return leaf.shards[0]
        return leaf
    return _map_with_path(view, tree)


def embed_rows(W, tokens: torch.Tensor) -> torch.Tensor:
    """``W[tokens]`` for an embedding table (V, D).  Split over vocab,
    each block looks up the ids in its own range and writes zeros
    elsewhere, and the blocks are summed on the first device: exact,
    since one term per token is nonzero."""
    if not is_split(W):
        return gather(W)[tokens]
    first, out = W.device, None
    for lo, hi, dev, local in W.blocks(0):
        ids = tokens.to(dev)
        mine = (ids >= lo) & (ids < hi)
        rows = local[torch.clamp(ids - lo, 0, hi - lo - 1)]
        rows = torch.where(mine[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=dev)).to(first)
        out = rows if out is None else out + rows
    return out


def vocab_logits(x: torch.Tensor, W):
    """fp32 logits ``x @ W.T`` of a (V, D) head.  Split over vocab: a
    ``ShardedTensor`` (..., V) of each block's logits on its device (see
    :func:`argmax`, :func:`gather`)."""
    if not is_split(W):
        return (x @ gather(W).T).float()
    shape = tuple(x.shape[:-1]) + (W.shape[0],)
    lead = (None,) * (x.ndim - 1)
    done: Dict[int, torch.Tensor] = {}
    shards = [done.setdefault(id(w), (x.to(w.device) @ w.T).float())
              for w in W.shards]
    return ShardedTensor(shape, lead + (W.spec[0],), W.mesh, shards)


def argmax(logits) -> torch.Tensor:
    """Greedy argmax over the last dimension, on the first device.
    Over vocab shards: each block's (max, index + its offset), then the
    largest value, the lowest index on ties; this equals
    ``torch.argmax`` over the whole row."""
    if not is_split(logits):
        return torch.argmax(gather(logits), dim=-1)
    first, vals, idxs = logits.device, [], []
    for lo, _, _, local in logits.blocks(logits.ndim - 1):
        i = torch.argmax(local, dim=-1, keepdim=True)
        vals.append(local.gather(-1, i).to(first))
        idxs.append((i + lo).to(first))
    vals, idxs = torch.cat(vals, -1), torch.cat(idxs, -1)
    best = torch.argmax(vals, dim=-1, keepdim=True)   # first of equal maxima
    return idxs.gather(-1, best)[..., 0]


def expert_blocks(*weights) -> List[Tuple[int, int, torch.device, tuple]]:
    """(e_lo, e_hi, device, local weights) of each expert block of
    (E, ...) expert stacks split alike over ``experts``; one block for
    plain tensors."""
    per = [w.blocks(0) if isinstance(w, ShardedTensor)
           else [(0, w.shape[0], w.device, w)] for w in weights]
    if len({tuple(b[:2] for b in p) for p in per}) != 1:
        raise ValueError("expert stacks split differently")
    return [(bs[0][0], bs[0][1], bs[0][2], tuple(b[3] for b in bs))
            for bs in zip(*per)]


# ---------------------------------------------------------------------- #
# training over a mesh                                                    #
# ---------------------------------------------------------------------- #
def mesh_of(tree) -> Optional[Mesh]:
    """The mesh of the first :class:`ShardedTensor` leaf of ``tree``;
    None where no leaf is placed on a mesh of more than one device."""
    found: List[Mesh] = []

    def look(path, leaf):
        if not found and isinstance(leaf, ShardedTensor):
            found.append(leaf.mesh)
    _map_with_path(look, tree)
    return found[0] if found else None


def per_shard(fn: Callable, *leaves):
    """``fn`` over plain tensors, or once per distinct local of leaves
    placed alike (``fn(*locals)`` on the locals of one mesh entry, the
    entries holding one tensor of the first leaf computed once); its
    output (a tensor or a tuple of them) placed as the first leaf is."""
    first = leaves[0]
    if not isinstance(first, ShardedTensor):
        return fn(*leaves)
    done: Dict[int, Any] = {}
    outs = []
    for i, local in enumerate(first.shards):
        if id(local) not in done:
            done[id(local)] = fn(*(t.shards[i] for t in leaves))
        outs.append(done[id(local)])

    def placed(shards):
        return ShardedTensor(first.shape, first.spec, first.mesh, shards)
    if isinstance(outs[0], tuple):
        return tuple(placed([o[j] for o in outs])
                     for j in range(len(outs[0])))
    return placed(outs)


def local_tensors(t) -> List[torch.Tensor]:
    """The distinct tensors of a placed leaf (a plain tensor: itself)."""
    if not isinstance(t, ShardedTensor):
        return [t]
    return list({id(x): x for x in t.shards}.values())


@dataclasses.dataclass(frozen=True, eq=False)
class DataShard:
    """Rows [lo, hi) of the global batch, block ``index`` of ``n``, and
    where they run: ``mesh``, the devices of the first data row holding
    that block along ``model`` (a 1-D mesh); the work runs on its first
    device."""

    index: int
    n: int
    lo: int
    hi: int
    mesh: Mesh

    @property
    def device(self) -> torch.device:
        return self.mesh.first_device


def data_shards(mesh, batch: int, groups: int = 0) -> List[DataShard]:
    """The global batch over ``mesh``'s data axes (all but ``model``), as
    ``batch_pspec`` splits it: over every data axis where ``batch``
    divides, else the first, else not at all.  ``groups`` > 0 (the MoE
    dispatch groups of the global batch) must divide too, so that each
    shard holds whole groups.  A block held by several data rows (the
    batch split over fewer axes than the mesh has) runs once, on the
    first of them."""
    sizes = _axis_sizes(mesh)
    dp = [a for a in mesh.axis_names if a != "model"]
    for axes in (tuple(dp), tuple(dp[:1]), ()):
        n = math.prod(sizes[a] for a in axes)
        if batch % n == 0 and (not groups or groups % n == 0):
            break
    names = list(mesh.axis_names)
    devs = mesh.devices
    if "model" in names:
        devs = np.moveaxis(devs, names.index("model"), -1)
    rows = devs.reshape(-1, sizes.get("model", 1))
    out: Dict[int, DataShard] = {}
    for r in range(rows.shape[0]):
        coord = dict(zip(dp, np.unravel_index(r, [sizes[a] for a in dp])))
        b = 0
        for a in axes:
            b = b * sizes[a] + int(coord[a])
        if b not in out:
            row = np.empty(rows.shape[1], dtype=object)
            row[:] = list(rows[r])
            step = batch // n
            out[b] = DataShard(b, n, b * step, (b + 1) * step,
                               Mesh(row, ("model",)))
    return [out[b] for b in sorted(out)]


def _assemble(blocks: Dict[tuple, torch.Tensor], dev) -> torch.Tensor:
    """The tensor that ``blocks`` (key: global [lo, hi) per dim) tile, on
    ``dev``, by ``torch.cat`` (differentiable)."""
    def cat(keys, d):
        if len(keys) == 1:
            t = blocks[keys[0]]
            return t if t.device == dev else t.to(dev)
        los = sorted({k[d][0] for k in keys})
        if len(los) == 1:
            return cat(keys, d + 1)
        return torch.cat([cat([k for k in keys if k[d][0] == lo], d + 1)
                          for lo in los], dim=d)
    return cat(sorted(blocks), 0)


def local_view(t, shard: DataShard, split_rows: bool = False):
    """``t`` as data shard ``shard`` computes on it: a plain tensor moved
    to the shard's device; a placed leaf gathered from its blocks there
    (each block read from a copy on that device where there is one).
    With ``split_rows`` a dimension 0 split over ``model`` (vocab rows,
    experts) stays split: a :class:`ShardedTensor` over the shard's
    devices, each one's block whole over the other dimensions.  The
    gather is ``torch.cat``: its backward hands each block its slice of
    the gradient, and autograd sums the slices of every data shard that
    gathered it."""
    dev = shard.device
    if not isinstance(t, ShardedTensor):
        return t if t.device == dev else t.to(dev)

    def pick(ts, d):
        return next((x for x in ts if x.device == d), ts[0])

    blocks = t.distinct_blocks()
    if not (split_rows and t.ndim and t.spec[0] == "model"
            and t.parts(0) > 1):
        return _assemble({k: pick(ts, dev) for k, ts in blocks.items()},
                         dev)
    n = t.shape[0] // t.parts(0)
    cols = []
    for k, d in enumerate(shard.mesh.devices.flat):
        lo = k * n
        cols.append(_assemble({key: pick(ts, d)
                               for key, ts in blocks.items()
                               if lo <= key[0][0] < lo + n}, d))
    return ShardedTensor(t.shape, ("model",), shard.mesh, cols)
