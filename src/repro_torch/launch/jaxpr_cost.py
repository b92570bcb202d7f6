"""Exact-trip-count cost walker over aten graphs (counterpart of
``repro.launch.jaxpr_cost``; the module keeps that name so a reader finds
it, but it walks the aten graph of a traced step, not a jaxpr).

``step_cost`` traces ``fn(*args)`` with ``make_fx`` over fake CPU
tensors (the port's ``jax.jit(fn).trace``): Python loops unroll, so trip
counts come out exact, and autograd inside ``fn`` (``torch.autograd.grad``
and the non-reentrant checkpoint of ``cfg.remat``) traces into the graph,
backward and recompute included.  ``_softmax`` and ``_log_softmax`` are
decomposed beside the core-ATen table, so the walker sees the
amax/sub/exp/sum/div the reference's byte rules were written for.  The
read/write traffic model is the reference's, rule for rule (``RULES``):

  FLOPs   dot (mm, bmm, addmm, baddbmm, convolution) = 2*M*N*K (x batch),
          elementwise and reductions = 1/elem.

  Bytes   *reads*: every op charges operands NOT produced by a fused
          (elementwise/cast/view) chain — fused producers stay in
          registers or shared memory.  *writes*: materialization points
          (dot/reduce/gather outputs), in-place update regions (``copy_``
          into a view, ``index_put``, ``scatter``, ``slice_scatter``:
          charge the update, not the buffer), and graph outputs of fused
          chains (e.g. the new optimizer state).

  VMEM    with ``vmem_bytes`` > 0, tensors whose PER-DEVICE size fits the
          budget are kernel-block-resident: their reads/writes don't hit
          device memory (the model is the reference's, name and all).

Kernel leaves.  Each entry point of ``kernels.ops`` that a traced step
calls (``LEAF_KERNELS``) is one node of the graph, not a trace through
its plain version: on a CPU tensor ``kernels.ops`` runs the plain
version, which e.g. repeats a GQA cache to H heads before its einsum
and would charge the cache H/KV times, where the kernel on the card
reads it once.  A leaf's FLOPs are what its plain version computes
(walked by the same rules), which is what the reference counts for the
code the kernel replaces; its bytes are its tensor operands read once
plus its result written once.  ``step_cost`` gets the leaves by
rebinding the ``kernels.ops`` attributes to tracing-only custom ops for
the duration of the trace (``kernel_leaves``); the card path of
``kernels.ops`` is untouched.  The port's callers look the entry points
up on the module at call time (``ops.flash_attention(...)``), so the
rebinding reaches every one of them.

All numbers are GLOBAL (whole-mesh) — divide by chips for per-device.
"""
from __future__ import annotations

import contextlib
import functools
import math
import operator
from typing import Callable, Dict, Iterator, List, Set

import torch
import torch.utils._pytree as pytree
from torch._decomp import core_aten_decompositions, get_decompositions
from torch.fx.experimental.proxy_tensor import make_fx

from ..kernels import ops, ref

FLOPS = "flops"
BYTES = "bytes"

aten = torch.ops.aten
LEAF_NAMESPACE = "repro_cost"
LEAF_KERNELS = ("flash_attention", "decode_attention",
                "paged_decode_attention", "fused_expert_ffn", "fused_adam")

# ---------------------------------------------------------------------- #
# The rule table: aten op -> the reference's rule it falls under         #
# (anything not listed is elementwise, as in the reference)              #
# ---------------------------------------------------------------------- #
DOT, REDUCE, INPLACE, GATHER, CAST, SHAPE, CREATE, FREE = (
    "dot", "reduce", "inplace", "gather", "cast", "shape", "create", "free")
_TABLE = {
    # dot_general / conv
    DOT: ("mm", "bmm", "addmm", "baddbmm", "convolution"),
    # reductions (sort: x log2 n)
    REDUCE: ("sum", "mean", "amax", "amin", "max", "min", "argmax",
             "argmin", "prod", "cumsum", "logsumexp", "sort", "topk",
             "var", "var_mean", "any", "all"),
    # dynamic_update_slice / scatter: charge the update region
    INPLACE: ("copy_", "index_put", "index_put_", "scatter", "scatter_add",
              "scatter_reduce", "slice_scatter", "select_scatter",
              "index_add"),
    # gather: only the gathered rows move
    GATHER: ("gather", "index", "embedding", "index_select"),
    # convert_element_type: the read at the source width
    CAST: ("_to_copy",),
    # the reference's fused shape prims (views, copies, concatenation)
    SHAPE: ("view", "_unsafe_view", "permute", "transpose", "t",
            "unsqueeze", "squeeze", "select", "slice", "expand", "alias",
            "as_strided", "detach", "clone", "copy", "cat",
            "constant_pad_nd", "flip", "split", "split_with_sizes",
            "unbind"),
    # iota / literal broadcasts / fresh buffers
    CREATE: ("arange", "full", "full_like", "scalar_tensor", "zeros",
             "zeros_like", "ones", "ones_like", "empty", "empty_like",
             "empty_permuted", "empty_strided", "new_zeros", "new_empty",
             "new_full", "lift_fresh_copy", "fill"),
    # host reads and shape queries
    FREE: ("_local_scalar_dense", "sym_size", "_assert_async",
           "_assert_scalar"),
}
RULES: Dict[str, str] = {op: rule for rule, names in _TABLE.items()
                         for op in names}
LEAF = "leaf"
ELEMENTWISE = "elementwise"


def rule_of(node) -> str:
    """The rule a graph node falls under (``RULES``; a kernel leaf is
    ``LEAF``, anything unlisted ``ELEMENTWISE``)."""
    target = node.target
    if target is operator.getitem:
        return SHAPE
    ns = getattr(target, "namespace", None)
    if ns == LEAF_NAMESPACE:
        return LEAF
    if ns is None:           # python builtins on sizes (operator.mul, ...)
        return FREE
    return RULES.get(target.overloadpacket.__name__, ELEMENTWISE)


# ---------------------------------------------------------------------- #
# Sizes                                                                   #
# ---------------------------------------------------------------------- #
def _tensors(val) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(val) if isinstance(t, torch.Tensor)]


def _size(val) -> int:
    return sum(t.numel() for t in _tensors(val))


def _bytes(val) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(val))


def _val(n):
    return n.meta.get("val") if hasattr(n, "meta") else None


def _in_nodes(node) -> List:
    """The graph nodes among ``node``'s arguments, in order (tensor
    lists and optional index lists flattened)."""
    return [a for a in pytree.tree_leaves((node.args, node.kwargs))
            if isinstance(a, torch.fx.Node) and _tensors(_val(a))]


def _dot_flops(node) -> int:
    """2*M*N*K (x batch) of a matrix product, from its operand shapes."""
    name = node.target.overloadpacket.__name__
    if name == "convolution":
        out, w = _val(node), _val(node.args[1])
        return 2 * out.numel() * w.numel() // max(w.shape[0], 1)
    a, b = (_val(x) for x in (node.args[1:3] if name in ("addmm", "baddbmm")
                              else node.args[:2]))
    k = a.shape[-1]
    batch = a.shape[0] if a.dim() == 3 else 1
    n = b.numel() // max(batch * k, 1)
    m = a.numel() // max(batch * k, 1)
    return 2 * batch * m * n * k


# ---------------------------------------------------------------------- #
# Kernel leaves                                                           #
# ---------------------------------------------------------------------- #
# each kernel's plain version in positional form: the leaf op's signature
# (and CPU implementation), and what its FLOPs are counted from
def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    return ref.flash_attention(q, k, v, causal=causal)


def _decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            kv_len: torch.Tensor) -> torch.Tensor:
    return ref.decode_attention(q, k_cache, v_cache, kv_len)


def _paged(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           block_tbl: torch.Tensor, kv_len: torch.Tensor, k_new: torch.Tensor,
           v_new: torch.Tensor, block_tokens: int) -> torch.Tensor:
    return ref.paged_decode_attention(q, k_pool, v_pool, block_tbl, kv_len,
                                      k_new, v_new)


def _expert(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, expert_ids: torch.Tensor,
            expert_wts: torch.Tensor) -> torch.Tensor:
    return ref.expert_ffn(x, w_gate, w_up, w_down, expert_ids, expert_wts)


def _adam(master: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
          g: torch.Tensor, lr: float, b1: float, b2: float, eps: float,
          wd: float, b1c: float, b2c: float
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return ref.fused_adam(master, m, v, g, lr=lr, b1=b1, b2=b2, eps=eps,
                          wd=wd, b1c=b1c, b2c=b2c)


_PLAIN = {"flash_attention": _flash, "decode_attention": _decode,
          "paged_decode_attention": _paged, "fused_expert_ffn": _expert,
          "fused_adam": _adam}


@functools.cache
def _leaf_ops() -> Dict[str, Callable]:
    """The ``kernels.ops`` entry points as tracing-only custom ops (one
    per ``LEAF_KERNELS`` entry, registered at the first trace): each
    takes the entry point's arguments and calls its op, whose fake
    implementation gives the result's shape."""
    leaf = {name: torch.library.custom_op(f"{LEAF_NAMESPACE}::{name}", fn,
                                          mutates_args=())
            for name, fn in _PLAIN.items()}
    for name, op in leaf.items():
        op.register_fake(
            (lambda master, m, v, *a: tuple(torch.empty_like(t)
                                             for t in (master, m, v)))
            if name == "fused_adam" else
            (lambda x, *a: torch.empty_like(x)))

    def lens(kv_len, q):
        return kv_len if isinstance(kv_len, torch.Tensor) else torch.full(
            (q.shape[0],), int(kv_len), dtype=torch.int32, device=q.device)

    return {
        "flash_attention": lambda q, k, v, *, causal=True: leaf[
            "flash_attention"](q, k, v, causal),
        "decode_attention": lambda q, k, v, kv_len: leaf[
            "decode_attention"](q, k, v, lens(kv_len, q)),
        "paged_decode_attention": lambda q, kp, vp, tbl, kv_len, kn, vn, *,
        block_tokens: leaf["paged_decode_attention"](
            q, kp, vp, tbl, lens(kv_len, q), kn, vn, block_tokens),
        "fused_expert_ffn": leaf["fused_expert_ffn"],
        "fused_adam": lambda master, m, v, g, *, lr, b1, b2, eps, wd, b1c,
        b2c: leaf["fused_adam"](master, m, v, g, float(lr), float(b1),
                                float(b2), float(eps), float(wd),
                                float(b1c), float(b2c)),
    }


@contextlib.contextmanager
def kernel_leaves() -> Iterator[None]:
    """``kernels.ops``' entry points rebound to the leaf ops for the
    duration of the block (not thread-safe: a step traced here must not
    run beside real work in another thread)."""
    leaves = _leaf_ops()
    saved = {name: getattr(ops, name) for name in leaves}
    try:
        for name, fn in leaves.items():
            setattr(ops, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def _leaf_signature(node) -> tuple:
    """A hashable key of a leaf call: its kernel and its arguments'
    shapes, dtypes and scalar values."""
    def one(a):
        v = _val(a) if isinstance(a, torch.fx.Node) else a
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), v.dtype)
        return v
    return (node.target.name().split("::")[1].split(".")[0],
            tuple(one(a) for a in node.args))


@functools.lru_cache(maxsize=256)
def _plain_flops(signature: tuple) -> float:
    """FLOPs of a leaf's plain version on fake tensors of the call's
    shapes, walked by the same rules."""
    kernel, args = signature
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    with mode:
        real = [torch.empty(a[0], dtype=a[1])
                if isinstance(a, tuple) and len(a) == 2
                and isinstance(a[1], torch.dtype) else a for a in args]
    tensors = [i for i, a in enumerate(real) if isinstance(a, torch.Tensor)]

    def plain(*ts):
        full = list(real)
        for i, t in zip(tensors, ts):
            full[i] = t
        return _PLAIN[kernel](*full)

    w = _Walker()
    w.graph(_trace(plain, [real[i] for i in tensors]).graph)
    return w.flops


# ---------------------------------------------------------------------- #
# The walker                                                              #
# ---------------------------------------------------------------------- #
class _Walker:
    def __init__(self, vmem_bytes: float = 0.0, n_chips: int = 1):
        self.vmem = vmem_bytes
        self.chips = max(n_chips, 1)
        self.flops = 0.0
        self.bytes = 0.0
        self.fused: Set = set()   # nodes held in registers / shared memory
        self.by_rule: Dict[str, Dict[str, float]] = {}

    def _charge(self, rule: str, flops: float = 0.0, nbytes: float = 0.0):
        self.flops += flops
        self.bytes += nbytes
        r = self.by_rule.setdefault(rule, {FLOPS: 0.0, BYTES: 0.0})
        r[FLOPS] += flops
        r[BYTES] += nbytes

    # ------------------------------------------------------------------ #
    def _resident(self, val) -> bool:
        return self.vmem > 0 and _bytes(val) / self.chips <= self.vmem

    def _read(self, rule: str, n):
        # persistent values (params, caches, carries) always charge; only
        # values PRODUCED by a fused chain are register-resident
        if n not in self.fused:
            self._charge(rule, nbytes=_bytes(_val(n)))

    def _write(self, rule: str, node):
        if self._resident(_val(node)):
            self.fused.add(node)
            return
        self._charge(rule, nbytes=_bytes(_val(node)))

    # ------------------------------------------------------------------ #
    def node(self, node):
        rule = rule_of(node)
        ins = _in_nodes(node)
        out = _val(node)

        if rule == FREE:
            return

        if rule == LEAF:
            # a kernel: its operands read once, its result written once
            self._charge(LEAF, flops=_plain_flops(_leaf_signature(node)),
                         nbytes=sum(_bytes(_val(a)) for a in ins))
            self._write(LEAF, node)
            return

        if rule == DOT:
            self._charge(DOT, flops=_dot_flops(node))
            if node.target.overloadpacket.__name__ in ("addmm", "baddbmm"):
                self._charge(ELEMENTWISE, flops=_size(out))   # the add
            for a in ins:
                self._read(DOT, a)
            self._write(DOT, node)
            return

        if rule == GATHER:
            # only gathered rows move: out-sized read + out write + idx
            src, idx = ins[0], ins[1:]
            if src not in self.fused:
                self._charge(GATHER, nbytes=_bytes(out))
            for a in idx:
                self._read(GATHER, a)
            self._write(GATHER, node)
            self._charge(GATHER, flops=_size(out))
            return

        if rule == INPLACE:
            # charge the update region, not the buffer (in place / donated)
            name = node.target.overloadpacket.__name__
            if name == "copy_":
                upd, region = ins[1], _val(ins[0])
            else:
                upd = ins[-1] if len(ins) > 1 else ins[0]
                region = _val(upd)
            self._read(INPLACE, upd)
            self._charge(INPLACE, flops=_size(region),
                         nbytes=_bytes(region))   # the write of the region
            return

        if rule == REDUCE:
            mult = 1.0
            if node.target.overloadpacket.__name__ == "sort":
                mult = max(math.log2(max(_size(_val(ins[0])), 2)), 1.0)
            self._charge(REDUCE, flops=sum(_size(_val(a)) for a in ins)
                         * mult)
            for a in ins:
                self._read(REDUCE, a)
            self._write(REDUCE, node)
            return

        if rule == CAST:
            # casts absorb the read at the SOURCE width; the result stays
            # fused — consumers don't re-charge it
            if ins:
                self._read(CAST, ins[0])
            self.fused.add(node)
            return

        if rule == CREATE:
            self.fused.add(node)
            return

        if rule == SHAPE:
            # views flow through registers: propagate fusion status; a view
            # of unfused data stays unfused (consumers charge it).  Unlike
            # a jaxpr, an aten graph views every input it feeds to a
            # product, so a view is resident only when its source is: a
            # view of a parameter in device memory stays there, however
            # small
            src = ins[0] if ins else None
            if src is None or src in self.fused:
                self.fused.add(node)
            return

        # generic elementwise: fused chain — reads charged for non-fused
        # operands, output stays in registers
        self._charge(ELEMENTWISE, flops=_size(out))
        for a in ins:
            self._read(ELEMENTWISE, a)
            self.fused.add(a)   # later uses re-read a now-resident value
        self.fused.add(node)

    def graph(self, graph, charge_outputs: bool = True):
        outputs = []
        for node in graph.nodes:
            if node.op == "call_function":
                self.node(node)
            elif node.op == "output":
                outputs = [a for a in pytree.tree_leaves(node.args)
                           if isinstance(a, torch.fx.Node)]
        if charge_outputs:
            for n in dict.fromkeys(outputs):
                if n in self.fused:   # fused chains must materialize
                    self._charge("output", nbytes=_bytes(_val(n)))


# ---------------------------------------------------------------------- #
# Tracing                                                                 #
# ---------------------------------------------------------------------- #
@functools.cache
def _decompositions() -> dict:
    table = dict(core_aten_decompositions())
    table.update(get_decompositions([aten._softmax, aten._log_softmax]))
    return table


def _is_fake(t) -> bool:
    return isinstance(t, torch._subclasses.fake_tensor.FakeTensor)


def _trace(fn, args) -> torch.fx.GraphModule:
    """``fn(*args)`` as an aten graph, traced over fake tensors.  Tensor
    leaves of ``args`` that are not 0-d real tensors become the graph's
    inputs (a real one is made fake); everything else — ints, floats,
    and 0-d real tensors such as AdamW's step count, whose value the
    step may read on the host — is closed over as a constant."""
    flat, spec = pytree.tree_flatten(list(args))
    traced = [i for i, t in enumerate(flat) if isinstance(t, torch.Tensor)
              and (_is_fake(t) or t.dim() > 0)]

    def body(*ts):
        leaves = list(flat)
        for i, t in zip(traced, ts):
            leaves[i] = t
        return fn(*pytree.tree_unflatten(leaves, spec))

    return make_fx(body, tracing_mode="fake",
                   decomposition_table=_decompositions(),
                   _allow_non_fake_inputs=True)(*(flat[i] for i in traced))


def trace(fn, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` as an aten graph with its kernel leaves (the
    port's ``jax.jit(fn).trace(*args).jaxpr``)."""
    with kernel_leaves():
        return _trace(fn, args)


def walk_graph(gm: torch.fx.GraphModule, vmem_bytes: float = 0.0,
               n_chips: int = 1) -> _Walker:
    """The walker after one pass over ``gm``: its ``flops``, ``bytes``
    and their ``by_rule`` breakdown."""
    w = _Walker(vmem_bytes, n_chips)
    w.graph(gm.graph)
    return w


def walk(fn, *args, vmem_bytes: float = 0.0, n_chips: int = 1
         ) -> _Walker:
    """``walk_graph`` of ``trace(fn, *args)``."""
    return walk_graph(trace(fn, *args), vmem_bytes, n_chips)


def step_cost(fn, *args, vmem_bytes: float = 0.0,
              n_chips: int = 1) -> Dict[str, float]:
    """Trace fn(*args) and return {'flops', 'bytes'} (global, exact trips).

    vmem_bytes > 0 enables the VMEM-residency fusion model (per-device
    tensors under the budget never hit device memory inside kernels).
    """
    w = walk(fn, *args, vmem_bytes=vmem_bytes, n_chips=n_chips)
    return {FLOPS: w.flops, BYTES: w.bytes}


def leaf_flops(w: _Walker) -> float:
    """FLOPs of the kernel leaves of a walk."""
    return w.by_rule.get(LEAF, {}).get(FLOPS, 0.0)


def dot_flops(w: _Walker) -> float:
    """Matrix-product FLOPs of a walk outside the kernel leaves: what
    ``torch.utils.flop_counter.FlopCounterMode`` counts over the same
    step on the card, where the leaves are ctypes kernels it cannot
    see."""
    return w.by_rule.get(DOT, {}).get(FLOPS, 0.0)

