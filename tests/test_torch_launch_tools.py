"""The port's analysis tools against the JAX reference's, on the CPU:
``launch.hlo_analysis`` (the HLO collective parser, saved stacks, the
roofline terms with an H100's constants, the model-FLOPs estimate) and
``launch.jaxpr_cost`` (the cost walker over aten graphs: matched torch
and JAX functions, one leaf per kernel entry point, and llama3-8b's
decode and prefill steps at full width on fake tensors).

The walker's matrix-product FLOPs outside the kernel leaves are what
``FlopCounterMode`` counts over a real step (``chip_smoke.py`` holds
the two against each other on the card; here on smoke steps on the
CPU, with the leaves bound)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo_analysis as JH  # noqa: E402
from repro.launch import jaxpr_cost as JJ  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import jaxpr_cost as JC  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

# ---------------------------------------------------------------------- #
# hlo_analysis                                                            #
# ---------------------------------------------------------------------- #
WHILE_HLO = """
HloModule m

%body (p: (s32[], f32[])) -> (s32[], f32[]) {
  %ar = f32[1024]{0} all-reduce(%x), replica_groups=[4,8]<=[32], to_apply=%add
}

ENTRY %main () -> f32[] {
  %w = (s32[], f32[]) while(%t), condition=%c, body=%body, backend_config={"known_trip_count":{"n":"10"}}
}
"""
PLAIN_HLO = """
ENTRY %main () -> f32[] {
  %ag = bf16[256,128]{1,0} all-gather(%x), replica_groups=[16,16]<=[256]
}
"""
MIXED_HLO = """
HloModule m

%inner (a: f32[]) -> f32[] {
  %rs = bf16[64,32]{1,0} reduce-scatter(%y), replica_groups={{0,1,2,3}}, dimensions={0}
  %cp = f32[128]{0} collective-permute(%z), source_target_pairs={{0,1},{1,0}}
}

%body (p: (s32[], f32[])) -> (s32[], f32[]) {
  %a2a = f32[8,256]{1,0} all-to-all(%q), replica_groups=[2,4]<=[8], dimensions={0}
  %c = f32[] call(%p), to_apply=%inner
}

ENTRY %main () -> f32[] {
  %ags = (bf16[16]{0}, bf16[512]{0}) all-gather-start(%x), replica_groups=[1,8]<=[8]
  %agd = bf16[512]{0} all-gather-done(%ags)
  %w = (s32[], f32[]) while(%t), condition=%c, body=%body, backend_config={"known_trip_count":{"n":"3"}}
  %dus = f32[4,1024]{1,0} dynamic-update-slice(%buf, %upd, %i, %j)
  %dus2 = bf16[2,8,16]{2,1,0} dynamic-update-slice(%buf2, %upd2, %i, %j, %k)
  %dus3 = f32[4,1024]{1,0} dynamic-update-slice(%buf3, %upd3, %i, %j)
}
"""
NO_ENTRY_HLO = """
  %ar = f32[256]{0} all-reduce(%x), replica_groups={{0,1}}, to_apply=%add
  %ar1 = f32[256]{0} all-reduce(%x), replica_groups={{0}}, to_apply=%add
"""
HLOS = {"while": (WHILE_HLO, 32), "plain": (PLAIN_HLO, 256),
        "mixed": (MIXED_HLO, 8), "no_entry": (NO_ENTRY_HLO, 2)}


@pytest.mark.parametrize("name", HLOS)
def test_collective_bytes_and_saved_stacks_match_reference(name):
    hlo, n = HLOS[name]
    got, want = H.collective_bytes(hlo, n), JH.collective_bytes(hlo, n)
    assert got.wire_bytes == want.wire_bytes
    assert got.result_bytes == want.result_bytes
    assert got.counts == want.counts
    assert got.by_op_bytes == want.by_op_bytes
    assert H.saved_stack_bytes(hlo) == JH.saved_stack_bytes(hlo)


def test_collective_parser_trip_counts_and_stacks():
    stats = H.collective_bytes(WHILE_HLO, 32)
    assert stats.wire_bytes == pytest.approx(2 * (7 / 8) * 4096 * 10)
    assert stats.counts == {"all-reduce": 1}
    stats = H.collective_bytes(MIXED_HLO, 8)
    assert stats.counts == {"all-gather": 1, "all-to-all": 1,
                            "reduce-scatter": 1, "collective-permute": 1}
    stacks = H.saved_stack_bytes(MIXED_HLO)
    # two f32[4,1024] updates are one stack; plus one bf16[2,8,16]
    assert stacks["total_bytes"] == 4 * 1024 * 4 + 2 * 8 * 16 * 2


def test_roofline_terms_use_the_h100_constants():
    assert H.PEAK_FLOPS_BF16 == 989e12 and H.HBM_BW == 3.35e12
    assert H.ICI_BW == pytest.approx(50e9)       # 900 GB/s over 18 links
    assert H.PEAK_FLOPS_FP32 == 67e12 and H.L2_BYTES == 50 * 2**20
    stats = H.CollectiveStats(wire_bytes=H.ICI_BW * 2)
    r = H.roofline_terms(989e12 * 8 * 3, 3.35e12 * 8, stats, 8, 1e15)
    assert r.compute_s == pytest.approx(3.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(2.0)
    assert r.dominant == "compute"
    assert r.roofline_fraction == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(1e15 / (989e12 * 24))
    d = r.to_dict()
    assert d["dominant"] == "compute" and d["n_chips"] == 8
    # the same GLOBAL counts on the reference's TPU constants differ only
    # by the rates
    want = JH.roofline_terms(989e12 * 8 * 3, 3.35e12 * 8, JH.CollectiveStats(
        wire_bytes=H.ICI_BW * 2), 8, 1e15)
    assert want.compute_s == pytest.approx(r.compute_s * 989 / 197)
    assert want.memory_s == pytest.approx(r.memory_s * 3.35e12 / 819e9)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        assert H.model_flops_estimate(cfg, shape) == \
            JH.model_flops_estimate(jcfg, jbase.SHAPES[name]), name


# ---------------------------------------------------------------------- #
# jaxpr_cost: matched torch and JAX functions                             #
# ---------------------------------------------------------------------- #
def _jscan(xs, w):
    def body(c, x):
        return c + (x @ w).sum(), None
    out, _ = jax.lax.scan(body, 0.0, xs)
    return out


def _tloop(xs, w):
    c = torch.zeros(())
    for x in xs:                     # unrolled: seven trips in the graph
        c = c + (x @ w).sum()
    return c


def _jloss(w, x):
    return jnp.sum((x @ w) ** 2)


def _tloss(w, x):
    return torch.sum((x @ w) ** 2)


def _tgrad(w, x):
    with torch.enable_grad():
        w = w.detach().requires_grad_(True)
        return torch.autograd.grad(_tloss(w, x), w)[0]


def _jattn(q, k, v):
    return jax.nn.softmax(jnp.einsum("qd,kd->qk", q, k), axis=-1) @ v


def _tattn(q, k, v):
    return torch.softmax(torch.einsum("qd,kd->qk", q, k), dim=-1) @ v


def _pair(*shapes):
    """fp32 zeros of ``shapes``, as JAX arrays and as tensors."""
    return ([jnp.zeros(s) for s in shapes], [torch.zeros(s) for s in shapes])


def _costs(jf, tf, shapes):
    jargs, targs = _pair(*shapes)
    return JJ.step_cost(jf, *jargs), JC.step_cost(tf, *targs)


def test_dot_matches_reference_exactly():
    want, got = _costs(lambda a, b: a @ b, lambda a, b: a @ b,
                       [(64, 128), (128, 32)])
    assert got == want
    assert got["flops"] == 2 * 64 * 128 * 32
    assert got["bytes"] == (64 * 128 + 128 * 32 + 64 * 32) * 4


def test_python_loop_counts_every_trip_as_scan_does():
    want, got = _costs(_jscan, _tloop, [(7, 16, 32), (32, 8)])
    per_trip = 2 * 16 * 32 * 8
    assert got["flops"] == want["flops"]
    assert 7 * per_trip <= got["flops"] < 7 * per_trip * 1.5
    # the scan re-reads its carry each trip; the unrolled loop keeps it
    # fused: 52 bytes of 28784
    assert got["bytes"] == pytest.approx(want["bytes"], rel=2e-3)


def test_grad_counts_backward_as_reference():
    shapes = [(32, 16), (8, 32)]
    want_f, got_f = _costs(_jloss, _tloss, shapes)
    want_g, got_g = _costs(jax.grad(_jloss), _tgrad, shapes)
    assert got_f == want_f
    assert got_g["flops"] == want_g["flops"]
    assert got_g["flops"] > 1.8 * got_f["flops"]   # bwd ~ 2x fwd
    # jax.grad's transpose writes one more (8, 16) fp32 cotangent
    assert want_g["bytes"] - got_g["bytes"] == 8 * 16 * 4 + 4


def test_vmem_fused_accounting_matches_reference():
    shapes = [(128, 64)] * 3
    jargs, targs = _pair(*shapes)
    for vmem in (0.0, 64 * 1024**2):
        want = JJ.step_cost(_jattn, *jargs, vmem_bytes=vmem, n_chips=1)
        got = JC.step_cost(_tattn, *targs, vmem_bytes=vmem, n_chips=1)
        # the reference's softmax subtracts a stop_gradient'ed max: one
        # more op per row, and one 0-d literal read
        assert want["flops"] - got["flops"] == 128
        assert want["bytes"] - got["bytes"] == 4
    fused = JC.step_cost(_tattn, *targs, vmem_bytes=64 * 1024**2)
    base = JC.step_cost(_tattn, *targs)
    assert fused["bytes"] < base["bytes"]
    assert fused["bytes"] == 4 * 128 * 64 * 4   # q, k, v in; out


def test_cast_absorbs_read_at_source_width_as_reference():
    want = JJ.step_cost(lambda c: (c.astype(jnp.float32) * 2.0).sum(),
                        jnp.zeros((1024, 128), jnp.int8))
    got = JC.step_cost(lambda c: (c.float() * 2.0).sum(),
                       torch.zeros(1024, 128, dtype=torch.int8))
    assert got["flops"] == want["flops"]
    assert got["bytes"] == 1024 * 128 + 4      # int8 read, fp32 sum out
    assert want["bytes"] - got["bytes"] == 4   # the reference's literal


def test_zero_d_real_tensor_is_a_constant_of_the_trace():
    """A 0-d real tensor (AdamW's step) may be read on the host."""
    def f(x, step):
        return x * float(1.0 - torch.pow(0.9, (step + 1).float()))
    with FakeTensorMode():
        x = torch.empty(4, 8)
    got = JC.step_cost(f, x, torch.zeros((), dtype=torch.int32))
    # the multiply, and the step's +1, pow and 1 - on one element each;
    # x, the step and the result
    assert got["flops"] == 32 + 3 and got["bytes"] == 2 * 32 * 4 + 4


# ---------------------------------------------------------------------- #
# kernel leaves                                                           #
# ---------------------------------------------------------------------- #
def _fake(*specs):
    with FakeTensorMode():
        return [torch.empty(s, dtype=d) for s, d in specs]


BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32
ADAM_KW = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, b1c=0.1,
               b2c=0.05)
# entry points looked up on ``ops`` at call time, as the port's callers
# do: the leaves rebind the module's attributes
LEAF_CASES = {
    "flash_attention": (
        lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
        lambda q, k, v: ref.flash_attention(q, k, v, causal=True),
        [((2, 128, 8, 64), BF16), ((2, 128, 2, 64), BF16),
         ((2, 128, 2, 64), BF16)], ((2, 128, 8, 64), BF16)),
    "decode_attention": (
        lambda *a: ops.decode_attention(*a), ref.decode_attention,
        [((2, 8, 64), BF16), ((2, 96, 2, 64), BF16), ((2, 96, 2, 64), BF16),
         ((2,), I32)], ((2, 8, 64), BF16)),
    "paged_decode_attention": (
        lambda *a: ops.paged_decode_attention(*a, block_tokens=16),
        ref.paged_decode_attention,
        [((2, 8, 64), BF16), ((12, 16, 2, 64), BF16),
         ((12, 16, 2, 64), BF16), ((2, 4), I32), ((2,), I32),
         ((2, 2, 64), BF16), ((2, 2, 64), BF16)], ((2, 8, 64), BF16)),
    "fused_expert_ffn": (
        lambda *a: ops.fused_expert_ffn(*a), ref.expert_ffn,
        [((4, 64), BF16), ((8, 64, 32), BF16), ((8, 64, 32), BF16),
         ((8, 32, 64), BF16), ((4, 2), I32), ((4, 2), F32)],
        ((4, 64), BF16)),
    "fused_adam": (
        lambda ma, m, v, g: ops.fused_adam(ma, m, v, g, **ADAM_KW),
        lambda ma, m, v, g: ref.fused_adam(ma, m, v, g, **ADAM_KW),
        [((300, 7), F32)] * 3 + [((300, 7), BF16)], [((300, 7), F32)] * 3),
}


def _nbytes(specs):
    out = 0
    for shape, dtype in specs:
        n = 1
        for d in shape:
            n *= d
        out += n * torch.empty((), dtype=dtype).element_size()
    return out


@pytest.mark.parametrize("kernel", JC.LEAF_KERNELS)
def test_kernel_entry_point_is_one_leaf(kernel):
    """Each ``kernels.ops`` entry point traces as one leaf: its bytes are
    its operands read once plus its result written once, its FLOPs those
    of its plain version (walked by the same rules), and the plain
    version is not traced into the graph."""
    entry, plain, ins, outs = LEAF_CASES[kernel]
    args = _fake(*ins)
    w = JC.walk(entry, *args)
    gm = JC.trace(entry, *args)
    calls = [n for n in gm.graph.nodes if n.op == "call_function"]
    leaves = [n for n in calls if JC.rule_of(n) == JC.LEAF]
    assert len(leaves) == 1
    assert all(JC.rule_of(n) == JC.SHAPE for n in calls
               if n not in leaves)          # fused_adam's getitems
    plain_w = JC.walk(plain, *args)
    want_bytes = _nbytes(ins) + _nbytes(outs if isinstance(outs, list)
                                        else [outs])
    assert w.by_rule[JC.LEAF][JC.BYTES] == want_bytes
    assert w.by_rule[JC.LEAF][JC.FLOPS] == plain_w.flops
    assert JC.leaf_flops(w) == plain_w.flops > 0
    # the leaf's result leaves the graph as written: nothing more
    assert w.bytes == want_bytes and w.flops == plain_w.flops


def test_kernel_leaves_rebind_only_while_tracing():
    before = {name: getattr(ops, name) for name in JC.LEAF_KERNELS}
    with pytest.raises(RuntimeError, match="boom"):
        with JC.kernel_leaves():
            assert all(getattr(ops, n) is not before[n]
                       for n in JC.LEAF_KERNELS)
            raise RuntimeError("boom")
    assert {n: getattr(ops, n) for n in JC.LEAF_KERNELS} == before
    JC.step_cost(LEAF_CASES["decode_attention"][0],
                 *_fake(*LEAF_CASES["decode_attention"][2]))
    assert {n: getattr(ops, n) for n in JC.LEAF_KERNELS} == before


# ---------------------------------------------------------------------- #
# full-width llama3-8b steps on fake tensors                              #
# ---------------------------------------------------------------------- #
B, PROMPT, CACHE = 8, 512, 544      # the one-shot phase's shapes
# port / reference bytes of the prefill (8 x 512), measured: the port
# moves 41.46 GB where the reference's walker counts 72.65 GB.  By op
# (reference -> port, ``test_llama3_8b_prefill_bytes_by_op``): matrix
# products 38.10 -> 27.36 GB (the reference's chunked attention writes
# its fp32 scores, 8 x 32 x 512 x 512 per layer, where the flash leaf
# moves q, k, v and its result, 2.68 GB in all); elementwise 22.05 ->
# 5.94 GB (a jaxpr broadcasts explicitly, and the reference charges a
# broadcast of a parameter or a rotary table at its broadcast size; an
# aten op broadcasts inside and reads its operand's own bytes); gather
# 2.75 -> 0.07 GB; a nested ``jit``, which the reference walker does not
# enter and charges as an elementwise op, 4.03 -> 0 GB; casts 5.64 ->
# 5.14 GB.
PREFILL_BYTES_RATIO = 0.5707


@pytest.fixture(scope="module")
def llama_steps():
    """{step: (reference cost, port walker)} at full width."""
    jcfg, cfg = jget_config("llama3-8b"), get_config("llama3-8b")
    jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                jcfg))
    jcache = jax.eval_shape(lambda: jlm.make_decode_cache(jcfg, B, CACHE))
    jtok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    jbatch = {"tokens": jax.ShapeDtypeStruct((B, PROMPT), jnp.int32)}
    with FakeTensorMode():
        p = lm.init_params(cfg, device="cpu")
        cache = lm.make_decode_cache(cfg, B, CACHE, device="cpu")
        tok = torch.empty(B, 1, dtype=torch.int32)
        batch = {"tokens": torch.empty(B, PROMPT, dtype=torch.int32)}
    cache["index"] = PROMPT
    return {
        "decode": (JJ.step_cost(jsteps.make_serve_step(jcfg), jp, jcache,
                                jtok),
                   JC.walk(steps.make_serve_step(cfg), p, cache, tok)),
        "prefill": (JJ.step_cost(jsteps.make_prefill_step(jcfg), jp,
                                 jbatch),
                    JC.walk(steps.make_prefill_step(cfg), p, batch)),
    }


def test_llama3_8b_decode_step_cost_matches_reference(llama_steps):
    want, w = llama_steps["decode"]
    assert want["flops"] == pytest.approx(122.41e9, rel=1e-3)
    assert w.flops == pytest.approx(want["flops"], rel=0.01)
    assert w.bytes == pytest.approx(want["bytes"], rel=0.05)
    # every layer reads its K and V cache once, inside its leaf
    cache_bytes = 32 * 2 * B * CACHE * 8 * 128 * 2
    assert cache_bytes < w.by_rule[JC.LEAF][JC.BYTES] < 1.02 * cache_bytes


def test_llama3_8b_prefill_step_cost_matches_reference(llama_steps):
    want, w = llama_steps["prefill"]
    assert want["flops"] == pytest.approx(58.310e12, rel=1e-4)
    assert w.flops == pytest.approx(want["flops"], rel=0.01)
    assert w.bytes / want["bytes"] == pytest.approx(PREFILL_BYTES_RATIO,
                                                    rel=0.02)
    # the flash leaf: q, k, v and the result of every layer, bf16
    qkv_out = 32 * B * PROMPT * (32 + 8 + 8 + 32) * 128 * 2
    assert w.by_rule[JC.LEAF][JC.BYTES] == qkv_out


def test_plain_versions_would_charge_the_gqa_cache_per_head(llama_steps):
    """Why the kernels are leaves: walked through its plain version (what
    ``kernels.ops`` runs on a CPU tensor), decode attention repeats each
    layer's K and V cache to H = 4 x KV heads before its einsum, and the
    step's bytes grow by three more reads of the cache."""
    cfg = get_config("llama3-8b")
    with FakeTensorMode():
        p = lm.init_params(cfg, device="cpu")
        cache = lm.make_decode_cache(cfg, B, CACHE, device="cpu")
        tok = torch.empty(B, 1, dtype=torch.int32)
    cache["index"] = PROMPT
    plain = JC.walk_graph(JC._trace(steps.make_serve_step(cfg),
                                    (p, cache, tok)))
    _, w = llama_steps["decode"]
    cache_bytes = 32 * 2 * B * CACHE * 8 * 128 * 2
    assert plain.flops == w.flops
    assert (plain.bytes - w.bytes) / cache_bytes == pytest.approx(3,
                                                                  rel=0.05)


class _RefByPrimitive(JJ._Walker):
    """The reference's walker, its bytes also summed by primitive (scan
    bodies times their trips), for the prefill's breakdown."""

    def __init__(self, by, mult=1):
        super().__init__()
        self.by, self.mult = by, mult

    def eqn(self, e):
        name = e.primitive.name
        if name == "scan":
            n = e.params["length"]
            sub = _RefByPrimitive(self.by, self.mult * n)
            sub.jaxpr(e.params["jaxpr"].jaxpr, charge_outvars=True)
            self.flops += sub.flops * n
            self.bytes += sub.bytes * n
            return
        if name in JJ._SUBJAXPR_PRIMS:
            return super().eqn(e)
        before = self.bytes
        super().eqn(e)
        self.by[name] = self.by.get(name, 0) + (self.bytes - before) \
            * self.mult

    def jaxpr(self, jaxpr, charge_outvars=False):
        for e in jaxpr.eqns:
            self.eqn(e)
        if charge_outvars:   # as the reference: fused chains materialize
            for v in jaxpr.outvars:
                if id(v) in self.fused:
                    b = JJ._bytes(getattr(v, "aval", v))
                    self.bytes += b
                    self.by["outputs"] = self.by.get("outputs", 0) \
                        + b * self.mult


def test_llama3_8b_prefill_bytes_by_op(llama_steps):
    """The prefill's byte ratio (``PREFILL_BYTES_RATIO``), op by op."""
    jcfg = jget_config("llama3-8b")
    jp = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                jcfg))
    jbatch = {"tokens": jax.ShapeDtypeStruct((B, PROMPT), jnp.int32)}
    closed = jax.jit(jsteps.make_prefill_step(jcfg)).trace(jp, jbatch)
    by = {}
    ref_w = _RefByPrimitive(by)
    ref_w.jaxpr(closed.jaxpr.jaxpr, charge_outvars=True)
    want, w = llama_steps["prefill"]
    assert ref_w.bytes == want["bytes"] == pytest.approx(sum(by.values()))
    port = {k: v[JC.BYTES] for k, v in w.by_rule.items()}
    scores = 32 * B * 32 * PROMPT * PROMPT * 4   # fp32, every layer
    elementwise = sum(by.get(k, 0) for k in ("mul", "add", "div", "sub",
                                             "max", "select_n", "exp"))
    # products: the reference's attention writes its scores; the port's
    # flash leaf moves only q, k, v and its result
    assert by["dot_general"] - port[JC.DOT] > scores
    assert port[JC.LEAF] < scores
    # explicit broadcasts: the reference's elementwise bytes are ~3.7x
    assert elementwise > 3 * port[JC.ELEMENTWISE]
    assert by["gather"] > 30 * port[JC.GATHER]
    # the nested jit the reference charges as one elementwise op
    assert by["jit"] > 0 and "jit" not in port
    assert port[JC.CAST] == pytest.approx(by["convert_element_type"],
                                          rel=0.1)


# ---------------------------------------------------------------------- #
# the walker's products are what FlopCounterMode counts                   #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2-xl-offload"])
def test_flop_counter_counts_the_walkers_products(arch):
    """On a real step with the kernel leaves bound (the card's kernels
    are invisible to ``FlopCounterMode``, as the leaves are here), its
    count equals the walker's dot FLOPs outside the leaves exactly."""
    cfg = get_smoke_config(arch)
    p = lm.init_params(cfg, seed=0, device="cpu")
    acfg = adam.AdamConfig(use_fused_kernel=True)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 64), generator=g,
                         dtype=torch.int32)
    cache = lm.make_decode_cache(cfg, 2, 64, device="cpu")
    cache["index"] = 10
    cases = {
        "train": (steps.make_train_step(cfg, acfg),
                  (p, adam.init_state(p, acfg),
                   {"tokens": toks, "labels": toks})),
        "prefill": (steps.make_prefill_step(cfg), (p, {"tokens": toks})),
        "decode": (steps.make_serve_step(cfg), (p, cache, toks[:, :1])),
    }
    for name, (fn, args) in cases.items():
        w = JC.walk(fn, *args)
        with JC.kernel_leaves(), FlopCounterMode(display=False) as fc:
            fn(*args)
        assert fc.get_total_flops() == JC.dot_flops(w) > 0, name
        assert JC.leaf_flops(w) > 0, name
