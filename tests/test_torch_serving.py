"""Port serving stack against the JAX reference: pool bookkeeping and
payloads, greedy tokens of whole engines on both decode paths, and the
CLI, all on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_close, normal, to_numpy,  # noqa: E402
                           to_torch, tree_to_torch)

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import FAST_KIND as JFAST  # noqa: E402
from repro.serving import KVBlockSpec as JSpec  # noqa: E402
from repro.serving import PagedKVPool as JPool  # noqa: E402
from repro.serving import ServingConfig as JServingConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.serving import (FAST_KIND, KVBlockSpec,  # noqa: E402
                                 PagedKVPool, ServingConfig, ServingEngine)

ROOT = Path(__file__).resolve().parents[1]


# ===================================================================== #
# Pool                                                                  #
# ===================================================================== #
def _script(pool, fast):
    """One alloc/migrate/free/defrag history; returns what it observed."""
    seen = []
    pool.alloc(1, 3)
    pool.alloc(2, 2, kind=fast)
    pool.alloc(3, 4)
    seen.append(pool.migrate(pool.table[1][0], fast))
    seen.append(pool.migrate(pool.table[3][1], fast))
    seen.append(pool.migrate(pool.table[3][2], fast))   # over budget
    seen.append(pool.migrate(pool.table[2][0], "pinned_host"))
    pool.free_seq(2)
    pool.touch_seq(3, 7)
    pool.alloc(4, 2)
    seen.append(pool.defrag())
    seen.append({s: list(t) for s, t in pool.table.items()})
    seen.append([(b.bid, b.kind, b.seq_id, b.logical_idx, b.touch_count)
                 for b in pool.blocks])
    seen.append((pool.free_block_count(), pool.fast_used(),
                 pool.blocks_on("pinned_host")))
    seen.append(vars(pool.counters))
    seen.append(pool.ledger.bytes_on(fast, pool.tenant))
    return seen


def test_pool_bookkeeping_matches_reference():
    ref = JPool(16, 4, fast_block_budget=3)
    mine = PagedKVPool(16, 4, fast_block_budget=3)
    assert _script(mine, FAST_KIND) == _script(ref, JFAST)


SPEC = dict(n_units=2, n_attn=1, block_tokens=4, n_kv=2, head_dim=8)


def _payload(rs, n):
    shape = (2, 1, n, 2, 8)
    return (normal(rs, shape).astype(jnp.bfloat16),
            normal(rs, shape).astype(jnp.bfloat16))


@pytest.mark.parametrize("pooled", [False, True])
def test_pool_payloads_match_reference(pooled):
    rs = np.random.RandomState(0)
    ref = JPool(10, 4, spec=JSpec(**SPEC), fast_block_budget=4,
                pooled=pooled)
    mine = PagedKVPool(10, 4, spec=KVBlockSpec(**SPEC), fast_block_budget=4,
                       pooled=pooled, device="cpu")
    assert mine.block_nbytes() == ref.block_nbytes()
    for sid, n in ((0, 6), (1, 9), (2, 3)):
        k, v = _payload(rs, n)
        ref.write_prefill(sid, jnp.asarray(k), jnp.asarray(v), n)
        mine.write_prefill(sid, to_torch(k), to_torch(v), n)
    ref.free_seq(2)
    mine.free_seq(2)
    for sid in (0, 1):
        for _ in range(3):
            if ref.seq_len[sid] % 4 == 0:
                ref.alloc(sid, 1)
                mine.alloc(sid, 1)
            k, v = _payload(rs, 1)
            ref.append_token(sid, jnp.asarray(k[:, :, 0]),
                             jnp.asarray(v[:, :, 0]))
            mine.append_token(sid, to_torch(k[:, :, 0]),
                              to_torch(v[:, :, 0]))
    ref.migrate(ref.table[1][0], JFAST)
    mine.migrate(mine.table[1][0], FAST_KIND)
    for _ in range(2):
        for sid in (0, 1):
            rk, rv = ref.gather_seq(sid, 5)
            mk, mv = mine.gather_seq(sid, 5)
            n = ref.seq_len[sid]          # stale slots past seq_len differ
            np.testing.assert_array_equal(to_numpy(mk)[:, :, :n],
                                          np.asarray(rk, np.float32)[:, :, :n])
            np.testing.assert_array_equal(to_numpy(mv)[:, :, :n],
                                          np.asarray(rv, np.float32)[:, :, :n])
        if pooled:
            np.testing.assert_array_equal(mine.gather_tables([0, 1], 5)[0],
                                          ref.gather_tables([0, 1], 5)[0])
        assert mine.defrag() == ref.defrag()


# ===================================================================== #
# Engine                                                                #
# ===================================================================== #
@pytest.fixture(scope="module")
def tiny():
    jcfg = jsmoke("llama3-8b")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, jcfg.vocab, (n,)).astype(np.int32)
               for n in (12, 7, 9)]
    return jcfg, jparams, get_smoke_config("llama3-8b"), \
        tree_to_torch(jparams), prompts


SV = dict(block_tokens=8, max_batch=3, max_context=32, policy="tiering08")


def _tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.sched.finished}


def _run(cls, cfg_cls, cfg, params, prompts, new_tokens=4, **kw):
    extra = {"device": "cpu"} if cls is ServingEngine else {}
    eng = cls(cfg, params, cfg_cls(**SV, **kw), **extra)
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    eng.run()
    return eng


@pytest.fixture(scope="module")
def reference_tokens(tiny):
    jcfg, jparams, _, _, prompts = tiny
    return {fused: _tokens(_run(JServingEngine, JServingConfig, jcfg,
                                jparams, prompts, fused_gather=fused))
            for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True])
def test_engine_tokens_match_reference(tiny, reference_tokens, fused):
    _, _, cfg, params, prompts = tiny
    eng = _run(ServingEngine, ServingConfig, cfg, params, prompts,
               fused_gather=fused)
    assert eng.pool.pooled == fused
    assert _tokens(eng) == reference_tokens[fused]
    assert eng.pool.used_block_count() == 0


def test_fused_matches_staged_in_port(tiny):
    _, _, cfg, params, prompts = tiny
    staged = _run(ServingEngine, ServingConfig, cfg, params, prompts,
                  new_tokens=10)
    fused = _run(ServingEngine, ServingConfig, cfg, params, prompts,
                 new_tokens=10, fused_gather=True)
    assert _tokens(fused) == _tokens(staged)


def test_engine_preempts_on_a_tight_pool(tiny):
    _, _, cfg, params, prompts = tiny
    eng = ServingEngine(cfg, params, ServingConfig(
        block_tokens=4, max_batch=3, max_context=24, num_blocks=7),
        device="cpu")
    for p in prompts:
        eng.submit(p[:8], max_new_tokens=10)
    rep = eng.run()
    assert rep.summary["finished"] == 3.0
    assert rep.summary["preemptions"] > 0
    assert eng.pool.used_block_count() == 0


# ---------------------------- MoE engine ------------------------------ #
@pytest.fixture(scope="module")
def tiny_moe():
    jcfg = jsmoke("qwen3-moe-30b-a3b")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    # the smoke MoE's logits are flat (top-2 gaps of one bf16 ulp are
    # common), so token equality checks rounding as much as semantics;
    # these prompts keep every top-2 gap of the first 10 tokens at four
    # ulps or more (held below), where equality checks the function
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, jcfg.vocab, (n,)).astype(np.int32)
               for n in (10, 6, 13)]
    return jcfg, jparams, get_smoke_config("qwen3-moe-30b-a3b"), \
        tree_to_torch(jparams), prompts


@pytest.fixture(scope="module")
def moe_reference_tokens(tiny_moe):
    jcfg, jparams, _, _, prompts = tiny_moe
    return {fused: _tokens(_run(JServingEngine, JServingConfig, jcfg,
                                jparams, prompts, fused_gather=fused))
            for fused in (False, True)}


@pytest.mark.parametrize("fused", [False, True])
def test_moe_engine_tokens_match_reference(tiny_moe, moe_reference_tokens,
                                           fused):
    """Staged (moe_fwd) and fused (routed fused_expert_ffn) decode give
    the JAX engine's greedy tokens."""
    _, _, cfg, params, prompts = tiny_moe
    eng = _run(ServingEngine, ServingConfig, cfg, params, prompts,
               fused_gather=fused)
    assert _tokens(eng) == moe_reference_tokens[fused]
    assert eng.pool.used_block_count() == 0
    # router margins: one per generated token on the fused path only
    if fused:
        assert {r: len(m) for r, m in eng.route_margins.items()} == \
            {r: len(t) for r, t in _tokens(eng).items()}
        assert all(0.0 <= m <= 1.0 for ms in eng.route_margins.values()
                   for m in ms[1:])
    else:
        assert eng.route_margins == {}


def test_moe_fused_matches_staged_in_port(tiny_moe):
    _, _, cfg, params, prompts = tiny_moe
    staged = _run(ServingEngine, ServingConfig, cfg, params, prompts,
                  new_tokens=10)
    fused = _run(ServingEngine, ServingConfig, cfg, params, prompts,
                 new_tokens=10, fused_gather=True)
    assert min(min(m) for m in staged.margins.values()) >= 0.005
    assert _tokens(fused) == _tokens(staged)


def test_moe_fused_decode_routes_like_reference(tiny_moe):
    """One fused decode step on the same pool contents: logits close to
    the reference's and the same routed ids, (U, n_moe, B, K)."""
    from repro.serving.engine import _fused_paged_decode as jdecode
    from repro_torch.models import lm
    from repro_torch.serving.engine import _fused_paged_decode
    jcfg, jparams, cfg, params, _ = tiny_moe
    rs = np.random.RandomState(4)
    B, bt, nb, nblk = 3, 8, 3, 8
    shape = (cfg.n_units, 1, nblk, bt, cfg.n_kv, cfg.head_dim)
    ks = normal(rs, shape).astype(jnp.bfloat16)
    vs = normal(rs, shape).astype(jnp.bfloat16)
    tbl = rs.randint(0, nblk, (B, nb)).astype(np.int32)
    lens = np.asarray([5, 17, 0], np.int32)
    toks = rs.randint(0, cfg.vocab, (B, 1)).astype(np.int32)
    want = jdecode(jcfg, bt, jparams, *map(jnp.asarray,
                                           (toks, ks, vs, tbl, lens)))
    margins = []
    got = _fused_paged_decode(
        cfg, bt, lm.unit_views(params, cfg), params,
        to_torch(toks).long(), *map(to_torch, (ks, vs, tbl, lens)),
        route_margins=margins)
    assert got[3].shape == (cfg.n_units, 1, B, cfg.top_k)
    assert got[3].dtype == torch.int32
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert_close(got[0], want[0], dict(rtol=3e-2, atol=3e-2))
    assert len(margins) == cfg.n_units and margins[0].shape == (B, 2)
    assert all(bool((m[:, 0] >= m[:, 1]).all()) for m in margins)


def test_dense_fused_decode_routes_nothing_like_reference(tiny):
    """A dense model's fused decode step: logits close to the
    reference's and an empty routed-ids tensor of the reference's
    shape, (U, 0, B, max(top_k, 1))."""
    from repro.serving.engine import _fused_paged_decode as jdecode
    from repro_torch.models import lm
    from repro_torch.serving.engine import _fused_paged_decode
    jcfg, jparams, cfg, params, _ = tiny
    rs = np.random.RandomState(5)
    B, bt, nb, nblk = 2, 8, 3, 6
    shape = (cfg.n_units, 1, nblk, bt, cfg.n_kv, cfg.head_dim)
    ks = normal(rs, shape).astype(jnp.bfloat16)
    vs = normal(rs, shape).astype(jnp.bfloat16)
    tbl = rs.randint(0, nblk, (B, nb)).astype(np.int32)
    lens = np.asarray([9, 0], np.int32)
    toks = rs.randint(0, cfg.vocab, (B, 1)).astype(np.int32)
    want = jdecode(jcfg, bt, jparams, *map(jnp.asarray,
                                           (toks, ks, vs, tbl, lens)))
    margins = []
    got = _fused_paged_decode(
        cfg, bt, lm.unit_views(params, cfg), params,
        to_torch(toks).long(), *map(to_torch, (ks, vs, tbl, lens)),
        route_margins=margins)
    assert tuple(got[3].shape) == tuple(want[3].shape)
    assert got[3].dtype == torch.int32 and margins == []
    assert_close(got[0], want[0], dict(rtol=3e-2, atol=3e-2))


def test_moe_fused_needs_silu_experts(tiny_moe):
    import dataclasses
    _, _, cfg, params, _ = tiny_moe
    with pytest.raises(ValueError, match="silu"):
        ServingEngine(dataclasses.replace(cfg, act="gelu"), params,
                      ServingConfig(fused_gather=True), device="cpu")


def test_staged_prefill_kv_matches_reference_pool(tiny):
    """After one prefill, the pooled payloads hold the reference's K/V."""
    jcfg, jparams, cfg, params, prompts = tiny
    r = _run(JServingEngine, JServingConfig, jcfg, jparams, prompts[:1],
             new_tokens=1, fused_gather=True)
    m = _run(ServingEngine, ServingConfig, cfg, params, prompts[:1],
             new_tokens=1, fused_gather=True)
    assert_close(m.pool.k_store, r.pool.k_store,
                 dict(rtol=3e-2, atol=3e-2))


@pytest.mark.parametrize("option,value", [("cluster", dict(replicas=2))])
def test_unported_options_raise(option, value, tiny_moe):
    """The cluster option is ported: the section is accepted, and a
    replica's mesh may hold several devices (``replica_shard_map`` runs
    its function per device).  Expert residency runs over an expert
    store split across the mesh: the engine gives the tokens and the
    expert counters of the same engine over the whole store, from a
    pool of one block per (layer, expert)."""
    from repro_torch.cluster import (axis_mapping, replica_shard_map,
                                     shard_lm_params)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.shardings import PartitionSpec
    from repro_torch.serving import ClusterOptions
    section = ClusterOptions(**value)
    assert getattr(ServingConfig(**{option: section}), option) == section
    two = make_mesh((2,), ("model",), devices=["cpu", "cpu"])
    x = torch.arange(4.0)
    out = replica_shard_map(lambda t: t * 2, two, PartitionSpec("model"),
                            PartitionSpec("model"))(x)
    assert out.shard_shapes() == [(2,), (2,)]
    assert torch.equal(out.full(), x * 2)
    from repro_torch.serving.expert_pool import moe_layers_from_config
    _, _, cfg, params, prompts = tiny_moe
    with axis_mapping({"experts": "model"}):
        split = shard_lm_params(params, two)
    assert split["units"]["layers"][0]["moe"]["w_up"].is_split
    whole, eng = (_run(ServingEngine, ServingConfig, cfg, p, prompts,
                       fused_gather=True, expert_policy="lru")
                  for p in (params, split))
    assert len(eng.expert_pool.kinds) == \
        moe_layers_from_config(cfg) * cfg.n_experts
    assert _tokens(eng) == _tokens(whole)
    assert eng.expert_pool.summary() == whole.expert_pool.summary()
    assert eng.expert_pool.summary()["expert.accesses"] > 0


# each control-plane option with the options the reference requires
# beside it
PLANES = {
    "predictive": dict(adaptive=True, predictive=True),
    "calibrate": dict(adaptive=True, calibrate=True),
    "topology": dict(topology="far-socket"),
    "qos": dict(topology="far-socket", qos=True, slo_p95_decode_s=1e-3),
    "expert_policy": dict(fused_gather=True, expert_policy="lru"),
}


@pytest.mark.parametrize("option", sorted(PLANES))
def test_ported_planes_serve_with_reference_keys(option, tiny, tiny_moe,
                                                 monkeypatch):
    """The port's ServingConfig takes each control-plane option, and an
    engine built with it serves and reports the reference engine's
    telemetry and SLO keys."""
    import repro_torch.serving.engine as engine_mod
    from _torch_parity import serve_both, tpu_bases
    monkeypatch.setattr(engine_mod, "kind_bases", tpu_bases)
    kw = PLANES[option]
    sv = ServingConfig(**kw)
    assert getattr(sv, option) == kw[option]
    model = tiny_moe if option == "expert_policy" else tiny
    ref, ref_rep, eng, rep = serve_both(
        model, dict(block_tokens=8, max_batch=3, max_context=32,
                    replan_every=2, **kw), 4)
    assert set(rep.telemetry) == set(ref_rep.telemetry)
    assert set(rep.slo) == set(ref_rep.slo)
    assert set(eng.audit_report()) == set(ref.audit_report())
    assert rep.summary["finished"] == len(model[4])


# prompt seeds whose greedy tokens keep every top-2 logit gap of the
# port's run at 0.0078 or more (stablelm-1.6b: 0.0117) on both paths,
# so that equality compares the function and not rounding at a tie
COPIED_ENGINES = {"codeqwen1.5-7b": 24, "stablelm-1.6b": 37,
                  "bert-large-offload": 12}


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("arch", sorted(COPIED_ENGINES))
def test_copied_config_engine_tokens_match_reference(arch, fused):
    """The engines' greedy tokens on the smoke variants of the copied
    configs: QKV bias (codeqwen1.5-7b), LayerNorm and partial rotary
    (stablelm-1.6b), learned positions read at each sequence's own
    length on the paged path (bert-large-offload)."""
    from _torch_parity import engine_tokens, serve_both, tiny_model
    model = tiny_model(arch, COPIED_ENGINES[arch], (12, 7, 9))
    ref, _, eng, _ = serve_both(model, dict(
        block_tokens=8, max_batch=3, max_context=32, fused_gather=fused), 8)
    assert engine_tokens(eng) == engine_tokens(ref)
    assert min(min(m) for m in eng.margins.values()) >= 0.0078
    assert eng.pool.used_block_count() == 0


def test_engine_topology_tpu_pod_names_h100_node(tiny):
    _, _, cfg, params, _ = tiny
    with pytest.raises(ValueError, match="h100-node"):
        ServingEngine(cfg, params, ServingConfig(topology="tpu-pod"),
                      device="cpu")


def test_cuda_is_the_default_and_never_silently_cpu(monkeypatch, tiny):
    _, _, cfg, params, _ = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    from repro_torch.models import lm
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg)


def test_engine_rejects_params_on_another_device(tiny):
    _, _, cfg, params, _ = tiny
    bad = dict(params, embed=params["embed"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(cfg, bad, device="cpu")


# ===================================================================== #
# CLI                                                                   #
# ===================================================================== #
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_continuous_cpu():
    res = _cli("--arch", "llama3-8b", "--smoke", "--scheduler",
               "continuous", "--device", "cpu", "--num-requests", "3",
               "--new-tokens", "4")
    assert res.returncode == 0, res.stderr
    assert "policy=tiering08 requests=3 finished=3" in res.stdout
    assert "kv-pool: blocks=" in res.stdout


def test_cli_moe_fused_cpu():
    res = _cli("--arch", "qwen3-moe-30b-a3b", "--smoke", "--scheduler",
               "continuous", "--fused-gather", "--device", "cpu",
               "--num-requests", "3", "--new-tokens", "4")
    assert res.returncode == 0, res.stderr
    assert "policy=tiering08 requests=3 finished=3" in res.stdout
