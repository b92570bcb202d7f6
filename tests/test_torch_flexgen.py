"""The port's one-shot FlexGen serving path against the JAX reference on
the CPU: ``dense_attention``, the decode step and its cache,
decode-vs-prefill consistency on every config the port runs (frames for
the vision and Whisper models; the recurrent families' caches hold no
``kv_k``), ``TieredKVCache``, the placement search and batch sizing,
``FlexGenEngine`` tokens (with frames, too) and telemetry, and the serve
CLI's one-shot default.  Inputs are numpy draws from a seed; the
reference's weights cross bit-exactly through ``params_from_numpy``."""
import dataclasses
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import (assert_close, assert_same, BF16,  # noqa: E402
                           FP32, normal, reference_runner, smoke_model,
                           to_numpy, to_torch)

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import tpu_v5e_tiers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import modules as JM  # noqa: E402
from repro.offload import serve_engine as jserve  # noqa: E402
from repro.serving.kv_pool import (  # noqa: E402
    TieredKVCache as JTieredKVCache)
from repro.telemetry import AccessTrace as JAccessTrace  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.core.tiers import MemoryTier  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import modules as M  # noqa: E402
from repro_torch.offload import serve_engine  # noqa: E402
from repro_torch.serving import TieredKVCache  # noqa: E402
from repro_torch.telemetry import AccessTrace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _model(arch):
    """``_torch_parity.smoke_model``: the reference's smoke config and
    params (the vision model's tanh gates drawn, so that its cross
    layers show) and the port's, bit for bit."""
    return smoke_model(arch)


def _frames(cfg, B, seed=2):
    """Stubbed frontend embeddings (B, n_frontend_tokens, d_model) of a
    model that attends over them; None for the others."""
    if not cfg.n_frontend_tokens:
        return None
    return normal(np.random.RandomState(seed),
                  (B, cfg.n_frontend_tokens, cfg.d_model))


def _pad(cache, extra):
    """The reference test's ``_pad_kv``: pad ``kv_k``/``kv_v``, where
    the cache has them, along positions."""
    out = dict(cache)
    for k in ("kv_k", "kv_v"):
        if k in out:
            pads = [(0, 0)] * out[k].ndim
            pads[3] = (0, extra)
            out[k] = jnp.pad(out[k], pads)
    return out


def _port_cache(jcache):
    """The reference's decode cache as the port's (bit-exact)."""
    return {k: int(v) if k == "index" else to_torch(v)
            for k, v in jcache.items()}


# ===================================================================== #
# attention                                                             #
# ===================================================================== #
@pytest.mark.parametrize("causal,q_offset,kv_len", [
    (True, 0, None), (True, 5, None), (False, 0, 9), (True, 3, 7),
    (False, 0, None),
])
def test_dense_attention_matches_reference(causal, q_offset, kv_len):
    rs = np.random.RandomState(0)
    q = normal(rs, (2, 4, 8, 16))
    k, v = normal(rs, (2, 12, 2, 16)), normal(rs, (2, 12, 2, 16))
    want = JM.dense_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal,
                              q_offset=q_offset,
                              kv_len=None if kv_len is None
                              else jnp.int32(kv_len))
    got = M.dense_attention(to_torch(q), to_torch(k), to_torch(v),
                            causal=causal, q_offset=q_offset,
                            kv_len=kv_len)
    assert got.shape == (2, 4, 8, 16)
    assert_close(got, want, FP32)


@pytest.mark.parametrize("kv_len", [1, 13, 24])
def test_plain_decode_attention_matches_reference_dense(kv_len):
    """The CPU route of ``ops.decode_attention`` (the kernel's plain
    version) against the reference's decode attention at Sq 1."""
    rs = np.random.RandomState(1)
    q = normal(rs, (3, 1, 8, 16))
    k, v = normal(rs, (3, 24, 2, 16)), normal(rs, (3, 24, 2, 16))
    want = JM.dense_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=False,
                              kv_len=jnp.int32(kv_len))
    got = ops.decode_attention(to_torch(q)[:, 0], to_torch(k), to_torch(v),
                               kv_len)
    assert_close(got, to_numpy(want)[:, 0], FP32)


# ===================================================================== #
# decode step and cache                                                 #
# ===================================================================== #
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_reference(arch, S, monkeypatch):
    """One decode step of S tokens from the same cache (the reference's
    prefill cache, padded), through the serve step builders: logits
    and every leaf of the written cache.  The reference runs compiled,
    except on the ``_torch_parity.ROUNDING_SENSITIVE`` families
    (``reference_runner``)."""
    jcfg, jparams, cfg, params = _model(arch)
    run = reference_runner(arch, monkeypatch)
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, jcfg.vocab, (2, 12)).astype(np.int32)
    nxt = rs.randint(0, jcfg.vocab, (2, S)).astype(np.int32)
    frames = _frames(cfg, 2)
    _, jcache = run(jlm.prefill, jparams, jcfg, jnp.asarray(prompt),
                    None if frames is None else jnp.asarray(frames))
    jcache = _pad(jcache, 6)
    cache = _port_cache(jcache)
    want, jnew = run(jlm.decode_step, jparams, jcfg, jcache,
                     jnp.asarray(nxt))
    got, new = steps.make_serve_step(cfg)(params, cache,
                                          torch.from_numpy(nxt))
    assert got.dtype == torch.float32 and got.shape == (2, jcfg.vocab)
    assert_close(got, want, BF16)
    assert new["index"] == int(jnew["index"]) == 12 + S
    assert set(new) == set(jnew)
    for k in jnew:
        if k != "index":
            assert_close(new[k], jnew[k], BF16)


@pytest.mark.parametrize("arch", ["llama3-8b", "bert-large-offload",
                                  "llama-3.2-vision-11b",
                                  "jamba-1.5-large-398b",
                                  "whisper-large-v3", "rwkv6-7b"])
def test_make_decode_cache_matches_reference(arch):
    """Every key of the zero cache (K/V, conv/ssm, wkv/shifts, cross
    K/V over ``enc_len`` positions): shapes and dtypes."""
    jcfg, _, cfg, _ = _model(arch)
    enc = jcfg.n_frontend_tokens
    want = jlm.make_decode_cache(jcfg, 3, 20, enc_len=enc)
    got = lm.make_decode_cache(cfg, 3, 20, enc_len=enc, device="cpu")
    assert set(got) == set(want)
    assert got["index"] == int(want["index"]) == 0
    for k, w in want.items():
        if k != "index":
            assert tuple(got[k].shape) == w.shape, k
            assert str(got[k].dtype).endswith(str(w.dtype)), k
            assert not got[k].any()


def test_decode_step_from_a_fresh_cache():
    """Decoding a prompt token by token into ``make_decode_cache``'s
    cache gives the prefill's cache and last logits."""
    _, _, cfg, params = _model("bert-large-offload")
    toks = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab, (2, 9)))
    cache = lm.make_decode_cache(cfg, 2, 9, device="cpu")
    for i in range(9):
        logits, cache = lm.decode_step(params, cfg, cache, toks[:, i:i + 1])
    want, pcache = lm.prefill(params, cfg, toks)
    assert cache["index"] == 9
    assert_close(logits, want, BF16)
    assert_close(cache["kv_k"], pcache["kv_k"], BF16)


def test_decode_step_overflow_raises():
    _, _, cfg, params = _model("llama3-8b")
    cache = lm.make_decode_cache(cfg, 1, 4, device="cpu")
    cache["index"] = 4
    with pytest.raises(ValueError, match="overflows"):
        lm.decode_step(params, cfg, cache,
                       torch.zeros(1, 1, dtype=torch.long))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_prefill(arch):
    """The port's counterpart of ``test_decode_consistency.py::
    test_decode_matches_prefill``: each of 3 decode steps against a
    prefill of the whole sequence, rel < 2e-2."""
    _, _, cfg, params = _model(arch)
    B, S = 2, 32
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (B, S)))
    frames = _frames(cfg, B)
    logits_p, cache = lm.prefill(params, cfg, toks, frames)
    cache = dict(cache, **{k: torch.nn.functional.pad(
        cache[k], (0, 0, 0, 0, 0, 8)) for k in ("kv_k", "kv_v")
        if k in cache})
    seq = toks
    for step in range(3):
        nxt = torch.argmax(logits_p, -1)[:, None]
        logits_d, cache = lm.decode_step(params, cfg, cache, nxt)
        seq = torch.cat([seq, nxt], dim=1)
        logits_full, _ = lm.prefill(params, cfg, seq, frames)
        a, b = to_numpy(logits_d), to_numpy(logits_full)
        rel = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)
        assert rel < 2e-2, f"{arch} step {step}: rel err {rel}"
        logits_p = logits_d


def test_learned_positions_offset_by_index():
    """gpt2-xl-offload and bert-large-offload embed positions: a decode
    step at index i adds row i of ``pos_emb`` (clamped as the
    reference's dynamic_slice clamps it)."""
    jcfg, jparams, cfg, params = _model("gpt2-xl-offload")
    tok = np.array([[5], [7]], np.int32)
    for index in (0, 17, cfg.max_pos + 3):
        want = jlm._embed_tokens(jparams, jcfg, jnp.asarray(tok),
                                 index=jnp.int32(index))
        got = lm._embed_tokens(params, cfg, torch.from_numpy(tok).long(),
                               index=index)
        np.testing.assert_array_equal(to_numpy(got), to_numpy(want))


def test_int8_kv_names_its_roadmap_item():
    """The model runs an int8 KV cache (tests/test_torch_families.py);
    the one-shot engine, which pads and tiers only kv_k/kv_v, refuses it
    and names the ROADMAP note on both packages."""
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                              kv_cache_dtype="int8")
    cache = lm.make_decode_cache(cfg, 1, 4, device="cpu")
    assert cache["kv_k"].dtype == torch.int8
    assert cache["kv_k_scale"].shape == (cfg.n_units, 1, 1, 4, cfg.n_kv)
    with pytest.raises(ValueError, match=r"kv_k_scale.*ROADMAP section 3"):
        serve_engine.FlexGenEngine(
            cfg, lm.init_params(cfg, seed=0, device="cpu"), device="cpu")


# ===================================================================== #
# TieredKVCache                                                         #
# ===================================================================== #
KV_SHARES = [
    [("device", 1.0)],
    [("device", 0.5), ("pinned_host", 0.5)],
    [("device", 0.34), ("pinned_host", 0.33), ("unpinned_host", 0.33)],
    [("pinned_host", 1.0)],
]


@pytest.mark.parametrize("shares", KV_SHARES, ids=str)
def test_tiered_kv_cache_matches_reference(shares):
    rs = np.random.RandomState(5)
    shape = (3, 1, 2, 10, 2, 8)
    raw = {k: normal(rs, shape).astype(jnp.bfloat16)
           for k in ("kv_k", "kv_v")}
    ref = JTieredKVCache(shares)
    mine = TieredKVCache(shares, device="cpu")
    jcache = {k: jnp.asarray(v) for k, v in raw.items()}
    cache = {k: to_torch(v) for k, v in raw.items()}
    ref.stash(jcache)
    mine.stash(cache)
    assert mine.offloaded == ref.offloaded
    for k in ("kv_k", "kv_v"):
        assert mine.ledger.has(mine.tenant, k) == ref.ledger.has(
            ref.tenant, k)
        if ref.offloaded:
            assert mine.ledger.placement(mine.tenant, k) == \
                ref.ledger.placement(ref.tenant, k)
    for kind in ("device", "pinned_host", "unpinned_host"):
        assert mine.bytes_on(kind) == ref.bytes_on(kind)
    # a stepped cache written back and restored again
    stepped = {k: v * 2 for k, v in cache.items()}
    mine.update(stepped)
    got = mine.restore({k: torch.zeros_like(v) for k, v in cache.items()}
                       if mine.offloaded else stepped)
    for k in ("kv_k", "kv_v"):
        assert torch.equal(got[k], stepped[k])


def test_tiered_kv_cache_no_offload_is_a_no_op():
    kv = TieredKVCache([("device", 1.0)], device="cpu")
    cache = {"kv_k": torch.ones(2, 1, 1, 3, 1, 2)}
    kv.stash(cache)
    assert kv.restore(cache) is cache and not kv._tiered
    assert kv.bytes_on("device") == 0


# ===================================================================== #
# placement search and batch sizing                                     #
# ===================================================================== #
def _tpu_tiers():
    t = tpu_v5e_tiers()
    return t, {k: MemoryTier(**dataclasses.asdict(v)) for k, v in t.items()}


@pytest.mark.parametrize("arch,batch,seq", [
    ("stablelm-1.6b", 4, 128), ("llama3-8b", 8, 544),
    ("qwen3-moe-30b-a3b", 2, 2048),
])
def test_search_placement_matches_reference(arch, batch, seq):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    jt, t = _tpu_tiers()
    for jcfg, cfg in ((jsmoke(arch), get_smoke_config(arch)),
                      (jget(arch), get_config(arch))):
        want = jserve.search_placement(jcfg, batch, seq, jt, fast="HBM")
        got = serve_engine.search_placement(cfg, batch, seq, t, fast="HBM")
        assert_same(got, want)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "llama3-8b",
                                  "gpt2-xl-offload"])
def test_max_batch_for_capacity_matches_reference(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    for gib in (1, 10, 40, 80, 512):
        for seq in (128, 1024):
            assert serve_engine.max_batch_for_capacity(
                get_config(arch), seq, gib * 2**30) == \
                jserve.max_batch_for_capacity(jget(arch), seq, gib * 2**30)


# ===================================================================== #
# FlexGenEngine                                                         #
# ===================================================================== #
# stablelm-1.6b smoke, test_engines.py's fixture.  Prompt seed 10: the
# reference's greedy loop has top-2 logit margins of at least
# MIN_MARGIN at every step (most seeds have a near tie, where JAX and
# the port may round to different argmaxes)
PROMPT_SEED, B, P, NEW = 10, 2, 8, 4
MIN_MARGIN = 0.02
ENGINE_SHARES = {
    "all-device": ([("device", 1.0)], [("device", 1.0)]),
    "weights-half-pinned": ([("device", 0.5), ("pinned_host", 0.5)],
                            [("device", 1.0)]),
    "kv-thirds": ([("pinned_host", 1.0)],
                  [("device", 0.34), ("pinned_host", 0.33),
                   ("unpinned_host", 0.33)]),
}


@pytest.fixture(scope="module")
def flexgen_reference():
    """The reference's prefill + decode_step greedy loop: tokens (B,
    NEW) and the smallest top-2 margin of its steps."""
    jcfg, jparams, _, _ = _model("stablelm-1.6b")
    prompts = np.random.RandomState(PROMPT_SEED).randint(
        0, jcfg.vocab, (B, P)).astype(np.int32)
    logits, cache = jlm.prefill(jparams, jcfg, jnp.asarray(prompts))
    cache = _pad(cache, NEW)
    toks, margin = [], np.inf
    for i in range(NEW):
        top = np.sort(np.asarray(logits, np.float32), -1)
        margin = min(margin, float((top[:, -1] - top[:, -2]).min()))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i < NEW - 1:
            logits, cache = jlm.decode_step(jparams, jcfg, cache, tok)
    return prompts, np.concatenate(toks, 1), margin


@pytest.mark.parametrize("name", sorted(ENGINE_SHARES))
def test_flexgen_tokens_match_reference_loop(flexgen_reference, name):
    prompts, want, margin = flexgen_reference
    assert margin >= MIN_MARGIN       # the prompts hold no near tie
    _, _, cfg, params = _model("stablelm-1.6b")
    w, kv = ENGINE_SHARES[name]
    eng = serve_engine.FlexGenEngine(cfg, params, serve_engine.ServeConfig(
        max_new_tokens=NEW, prompt_len=P, weight_shares=w, kv_shares=kv),
        device="cpu")
    st = eng.run(prompts)
    assert eng.tokens.dtype == torch.int64
    np.testing.assert_array_equal(eng.tokens.numpy(), want)
    assert (st.batch, st.new_tokens) == (B, NEW)
    assert st.prefill_s > 0 and st.decode_s > 0 and st.decode_tok_s > 0
    # the ledger holds the padded KV on the asked kinds (block-rounded)
    on = {k: eng.kv_home.bytes_on(k)
          for k in ("device", "pinned_host", "unpinned_host")}
    kv_bytes = 2 * cfg.n_layers * B * (P + NEW) * cfg.n_kv \
        * cfg.head_dim * 2
    assert sum(on.values()) == (kv_bytes if eng.kv_home.offloaded else 0)
    assert all(not n or k in dict(kv) for k, n in on.items())
    # the weights really live on their shares
    leaf = eng.params_tiered["embed"]
    assert sorted(set(leaf.kinds)) == sorted(k for k, f in w if f > 0)


def _buckets(trace):
    return [(e, {o: dataclasses.asdict(t) for o, t in b.items()})
            for e, b in trace.buckets()]


def test_flexgen_telemetry_matches_reference(flexgen_reference):
    prompts, _, _ = flexgen_reference
    jcfg, jparams, cfg, params = _model("stablelm-1.6b")
    sc = dict(max_new_tokens=NEW, prompt_len=P,
              kv_shares=[("device", 0.5), ("pinned_host", 0.5)])
    jtrace, trace = JAccessTrace(), AccessTrace()
    jeng = jserve.FlexGenEngine(jcfg, jparams, jserve.ServeConfig(**sc),
                                telemetry=jtrace)
    eng = serve_engine.FlexGenEngine(cfg, params,
                                     serve_engine.ServeConfig(**sc),
                                     telemetry=trace, device="cpu")
    jeng.run(prompts)
    eng.run(prompts)
    assert _buckets(trace) == _buckets(jtrace)
    assert trace.phase_events == jtrace.phase_events
    assert trace.total_events == jtrace.total_events
    for kind in ("device", "pinned_host"):
        assert eng.kv_home.bytes_on(kind) == jeng.kv_home.bytes_on(kind)


def test_flexgen_rejects_frames():
    """A model with cross-attention needs frames: without them, or with
    frames of another width, the engine raises a ValueError that names
    them (the reference fails on ``None.shape``)."""
    _, _, cfg, params = _model("whisper-large-v3")
    eng = serve_engine.FlexGenEngine(cfg, params, device="cpu")
    with pytest.raises(ValueError, match=r"cross_inputs \(frames\)"):
        eng.run(np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="expected"):
        eng.run(np.zeros((1, 4), np.int32), frames=np.zeros((1, 16, 8)))


# the vision and Whisper smoke models, served one-shot with frames;
# prompt seeds whose reference greedy loop keeps every top-2 margin at
# MIN_MARGIN or more
FRAMES_SEEDS = {"llama-3.2-vision-11b": 25, "whisper-large-v3": 0}


@pytest.mark.parametrize("arch", sorted(FRAMES_SEEDS))
def test_flexgen_with_frames_matches_reference_engine(arch):
    jcfg, jparams, cfg, params = _model(arch)
    rs = np.random.RandomState(FRAMES_SEEDS[arch])
    prompts = rs.randint(0, jcfg.vocab, (B, P)).astype(np.int32)
    frames = _frames(cfg, B, seed=FRAMES_SEEDS[arch])
    sc = dict(max_new_tokens=NEW, prompt_len=P,
              kv_shares=[("device", 0.5), ("pinned_host", 0.5)])
    jeng = jserve.FlexGenEngine(jcfg, jparams, jserve.ServeConfig(**sc))
    margins = []
    step = jeng.decode_step

    def recording_step(*a):
        logits, cache = step(*a)
        top = np.sort(np.asarray(logits, np.float32), -1)
        margins.append(float((top[:, -1] - top[:, -2]).min()))
        return logits, cache
    jeng.decode_step = recording_step
    jeng.run(prompts, frames)
    jeng.decode_step = step
    want = _reference_tokens(jeng, jcfg, jparams, prompts, frames)
    assert min(margins[:-1] + [want[1]]) >= MIN_MARGIN
    eng = serve_engine.FlexGenEngine(cfg, params,
                                     serve_engine.ServeConfig(**sc),
                                     device="cpu")
    eng.run(prompts, frames)
    np.testing.assert_array_equal(eng.tokens.numpy(), want[0])
    # the recurrent and cross caches stay on the device; kv_k/kv_v are
    # tiered as the reference's are
    for kind in ("device", "pinned_host"):
        assert eng.kv_home.bytes_on(kind) == jeng.kv_home.bytes_on(kind)
    assert sorted(eng.kv_home._tiered) == ["kv_k", "kv_v"]


def _reference_tokens(jeng, jcfg, jparams, prompts, frames):
    """The reference engine's tokens, which it does not keep: its
    greedy loop replayed (tokens (B, NEW), the first step's margin)."""
    logits, cache = jeng.prefill_step(
        jparams, {"tokens": jnp.asarray(prompts),
                  "frames": jnp.asarray(frames)})
    cache = _pad(cache, NEW)
    top = np.sort(np.asarray(logits, np.float32), -1)
    first = float((top[:, -1] - top[:, -2]).min())
    toks = []
    for i in range(NEW):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok))
        if i < NEW - 1:
            logits, cache = jeng.decode_step(jparams, cache, tok)
    return np.concatenate(toks, 1), first


# ===================================================================== #
# CLI                                                                   #
# ===================================================================== #
LINE = re.compile(r"batch=(\d+) prefill=[\d.]+ ms decode=[\d.]+ tok/s "
                  r"\((\d+) new tokens/seq; weights (\d+)% host, "
                  r"KV (\d+)% host\)")


def test_cli_oneshot_prints_the_reference_line(capsys):
    from repro.launch import serve as jserve_cli
    from repro_torch.launch import serve
    argv = ["--arch", "llama3-8b", "--smoke", "--scheduler", "oneshot",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "3",
            "--weights-host-frac", "0.25", "--kv-host-frac", "0.5"]
    serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    jserve_cli.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 1
    assert LINE.fullmatch(got[0]).groups() == \
        LINE.fullmatch(want[0]).groups() == ("2", "3", "25", "50")


def test_cli_defaults_to_oneshot():
    """``python -m repro_torch.launch.serve --smoke --device cpu`` runs
    the one-shot path, as the reference's CLI does by default."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    m = LINE.fullmatch(res.stdout.strip())
    assert m is not None, res.stdout
    assert m.groups() == ("4", "16", "0", "0")


def test_cli_oneshot_serves_rwkv(capsys):
    """``--arch rwkv6-7b --smoke --scheduler oneshot``: the attention-free
    model serves one-shot (its O(1) states stay on the device) and
    prints the reference CLI's line."""
    from repro.launch import serve as jserve_cli
    from repro_torch.launch import serve
    argv = ["--arch", "rwkv6-7b", "--smoke", "--scheduler", "oneshot",
            "--batch", "2", "--prompt-len", "8", "--new-tokens", "3",
            "--kv-host-frac", "0.5"]
    serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    jserve_cli.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 1
    assert LINE.fullmatch(got[0]).groups() == \
        LINE.fullmatch(want[0]).groups() == ("2", "3", "0", "50")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "whisper-large-v3"])
def test_cli_oneshot_without_frames_raises(arch):
    """The CLI supplies no frames (as the reference's, which has no
    flag for them); the models that need them raise a ValueError."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="frames"):
        serve.main(["--arch", arch, "--smoke", "--batch", "1",
                    "--prompt-len", "4", "--new-tokens", "2",
                    "--device", "cpu"])


@pytest.mark.parametrize("flag", [["--fused-gather"],
                                  ["--trace-out", "t.jsonl"]])
def test_cli_oneshot_rejects_continuous_flags(flag, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", *flag])
    assert "only takes effect with --scheduler continuous" in \
        capsys.readouterr().err
