"""Serving over multi-device replica meshes: the port's placement, its
sharded model steps and its cluster plane over *logical* CPU devices (a
mesh that names the CPU several times), against the JAX reference's
under forced host devices.

(a) placement: each leaf's spec and shard shapes are what the
reference's ``_leaf_logical_axes`` and its divides-or-replicates rule
give; (b) shards are views of the source and replicated leaves are
shared, so placement adds 0 B; (c) the vocab-split embedding and head
(greedy argmax with ties planted across a shard boundary) and the staged
``moe_fwd`` over split experts are bit-equal to one device; (d) the
expert FFN over expert ranges sums to the whole one; (e) end to end, the
port's ``ClusterPlane`` over 4 and 8 logical CPU devices gives the
reference plane's tokens, routing and ledger bytes per namespace under
4 and 8 forced host devices, also with MoE expert residency over the
split expert store and the adaptive, predictive and QoS planes, whose
fast-resident expert blocks after every iteration and whole telemetry
summaries must equal the reference's too; a routing feed cut to the
first expert shard (a planted fault) must not.

The reference's side of (e) runs in a subprocess (``XLA_FLAGS`` must be
set before JAX starts): this file run as a script,

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src:tests python tests/test_torch_sharded_serving.py

prints its cases as one JSON object.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from repro_torch.models import shardings as msh  # noqa: E402
from _torch_parity import (assert_same, PlaneSteps, plain,  # noqa: E402
                           ref_pod_parts, StepClock, TIMED, tiny_model)

MESH_SIZES = (1, 2, 3, 4, 8)
MAPPINGS = {"none": {}, "vocab": {"vocab": "model"},
            "experts": {"experts": "model"},
            "both": {"vocab": "model", "experts": "model"}}
CPU = torch.device("cpu")
# end to end: (arch, prompt seed, prompt lengths, new tokens, mapping,
# fused).  The MoE prompts are test_torch_experts.py's, whose decode
# tokens keep a top-2 logit gap of 0.0059 or more and whose fused router
# a top-8 minus top-9 probability of 3.4e-3 or more on one device: the
# near-tie rule of the MoE engine tests (prompts without near ties), so
# that tokens compare the function, not rounding at a tie
# and the serving options beside the fixed ones of ``_serving``: the
# control planes of ``PLANES`` (``calibrate`` left out: its probes time
# real copies), with MoE expert residency over the split expert store
PLANES = dict(adaptive=True, predictive=True, replan_every=2, qos=True,
              topology="vendor-a", slo_p95_decode_s=0.02)
_MOE = ("qwen3-moe-30b-a3b", 8, (10, 6, 13), 10, "both")
_LLAMA = ("llama3-8b", 2, (12, 7, 9, 20, 5), 6, "vocab")
E2E = {
    "qwen3-moe staged": _MOE + (False, {}),
    "qwen3-moe fused": _MOE + (True, {}),
    "llama3-8b": _LLAMA + (False, {}),
    "qwen3-moe fused lru": _MOE + (True, dict(expert_policy="lru")),
    "qwen3-moe fused planes": _MOE + (
        True, dict(expert_policy="predictive", **PLANES)),
    "qwen3-moe staged planes": _MOE + (
        False, dict(expert_policy="predictive", **PLANES)),
    "llama3-8b planes": _LLAMA + (False, PLANES),
}
E2E_DEVICES = (4, 8)
E2E_TIMEOUT_S = 600


def _mesh(n):
    from repro_torch.cluster.sharding import replica_meshes
    return replica_meshes(1, devices=[CPU] * n)[0]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield path, tree


# ===================================================================== #
# (a) placement against the reference's rule                            #
# ===================================================================== #
_PARAMS = {}


def _params(arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    if arch not in _PARAMS:
        cfg = get_smoke_config(arch)
        _PARAMS[arch] = (cfg, lm.init_params(cfg, seed=0, device="cpu"))
    return _PARAMS[arch]


def _reference_spec(path, shape, mapping, n):
    """The spec the reference's ``shard_lm_params`` gives a leaf on a
    1-D mesh of ``n`` devices over axis ``model``: its
    ``_leaf_logical_axes``, and a dimension split only where the mapping
    routes it to the mesh axis and it divides the axis size."""
    from repro.cluster.sharding import _leaf_logical_axes
    spec = []
    for dim, logical in zip(shape, _leaf_logical_axes(path, len(shape))):
        phys = mapping.get(logical) if logical else None
        spec.append(phys if phys == "model" and dim % n == 0 else None)
    return tuple(spec)


def _arch_ids():
    from repro_torch.configs.registry import ARCH_IDS
    return ARCH_IDS


@pytest.mark.parametrize("n", MESH_SIZES)
@pytest.mark.parametrize("arch", _arch_ids())
def test_placement_matches_reference_rule(arch, n):
    from repro_torch.cluster import sharding as sh
    _, params = _params(arch)
    mesh = _mesh(n)
    for name, mapping in MAPPINGS.items():
        with sh.axis_mapping(mapping):
            placed = sh.shard_lm_params(params, mesh)
        got = dict(_flat(placed))
        for path, leaf in _flat(params):
            st = got[path]
            want = _reference_spec(path, tuple(leaf.shape), mapping, n)
            assert tuple(st.spec) == want, (name, path)
            shard = tuple(d // n if s else d
                          for d, s in zip(leaf.shape, want))
            assert st.shard_shapes() == [shard] * n, (name, path)
            assert st.shape == leaf.shape and st.dtype == leaf.dtype


def test_placement_splits_the_reference_smoke_leaves():
    """The reference's own check on qwen3-moe smoke over 2 devices with
    experts and vocab split: ``embed`` (512, 64) in two (256, 64)
    shards; the stacked router (U, D, E) split on d_model, as the
    reference places it."""
    from repro_torch.cluster import sharding as sh
    cfg, params = _params("qwen3-moe-30b-a3b")
    with sh.axis_mapping(MAPPINGS["both"]):
        placed = sh.shard_lm_params(params, _mesh(2))
    assert placed["embed"].shard_shapes() == [(256, 64)] * 2
    moe = placed["units"]["layers"][0]["moe"]
    U, D, E = cfg.n_units, cfg.d_model, cfg.n_experts
    assert moe["router"].shard_shapes() == [(U, D // 2, E)] * 2
    assert moe["w_up"].shard_shapes() == [(U, E // 2, D, cfg.d_ff)] * 2
    assert placed["lm_head"].spec == ("model", None)


# ===================================================================== #
# (b) views and sharing                                                 #
# ===================================================================== #
@pytest.mark.parametrize("n", (2, 3, 4, 8))
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama3-8b"])
def test_placement_adds_no_bytes(arch, n):
    """Every shard lies in its source leaf's storage: a split block is a
    view, a replicated leaf is the leaf itself on every logical device
    of the one CPU."""
    from repro_torch.cluster import sharding as sh
    _, params = _params(arch)
    with sh.axis_mapping(MAPPINGS["both"]):
        placed = dict(_flat(sh.shard_lm_params(params, _mesh(n))))
    added = 0
    for path, leaf in _flat(params):
        st = placed[path]
        base = leaf.untyped_storage().data_ptr()
        for local in st.shards:
            if local.untyped_storage().data_ptr() != base:
                added += local.numel() * local.element_size()
        if not st.is_split:
            assert all(t is leaf for t in st.shards)
        else:
            assert len({t.data_ptr() for t in st.shards}) == n
    assert added == 0


def test_mesh_of_logical_devices():
    from repro_torch.launch.mesh import make_mesh, Mesh
    mesh = make_mesh((4,), ("model",), devices=["cpu"] * 4)
    assert mesh.first_device == CPU and mesh.physical_devices == [CPU]
    with pytest.raises(ValueError, match="has no one device"):
        mesh.device
    with pytest.raises(ValueError, match="CUDA device"):
        Mesh(np.array([torch.device("cuda", 3)], dtype=object), ("model",))


def test_replica_shard_map_runs_per_device_blocks():
    """``fn`` runs once per mesh device on its blocks; the outputs are
    assembled under ``out_specs``."""
    from repro_torch.cluster import sharding as sh
    mesh = _mesh(4)
    x = torch.arange(24.0).reshape(8, 3)
    w = torch.full((3,), 2.0)
    seen = []

    def fn(xb, wb):
        seen.append(tuple(xb.shape))
        return xb * wb, xb.sum(0, keepdim=True)

    out, sums = sh.replica_shard_map(
        fn, mesh, (sh.PartitionSpec("model"), None),
        (sh.PartitionSpec("model"), sh.PartitionSpec("model")))(x, w)
    assert seen == [(2, 3)] * 4
    assert torch.equal(out.full(), x * w)
    assert sums.shape == (4, 3)
    assert torch.equal(sums.full(), x.reshape(4, 2, 3).sum(1))


# ===================================================================== #
# (c) the sharded steps, bit-equal to one device                         #
# ===================================================================== #
@pytest.mark.parametrize("n", (2, 3, 4))
def test_embed_and_head_argmax_equal_one_device(n):
    from repro_torch.cluster import sharding as sh
    cfg, params = _params("llama3-8b")
    with sh.axis_mapping(MAPPINGS["vocab"]):
        placed = msh.compute_view(sh.shard_lm_params(params, _mesh(n)))
    assert msh.is_split(placed["embed"]) == (cfg.vocab % n == 0)
    tokens = torch.as_tensor(np.random.RandomState(n).randint(
        0, cfg.vocab, (3, 11)))
    tokens[0, :4] = torch.tensor([0, cfg.vocab - 1, cfg.vocab // 2,
                                  cfg.vocab // 2 - 1])
    rows = msh.embed_rows(placed["embed"], tokens)
    assert torch.equal(rows, params["embed"][tokens])
    x = torch.as_tensor(np.random.RandomState(7).standard_normal(
        (6, cfg.d_model)), dtype=torch.bfloat16)
    logits = msh.vocab_logits(x, placed["lm_head"])
    want = (x @ params["lm_head"].T).float()
    assert torch.equal(msh.gather(logits), want)
    assert torch.equal(msh.argmax(logits), torch.argmax(want, -1))


@pytest.mark.parametrize("n", (2, 4, 8))
def test_argmax_ties_across_a_shard_boundary(n):
    """Equal maxima planted on both sides of a shard boundary and inside
    one shard: the lowest index wins, as ``torch.argmax`` over the whole
    row."""
    from repro_torch.cluster import sharding as sh
    V = 64
    full = torch.as_tensor(np.random.RandomState(0).standard_normal(
        (5, V)), dtype=torch.float32)
    b = V // n
    full[0, b - 1] = full[0, b] = 9.0           # across the first boundary
    full[1, V - b] = full[1, V - 1] = 9.0       # inside the last shard
    full[2, :] = 1.0                            # a flat row
    full[3, b] = full[3, 0] = 9.0               # first index in shard 0
    logits = msh.shard_tensor(full, _mesh(n), (None, "model"))
    assert logits.is_split
    assert torch.equal(msh.argmax(logits), torch.argmax(full, -1))
    assert msh.argmax(logits)[:4].tolist() == [b - 1, V - b, 0, 0]


@pytest.mark.parametrize("n", (2, 3, 4))
def test_staged_moe_equals_one_device(n):
    """``moe_fwd`` (the staged path and prefill) with experts split: the
    router gathered whole, each shard's buckets against its own experts,
    the combine on the first device in slot order."""
    from repro_torch.cluster import sharding as sh
    from repro_torch.models import modules as M
    cfg, params = _params("qwen3-moe-30b-a3b")
    with sh.axis_mapping(MAPPINGS["experts"]):
        placed = msh.compute_view(sh.shard_lm_params(params, _mesh(n)))
    x = torch.as_tensor(np.random.RandomState(1).standard_normal(
        (3, 9, cfg.d_model)), dtype=torch.bfloat16)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              n_groups=cfg.moe_groups, act=cfg.act)
    for u in range(cfg.n_units):
        mp = placed["units"]["layers"][0]["moe"]
        one = {k: v[u] for k, v in
               params["units"]["layers"][0]["moe"].items()}
        sharded = {k: v[u] for k, v in mp.items()}
        assert msh.is_split(sharded["w_up"]) == (cfg.n_experts % n == 0)
        got, aux = M.moe_fwd(sharded, x, **kw)
        want, aux1 = M.moe_fwd(one, x, **kw)
        assert torch.equal(got, want) and torch.equal(aux, aux1)


@pytest.mark.parametrize("n", (2, 4, 8))
def test_prefill_equals_one_device(n):
    """Whole-model prefill with experts and vocab split: logits and
    cache equal one device's."""
    from repro_torch.cluster import sharding as sh
    from repro_torch.models import lm
    cfg, params = _params("qwen3-moe-30b-a3b")
    with sh.axis_mapping(MAPPINGS["both"]):
        placed = msh.compute_view(sh.shard_lm_params(params, _mesh(n)))
    tokens = torch.as_tensor(np.random.RandomState(2).randint(
        0, cfg.vocab, (2, 9)))
    want, c1 = lm.prefill(params, cfg, tokens)
    got, c2 = lm.prefill(placed, cfg, tokens)
    assert msh.is_split(got)
    assert torch.equal(msh.gather(got), want)
    assert torch.equal(c1["kv_k"], c2["kv_k"])


# ===================================================================== #
# (d) the expert FFN over expert ranges                                  #
# ===================================================================== #
def _expert_case(seed, E=8, D=32, F=64, B=5, K=3):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, D)).astype(np.float32) * 0.3
    wg, wu = (rs.standard_normal((E, D, F)).astype(np.float32) * 0.1
              for _ in range(2))
    wd = rs.standard_normal((E, F, D)).astype(np.float32) * 0.1
    ids = np.stack([rs.permutation(E)[:K] for _ in range(B)]).astype(
        np.int32)
    ids[1, -1] = ids[1, 0]                       # a duplicated expert
    z = rs.standard_normal((B, K))
    wts = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    return x, wg, wu, wd, ids, wts


def _ranges(E, n):
    return [(i * E // n, (i + 1) * E // n) for i in range(n)]


@pytest.mark.parametrize("n", (1, 2, 4, 8))
def test_expert_partials_sum_to_the_whole(n):
    import jax.numpy as jnp

    from _torch_parity import assert_close, FP32, to_torch
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops, ref
    args = _expert_case(n)
    x, wg, wu, wd, ids, wts = map(to_torch, args)
    E = wg.shape[0]
    total = sum(ops.fused_expert_ffn_partial(
        x, wg[lo:hi], wu[lo:hi], wd[lo:hi], ids, wts, lo, hi, E)
        for lo, hi in _ranges(E, n))
    whole = ref.expert_ffn(x, wg, wu, wd, ids, wts)
    assert total.dtype == torch.float32
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert_close(total, jops.fused_expert_ffn(*map(jnp.asarray, args)),
                 FP32)


def test_expert_partial_skips_other_ranges_and_refuses_bad_ranges():
    from _torch_parity import to_torch
    from repro_torch.kernels import ops
    x, wg, wu, wd, ids, wts = map(to_torch, _expert_case(3))
    E = wg.shape[0]
    ids[:] = 6                                   # every slot in [4, 8)
    assert not ops.fused_expert_ffn_partial(
        x, wg[:4], wu[:4], wd[:4], ids, wts, 0, 4, E).any()
    ids[2, 1] = E                                # an id outside [0, E)
    out = ops.fused_expert_ffn_partial(x, wg[4:], wu[4:], wd[4:], ids,
                                       wts, 4, 8, E)
    assert torch.isnan(out[2]).all() and torch.isfinite(out[[0, 1, 3]]).all()
    for lo, hi in ((-1, 3), (2, 9), (5, 4)):
        with pytest.raises(ValueError, match="expert range"):
            ops.fused_expert_ffn_partial(x, wg, wu, wd, ids, wts, lo, hi, E)
    with pytest.raises(ValueError, match="stack of 8 experts"):
        ops.fused_expert_ffn_partial(x, wg, wu, wd, ids, wts, 0, 4, E)


@pytest.mark.cuda
def test_expert_range_kernel_on_the_card():
    """The range kernel on the card: each range's fp32 partial against
    its plain version, and their sum against the whole kernel, at the
    tolerance of the kernel checks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_gather import (fused_expert_ffn,
                                                   fused_expert_ffn_partial)
    args = [torch.as_tensor(a).cuda() for a in _expert_case(5, E=16, D=64,
                                                            F=128, B=4,
                                                            K=4)]
    x, wg, wu, wd = (a.bfloat16() for a in args[:4])
    ids, wts = args[4], args[5]
    E = wg.shape[0]
    total = 0
    for lo, hi in _ranges(E, 4):
        part = fused_expert_ffn_partial(x, wg[lo:hi], wu[lo:hi], wd[lo:hi],
                                        ids, wts, lo, hi, E)
        want = ref.expert_ffn_partial(x, wg[lo:hi], wu[lo:hi], wd[lo:hi],
                                      ids, wts, lo, hi, E)
        torch.testing.assert_close(part, want, rtol=1.6e-2, atol=2e-3)
        total = total + part
    whole = fused_expert_ffn(x, wg, wu, wd, ids, wts).float()
    torch.testing.assert_close(total.bfloat16().float(), whole, rtol=1.6e-2,
                               atol=2e-3)


# ===================================================================== #
# (e) the cluster plane end to end, against the reference's              #
# ===================================================================== #
def _serving(ns, fused, options):
    return ns.serving.ServingConfig(block_tokens=8, max_batch=2,
                                    max_context=32, policy="tiering08",
                                    fused_gather=fused, **options)


def _fast_experts(pool):
    """The (layer, expert) blocks an expert pool keeps fast-resident."""
    return sorted([list(k) for k, kind in pool.kinds.items()
                   if kind == "device"])


def _plane_run(ns, cfg, params, prompts, new_tokens, mapping, fused,
               options, feed=None, **kw):
    """Serve ``prompts`` through a two-replica plane under ``mapping``
    with the serving ``options`` on one step clock (``feed(record)``
    may wrap each expert pool's routing feed); returns tokens by
    session, routing, the ledger bytes by namespace on both kinds after
    every iteration, each replica's fast-resident expert blocks after
    each of its iterations, each replica's telemetry summary (the
    wall-clock keys of ``TIMED`` left out) and mesh size; and the
    plane."""
    clock = StepClock()
    with ns.cluster.axis_mapping(mapping):
        plane = ns.cluster.ClusterPlane(
            cfg, params, serving=_serving(ns, fused, options),
            n_replicas=2, router_policy="headroom-distance", clock=clock,
            seed=1, **kw)
    clock.engine = PlaneSteps(plane)
    samples, experts = [], []
    for host, r in plane.replicas.items():
        # the bytes by namespace after every iteration of either replica
        def sampled(*a, _step=r.engine.metrics.on_iteration,
                    _pool=r.engine.expert_pool, _host=host, **k):
            _step(*a, **k)
            samples.append({kind: plane.namespace_conservation(kind)
                            for kind in ("device", "pinned_host")})
            if _pool is not None:
                experts.append([_host, _fast_experts(_pool)])
        r.engine.metrics.on_iteration = sampled
        if feed is not None:
            r.engine.expert_pool.record_routing = feed(
                r.engine.expert_pool.record_routing)
    sids = [plane.submit(p, new_tokens, arrival_s=0.005 * i)
            for i, p in enumerate(prompts)]
    rep = plane.run()
    tokens = {}
    for sid in sids:
        host, rid = sid.split(":")
        req = next(r for r in plane.replicas[host].engine.sched.finished
                   if r.rid == int(rid))
        tokens[sid] = [int(t) for t in req.out_tokens]
    telemetry = {
        host: plain({k: v for k, v in
                     r.engine.telemetry_summary().items()
                     if k not in TIMED})
        for host, r in plane.replicas.items()}
    return {"tokens": tokens, "routed": dict(rep.routed),
            "conservation": samples, "fast_experts": experts,
            "telemetry": telemetry,
            "mesh_devices": [int(r.mesh.devices.size)
                             for r in plane.replicas.values()]}, plane


def _reference_cases() -> dict:
    """Every E2E case through the reference's plane, in this process's
    devices; also the host0 replica's shard shapes per leaf."""
    import jax

    from repro import cluster, serving

    class _NS:
        pass
    ns = _NS()
    ns.cluster, ns.serving = cluster, serving
    out = {"devices": len(jax.devices())}
    for name, (arch, seed, lens, new, mapping, fused, options) in \
            E2E.items():
        jcfg, jparams, _, _, prompts = tiny_model(arch, seed, lens)
        res, plane = _plane_run(ns, jcfg, jparams, prompts, new,
                                MAPPINGS[mapping], fused, options)
        params = plane.replicas["host0"].params
        res["shards"] = {
            "/".join(path): [list(s.data.shape)
                             for s in leaf.addressable_shards]
            for path, leaf in _flat(params)}
        out[name] = res
    return out


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's cases under 4 and 8 forced host devices, each in
    its own process (both at once), each within ``E2E_TIMEOUT_S``."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(root / "src"),
                                           str(root / "tests")]))
    procs = {}
    for n in E2E_DEVICES:
        env_n = dict(env, XLA_FLAGS=(
            f"--xla_force_host_platform_device_count={n}"))
        procs[n] = subprocess.Popen(
            ["timeout", str(E2E_TIMEOUT_S), sys.executable, __file__],
            env=env_n, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    out = {}
    for n, proc in procs.items():
        stdout, stderr = proc.communicate()
        assert proc.returncode == 0, stderr[-4000:]
        out[n] = json.loads(stdout.strip().splitlines()[-1])
        assert out[n]["devices"] == n
    return out


def _port_run(name, n, feed=None):
    """Case ``name`` through the port's plane over ``n`` logical CPU
    devices (``feed`` as ``_plane_run`` takes it).  Returns (result,
    plane, config)."""
    from repro_torch import cluster, serving
    from repro_torch.topology import multi_host_pod

    class _NS:
        pass
    ns = _NS()
    ns.cluster, ns.serving = cluster, serving
    arch, seed, lens, new, mapping, fused, options = E2E[name]
    _, _, cfg, params, prompts = tiny_model(arch, seed, lens)
    got, plane = _plane_run(
        ns, cfg, params, prompts, new, MAPPINGS[mapping], fused, options,
        feed=feed, devices=["cpu"] * n,
        testbed=multi_host_pod(2, tiers=ref_pod_parts()))
    return got, plane, cfg


def _assert_plane_matches(got, want):
    assert got["tokens"] == want["tokens"]
    assert got["routed"] == want["routed"]
    assert got["conservation"] == want["conservation"]
    assert got["fast_experts"] == want["fast_experts"]
    assert_same(got["telemetry"], want["telemetry"], path="telemetry")


@pytest.mark.parametrize("name", list(E2E))
@pytest.mark.parametrize("n", E2E_DEVICES)
def test_plane_over_logical_devices_matches_reference(reference_runs, n,
                                                      name):
    got, plane, cfg = _port_run(name, n)
    arch, options = E2E[name][0], E2E[name][-1]
    want = reference_runs[n][name]
    assert got["mesh_devices"] == [n // 2] * 2
    _assert_plane_matches(got, want)
    placed = plane.replicas["host0"].params
    shards = {"/".join(path): [list(s) for s in leaf.shard_shapes()]
              for path, leaf in _flat(placed)}
    assert shards == want["shards"]
    m = n // 2
    assert shards["embed"] == [[cfg.vocab // m, cfg.d_model]] * m
    if arch.startswith("qwen3"):
        U, E = cfg.n_units, cfg.n_experts
        assert shards["units/layers/0/moe/w_up"] == \
            [[U, E // m, cfg.d_model, cfg.d_ff]] * m
    assert any(c["device"]["total"] for c in got["conservation"])
    for sample in got["conservation"]:
        for cons in sample.values():
            assert sum(v for h, v in cons.items() if h != "total") == \
                cons["total"]
    pools = {h: r.engine.expert_pool for h, r in plane.replicas.items()}
    if "expert_policy" not in options:
        assert got["fast_experts"] == [] and "expert.accesses" not in \
            got["telemetry"]["host0"]
        return
    n_moe = sum(1 for s in cfg.pattern if s.moe) * cfg.n_units
    for host, pool in pools.items():
        # one block per (layer, expert) at the whole expert's bytes,
        # under the expert tenant of the replica's namespace
        assert pool.tenant == f"{host}/serving.experts"
        assert len(pool.kinds) == n_moe * cfg.n_experts
        assert pool.ledger is not plane.ledger
        tel = got["telemetry"][host]
        if E2E[name][5]:
            assert tel["expert.accesses"] > 0
            assert tel["expert.promoted"] > 0
        else:                        # the staged path records no routing
            assert tel["expert.accesses"] == 0


@pytest.mark.parametrize("n", E2E_DEVICES)
def test_routing_feed_fault_is_seen(reference_runs, n):
    """Planted fault: a pool fed only the routed ids that fall in the
    first expert shard reads other counters than the reference's."""
    from repro_torch.configs import get_smoke_config
    name = "qwen3-moe fused lru"
    first = get_smoke_config(E2E[name][0]).n_experts // (n // 2)

    def first_shard(record):
        def fed(layer, ids, step):
            record(layer, [e for e in ids if e < first], step)
        return fed
    got, _, _ = _port_run(name, n, feed=first_shard)
    want = reference_runs[n][name]
    assert got["tokens"] == want["tokens"]
    for host, tel in got["telemetry"].items():
        assert tel["expert.accesses"] < \
            want["telemetry"][host]["expert.accesses"]
    with pytest.raises(AssertionError):
        _assert_plane_matches(got, want)


if __name__ == "__main__":
    print(json.dumps(_reference_cases()))
