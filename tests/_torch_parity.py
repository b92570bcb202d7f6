"""Shared helpers for the PyTorch-port parity tests (not collected).

The same inputs, made with numpy, go through the JAX reference and the
port; values cross as numpy arrays.  bf16 crosses bit-exactly through an
int16 view (``repro_torch.models.lm.tensor_from_numpy``).
"""
import numpy as np
import pytest
import torch

from repro_torch.models.lm import params_from_numpy, tensor_from_numpy

# the driver runs several test workers on one machine
torch.set_num_threads(2)

# the reference tests' tolerances
FP32 = dict(rtol=2e-3, atol=2e-3)
BF16 = dict(rtol=3e-2, atol=3e-2)


def to_torch(a) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor of the same dtype."""
    return tensor_from_numpy(np.asarray(a), "cpu")


def tree_to_torch(tree):
    """A JAX parameter tree as the port's CPU parameter tree."""
    import jax
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def to_numpy(x) -> np.ndarray:
    """Tensor or array as float32 numpy, for comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=FP32) -> None:
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), **tol)


def normal(rs: np.random.RandomState, shape, scale=1.0,
           dtype=np.float32) -> np.ndarray:
    return (rs.standard_normal(shape) * scale).astype(dtype)


# ===================================================================== #
# framework-free planes: one scenario, run once on each package         #
# ===================================================================== #
# floats of the control planes: the same float64 arithmetic on both
# sides, held to 1e-9 relative; integers, strings and decisions exactly
PLANE_REL = 1e-9


def package(root: str, *modules: str):
    """A namespace holding ``root`` and the given submodules of it, as
    attributes named with ``_`` for ``.`` (``"obs.qos"`` -> ``obs_qos``),
    so that one scenario function runs against either package."""
    import importlib
    import types
    ns = types.SimpleNamespace(root=root)
    for m in modules:
        setattr(ns, m.replace(".", "_"),
                importlib.import_module(f"{root}.{m}"))
    return ns


def plain(x):
    """A result as builtins: dataclasses as dicts of their fields, enums
    by name, tuples as lists, numpy scalars and arrays as Python values,
    other keys and objects by ``str`` — so the two packages' results,
    which are instances of different classes, compare."""
    import dataclasses
    import enum
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, dict):
        return {_key(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((plain(v) for v in x), key=repr)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return str(x)


def _key(k):
    if isinstance(k, tuple):
        return tuple(_key(v) for v in k)
    if k is None or isinstance(k, (bool, int, float, str)):
        return k
    return str(k)


def assert_same(got, want, rel=PLANE_REL, path="result") -> None:
    """``got`` (the port's) equals ``want`` (the reference's) after
    ``plain``: floats within ``rel`` relative (exactly for zero),
    everything else exactly."""
    got, want = plain(got), plain(want)
    _same(got, want, rel, path)


def _same(got, want, rel, path):
    if isinstance(want, float) and isinstance(got, (int, float)) \
            and not isinstance(got, bool):
        if want != want:                            # NaN
            assert got != got, f"{path}: {got} != NaN"
            return
        if want in (float("inf"), -float("inf")):
            assert got == want, f"{path}: {got!r} != {want!r}"
            return
        assert abs(got - want) <= rel * abs(want), \
            f"{path}: {got!r} != {want!r}"
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            f"{path}: keys {sorted(map(repr, got))} != " \
            f"{sorted(map(repr, want))}"
        for k in want:
            _same(got[k], want[k], rel, f"{path}[{k!r}]")
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            f"{path}: length {len(got)} != {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, rel, f"{path}[{i}]")
        return
    assert got == want, f"{path}: {got!r} != {want!r}"


def raised(fn, *args, **kw) -> str:
    """The type name and message of what ``fn`` raises ("" if
    nothing)."""
    try:
        fn(*args, **kw)
    except Exception as e:   # the scenario records what the call raised
        return f"{type(e).__name__}: {e}"
    return ""


# ===================================================================== #
# engines: the same requests through the reference's and the port's     #
# ===================================================================== #
# wall-clock outputs of telemetry_summary (never compared)
TIMED = {"live_burst_entry_ratio"}


class StepClock:
    """An engine clock read off the engine's iteration counter: every
    read within iteration ``s`` gives ``dt * (s + (s % 4) / 4)``, so two
    engines that take the same decisions see the same times however
    often each reads its clock, and the decode gaps vary (1.25 dt, or
    0.25 dt every fourth iteration)."""

    def __init__(self, dt: float = 0.01):
        self.dt = dt
        self.engine = None

    def __call__(self) -> float:
        s = 0 if self.engine is None else self.engine._step
        return self.dt * (s + (s % 4) / 4)


class PlaneSteps:
    """A cluster plane's step count: the sum of its engines' iteration
    counters, so one ``StepClock`` serves replicas that run in turn."""

    def __init__(self, plane):
        self.plane = plane

    @property
    def _step(self):
        return sum(r.engine._step for r in self.plane.replicas.values())


def ref_pod_parts():
    """The per-host parts of the reference's ``multi_host_pod``, as the
    port's ``multi_host_pod(tiers=...)`` takes them: its TPU HBM, its
    host DRAM behind the 700 ns PCIe/CXL hop it models, and its ICI
    links.  Parity input only."""
    import dataclasses

    from repro.core import tpu_v5e_tiers
    from repro_torch.core.tiers import MemoryTier
    t = tpu_v5e_tiers()
    tier = {k: MemoryTier(**dataclasses.asdict(t[k]))
            for k in ("HBM", "HOST", "ICI_PEER")}
    hbm, host, ici = tier["HBM"], tier["HOST"], tier["ICI_PEER"]
    hop = 700.0
    return {"fast": hbm,
            "capacity": dataclasses.replace(
                host, unloaded_latency_ns=host.unloaded_latency_ns - hop),
            "capacity_link": (hop, host.peak_bw_GBps),
            "host_link": (ici.unloaded_latency_ns - hbm.unloaded_latency_ns,
                          ici.peak_bw_GBps)}


def tiny_model(arch: str, seed: int, lens):
    """(reference config, reference params, port config, port params,
    prompts) of ``arch``'s smoke config: the port's params are the
    reference's, bit for bit; prompts drawn with numpy from ``seed``."""
    import jax

    from repro.configs import get_smoke_config as jsmoke
    from repro.models import lm as jlm
    from repro_torch.configs import get_smoke_config
    jcfg = jsmoke(arch)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(seed)
    prompts = [rs.randint(0, jcfg.vocab, (n,)).astype(np.int32)
               for n in lens]
    return jcfg, jparams, get_smoke_config(arch), tree_to_torch(jparams), \
        prompts


def tpu_bases(pool):
    """The reference's TPU descriptors of the three memory kinds as the
    port's MemoryTier: the parity input the port's ``kind_bases`` is
    monkeypatched with, so both engines plan over the same tiers."""
    import dataclasses

    from repro.core import tpu_v5e_tiers
    from repro_torch.core.tiers import MemoryTier
    t = tpu_v5e_tiers()
    return {kind: MemoryTier(**dataclasses.asdict(t[name]))
            for kind, name in (("device", "HBM"), ("pinned_host", "HOST"),
                               ("unpinned_host", "HOST_UNPINNED"))}


def serve_both(model, sv: dict, new_tokens: int):
    """Serve ``model``'s prompts on the reference engine and on the
    port's (CPU), each on its own ``StepClock``, with the serving
    options ``sv``.  Returns (reference engine, its report, port engine,
    its report)."""
    from repro.serving import ServingConfig as JServingConfig
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import ServingConfig, ServingEngine
    jcfg, jparams, cfg, params, prompts = model
    out = []
    for cls, sv_cls, c, p, extra in (
            (JServingEngine, JServingConfig, jcfg, jparams, {}),
            (ServingEngine, ServingConfig, cfg, params, {"device": "cpu"})):
        clock = StepClock()
        eng = cls(c, p, sv_cls(**sv), clock=clock, **extra)
        clock.engine = eng
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=new_tokens)
        out += [eng, eng.run()]
    return tuple(out)


def engine_tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.sched.finished}


def engine_trace(eng):
    """The control-plane trace without its timestamps."""
    return [(e.name, e.cat, e.ph, e.tid, e.args) for e in eng.tracer.events]


def assert_engines_match(ref, ref_rep, eng, rep) -> None:
    """Tokens, telemetry summary (wall-time keys excluded), replan
    decisions, tiering counters, SLO report and the whole trace of the
    port's engine equal the reference engine's."""
    assert engine_tokens(eng) == engine_tokens(ref)
    assert_same({k: v for k, v in rep.telemetry.items() if k not in TIMED},
                {k: v for k, v in ref_rep.telemetry.items()
                 if k not in TIMED})
    assert rep.tiering == ref_rep.tiering
    assert_same(rep.slo, ref_rep.slo)
    if ref.replanner is not None:
        assert_same(eng.replanner.decisions, ref.replanner.decisions)
    assert_same(engine_trace(eng), engine_trace(ref))


# ===================================================================== #
# whole smoke models                                                    #
# ===================================================================== #
def draw_gates(tree, rs: np.random.RandomState):
    """A reference parameter tree with the cross layers' tanh gates (0 at
    init, which silences the layer) drawn from N(0, 1), so that the
    cross path shows."""
    import jax
    import jax.numpy as jnp

    def draw(path, leaf):
        if getattr(path[-1], "key", None) in ("gate_attn", "gate_mlp"):
            return jnp.asarray(normal(rs, leaf.shape), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, tree)


def smoke_model(arch: str):
    """(reference config, reference params, port config, port params) of
    ``arch``'s smoke variant, the gates drawn (``draw_gates``, seed 11);
    the port's params are the reference's, bit for bit."""
    import jax
    from repro.configs import get_smoke_config as jsmoke
    from repro.models import lm as jlm
    from repro_torch.configs import get_smoke_config
    jcfg = jsmoke(arch)
    jparams = draw_gates(jlm.init_params(jax.random.PRNGKey(0), jcfg),
                         np.random.RandomState(11))
    return jcfg, jparams, get_smoke_config(arch), tree_to_torch(jparams)


def eager(fn, *args):
    """A reference function run op by op (``jax.disable_jit``).  XLA's
    compiled scan fuses bf16 operations and keeps some intermediates in
    fp32; some smoke models amplify that rounding past the bf16
    tolerance (``ROUNDING_SENSITIVE``).  Run op by op, the reference
    rounds each operation as the port does."""
    import jax
    with jax.disable_jit():
        return fn(*args)


def compiled(fn, *args):
    """A reference function called as it is (its scans compiled)."""
    return fn(*args)


def reference_silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference rounds it op by op in bf16 on the
    CPU: the sigmoid as 1 / (1 + exp(-x)), each step rounded to x's
    dtype.  The port's ``F.silu`` rounds once, a bf16 ulp apart on ~40%
    of elements."""
    return x * (1 / (1 + torch.exp(-x)))


class _ReferenceRoundingF:
    """``torch.nn.functional`` with ``silu`` rounded as the reference
    rounds it (``reference_silu``)."""
    silu = staticmethod(reference_silu)

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)


# smoke models on which the port, as it is, parts from the compiled
# reference past the bf16 tolerance in a whole-model prefill or decode
# step, and from the op-by-op reference too unless its silu rounds as
# the reference's does there: the cross layers' drawn gates (vision),
# the RWKV recurrence and jamba's stacked Mamba blocks and MoE routing
# amplify a bf16 ulp.  The JAX package's own compiled and op-by-op runs
# of jamba's smoke model part too (test_jamba_reference_rounding_spread).
ROUNDING_SENSITIVE = frozenset({"llama-3.2-vision-11b",
                                "jamba-1.5-large-398b", "rwkv6-7b"})


def reference_runner(arch: str, monkeypatch):
    """How a whole-model test of ``arch`` calls the reference: compiled,
    against the port as it is; or, for a ``ROUNDING_SENSITIVE`` model,
    op by op (``eager``), with the port's model blocks rounding silu as
    the reference does there (``reference_silu``, for this test only)."""
    if arch not in ROUNDING_SENSITIVE:
        return compiled
    from repro_torch.models import modules
    monkeypatch.setattr(modules, "F", _ReferenceRoundingF())
    return eager


def fp32_models(jparams, monkeypatch):
    """A whole model in fp32 in both packages, for a test only: the
    reference's params with every float leaf upcast (returned with
    their port copy), and both packages' ``_embed_tokens`` returning
    the embedding rows in the params' dtype (both round them to bf16).
    Models that add no position embeddings there only."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jlm
    from repro_torch.models import lm

    def rows(p, cfg, tokens, index=None):
        assert cfg.pos_emb not in ("learned", "sinusoidal"), cfg.pos_emb
        return p["embed"][tokens]
    monkeypatch.setattr(jlm, "_embed_tokens", rows)
    monkeypatch.setattr(lm, "_embed_tokens", rows)
    jparams = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jparams)
    return jparams, tree_to_torch(jparams)
