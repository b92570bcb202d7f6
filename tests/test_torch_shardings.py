"""The port's mesh and partition rules against the JAX reference's, on
the CPU: ``param_pspecs``, ``opt_state_pspecs``, ``cache_pspecs`` and
``batch_pspec`` for every config of the registry at full size, at the
meshes (1, 1), (2, 4), (16, 16) and (2, 16, 16); ``dp_axes``,
``dp_size`` and ``tp_size``; ``constrain`` as the identity under any
mesh; ``to_named`` keeping the tensors on one device and splitting
them into contiguous blocks over logical devices.

The rules read only shapes and the mesh's axis names and shape, so
neither side needs the devices: the reference gets a duck-typed mesh
and ``jax.eval_shape`` trees, the port its own ``Mesh`` over a grid of
CPU device entries and trees of fake tensors."""
import dataclasses
import functools
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import shardings as jsh  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.models import lm, psharding  # noqa: E402
from repro_torch.models import shardings as sh  # noqa: E402

CPU = torch.device("cpu")
MESHES = {(1, 1): ("data", "model"), (2, 4): ("data", "model"),
          (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
MESH_IDS = ["x".join(map(str, s)) for s in MESHES]
CACHE_BATCHES = (1, 8, 128)
CACHE_SEQ, ENC_LEN = 4096, 1500


def _meshes(shape):
    """(the reference's duck-typed mesh, the port's Mesh) of ``shape``."""
    axes = MESHES[shape]
    ref = types.SimpleNamespace(axis_names=axes,
                                devices=types.SimpleNamespace(shape=shape))
    grid = np.empty(shape, dtype=object)
    grid.fill(CPU)
    return ref, pmesh.Mesh(grid, axes)


def _norm(spec):
    """A spec as a tuple, a one-name tuple as the name and an empty one
    as None (newer jax normalizes ``P(("data",))`` to ``P("data")`` and
    ``P(())`` to ``P(None)``)."""
    def entry(ax):
        if isinstance(ax, tuple) and len(ax) <= 1:
            return ax[0] if ax else None
        return ax
    return tuple(entry(ax) for ax in spec)


def _ref_flat(tree):
    """{path: spec} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(jsh._path_keys(p)): _norm(s) for p, s in flat}


def _port_flat(tree):
    """{path: spec} of a port spec tree."""
    out = {}
    sh._map_with_path(lambda path, s: out.__setitem__("/".join(path),
                                                      _norm(s)), tree)
    return out


def _eval_shape(fn, *args, **kw):
    """What ``fn`` returns, as fake tensors: shapes and dtypes, no
    memory (``jax.eval_shape``)."""
    with FakeTensorMode():
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    jcfg = jget_config(arch)
    ref = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    return ref, _eval_shape(lm.init_params, get_config(arch),
                            device="cpu")


@functools.lru_cache(maxsize=None)
def _cache_shapes(arch, batch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if arch == "llama3-8b":          # the int8 cache's scale rules too
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ref = jax.eval_shape(lambda: jlm.make_decode_cache(
        jcfg, batch, CACHE_SEQ, ENC_LEN))
    return ref, _eval_shape(lm.make_decode_cache, cfg, batch, CACHE_SEQ,
                            ENC_LEN, device="cpu")


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_pspecs_match_reference(arch, shape):
    ref_shapes, shapes = _param_shapes(arch)
    ref_mesh, mesh = _meshes(shape)
    for fsdp in ("data", None):
        want = jsh.param_pspecs(ref_shapes, ref_mesh, fsdp=fsdp)
        got = sh.param_pspecs(shapes, mesh, fsdp=fsdp)
        assert _port_flat(got) == _ref_flat(want)
    got_opt = sh.opt_state_pspecs(got, mesh)
    want_opt = jsh.opt_state_pspecs(want, ref_mesh)
    assert _port_flat(got_opt) == _ref_flat(want_opt)
    assert set(got_opt) == set(want_opt)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch, shape):
    ref_mesh, mesh = _meshes(shape)
    dp = pmesh.dp_axes(mesh)
    assert dp == jmesh.dp_axes(ref_mesh)
    for batch in CACHE_BATCHES:
        ref_shapes, shapes = _cache_shapes(arch, batch)
        got = sh.cache_pspecs(shapes, mesh, batch, dp)
        want = jsh.cache_pspecs(ref_shapes, ref_mesh, batch, dp)
        assert _port_flat(got) == _ref_flat(want), batch


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_batch_pspec_and_mesh_sizes_match_reference(shape):
    ref_mesh, mesh = _meshes(shape)
    assert pmesh.dp_axes(mesh) == jmesh.dp_axes(ref_mesh)
    assert pmesh.dp_size(mesh) == jmesh.dp_size(ref_mesh)
    assert pmesh.tp_size(mesh) == jmesh.tp_size(ref_mesh)
    for dp in (pmesh.dp_axes(mesh), ("data",), ("pod", "data"), ()):
        for batch in (1, 2, 3, 4, 8, 16, 32, 64, 256, 512):
            assert _norm(sh.batch_pspec(batch, mesh, dp)) == \
                _norm(jsh.batch_pspec(batch, ref_mesh, dp)), (dp, batch)


def test_fit_replicates_a_dim_that_does_not_divide():
    """The reference test's 25 heads over 16-way TP."""
    ref_mesh = types.SimpleNamespace(
        axis_names=("data", "model"),
        devices=types.SimpleNamespace(shape=(2, 16)))
    mesh = pmesh.Mesh(np.full((2, 16), CPU, dtype=object),
                      ("data", "model"))
    got = sh._fit((25, 64), (sh.T, sh.F), mesh, "data", "model")
    assert got == sh.P(None, "data")
    assert _norm(got) == _norm(jsh._fit((25, 64), (jsh.T, jsh.F), ref_mesh,
                                        "data", "model"))


def test_make_mesh_counts_devices(monkeypatch):
    mesh = pmesh.make_mesh((1, 1), ("data", "model"), devices=[CPU])
    assert mesh.devices.shape == (1, 1) and mesh.device == CPU
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 256 devices, 1"):
        pmesh.make_mesh((16, 16), ("data", "model"), devices=[CPU])
    monkeypatch.setattr(pmesh, "cuda_devices", lambda: [CPU] * 512)
    pod = pmesh.make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model")
    assert pod.devices.shape == (2, 16, 16)
    assert pod.first_device == CPU
    with pytest.raises(ValueError, match="has no one device"):
        pod.device


def _leaves(tree) -> list:
    out = []
    sh._map_with_path(lambda path, x: out.append(x), tree)
    return out


def test_to_named_places_whole_tensors_on_one_device():
    """On a mesh of one device placement keeps every tensor it was given
    (they already live there).  On a mesh of 2 x 4 logical devices every
    leaf is a ``ShardedTensor`` whose blocks are contiguous tensors of
    their own at the spec's shard shape, one per distinct block, and
    assemble to the source."""
    from repro_torch.configs import get_smoke_config
    params = lm.init_params(get_smoke_config("llama3-8b"), seed=0,
                            device="cpu")
    _, mesh = _meshes((1, 1))
    for kind in (None, "pinned_host"):
        placed = sh.to_named(params, sh.param_pspecs(params, mesh), mesh,
                             memory_kind=kind)
        a, b = _leaves(params), _leaves(placed)
        assert len(a) == len(b) and all(x is y for x, y in zip(a, b))
    big = pmesh.make_mesh((2, 4), ("data", "model"), devices=[CPU] * 8)
    specs = sh.param_pspecs(params, big)
    placed = sh.to_named(params, specs, big)
    base = {t.untyped_storage().data_ptr() for t in _leaves(params)}
    for src, st, spec in zip(_leaves(params), _leaves(placed),
                             _leaves(specs)):
        assert isinstance(st, sh.ShardedTensor) and st.spec == spec
        parts = [st.parts(d) for d in range(st.ndim)]
        want = tuple(n // p for n, p in zip(src.shape, parts))
        assert st.shard_shapes() == [want] * 8
        locs = sh.local_tensors(st)
        assert len(locs) == math.prod(parts)
        assert all(t.is_contiguous() for t in locs)
        if len(locs) > 1:
            assert not {t.untyped_storage().data_ptr() for t in locs} & base
        assert torch.equal(st.full(), src)


def test_constrain_is_the_identity_where_nothing_splits():
    x = torch.zeros(8, 6, 4)
    assert not psharding.active()
    assert psharding.constrain(x, "dp", None, "tp") is x
    _, one = _meshes((1, 1))
    with psharding.use_mesh(one, dp=("data",), tp="model"):
        assert psharding.active()
        assert psharding.constrain(x, "dp", None, "tp") is x
    _, mesh = _meshes((2, 4))
    with psharding.use_mesh(mesh, dp=("data",), tp="model"):
        # 6 over 4-way TP does not divide: replicated, nothing splits
        assert psharding.constrain(x, None, "tp") is x
        y = torch.zeros(3, 5)
        assert psharding.constrain(y, "dp", "tp") is y
        # splits over 2 x 4 devices: a constraint changes no value
        assert psharding.constrain(x, "dp", None, "tp") is x
    assert not psharding.active()
