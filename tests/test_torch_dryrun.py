"""The port's cells and dry-run against the JAX reference's, on the CPU:
``configs.registry.assigned_cells``, ``launch.specs.build_cell`` at a
1x1 mesh for every assigned (arch x shape) cell (argument shapes and
dtypes, partition specs, step name, donated arguments), a small train
cell run from the reference's weights, and ``launch.dryrun`` over smoke
configs at a 1x1 and a placeholder 2x4 mesh, writing to a temporary
directory."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from _torch_parity import tree_to_torch  # noqa: E402

import repro.launch.specs as JSP  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import shardings as jsh  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.configs import ARCH_IDS, ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import jaxpr_cost as JC  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import shardings as sh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CELLS = [(a, s) for a in ASSIGNED_ARCHS for s in registry.assigned_cells(a)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_assigned_cells_match_reference(arch):
    assert registry.assigned_cells(arch) == jreg.assigned_cells(arch)


def _norm(spec):
    """A spec as a tuple, a one-name tuple as the name and an empty one
    as None (newer jax normalizes them so)."""
    return tuple((ax[0] if ax else None) if isinstance(ax, tuple)
                 and len(ax) <= 1 else ax for ax in spec)


def _ref_leaves(args):
    flat, _ = jax.tree_util.tree_flatten_with_path(args)
    return {"/".join(jsh._path_keys(p)): (tuple(x.shape), str(x.dtype),
                                         _norm(x.sharding.spec))
            for p, x in flat}


def _port_leaves(args, spec_trees):
    out = {}

    def one(path, x, spec):
        if hasattr(x, "shape"):
            out["/".join(path)] = (tuple(x.shape),
                                   str(x.dtype).replace("torch.", ""),
                                   _norm(spec))
    for i, (a, s) in enumerate(zip(args, spec_trees)):
        sh._map_with_path(one, a, s, path=(str(i),))
    return out


@pytest.fixture(scope="module")
def meshes():
    return (jmesh.make_mesh((1, 1), ("data", "model")),
            pmesh.make_mesh((1, 1), ("data", "model"), devices=[CPU]))


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_build_cell_matches_reference(arch, shape, meshes):
    jm, m = meshes
    want = JSP.build_cell(arch, shape, jm)
    got = specs.build_cell(arch, shape, m)
    assert got.step_name == want.step_name
    assert got.donate_argnums == want.donate_argnums
    assert dataclasses.astuple(got.shape) == dataclasses.astuple(want.shape)
    w, g = _ref_leaves(want.args), _port_leaves(got.args, got.specs)
    # the port's cache index is an int (the step it decodes), the
    # reference's a traced int32
    w = {k: v for k, v in w.items() if not k.endswith("/index")}
    assert g == w
    if got.step_name == "serve_step":
        assert got.args[1]["index"] == got.shape.seq_len
        assert got.out_specs[1] == got.specs[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_cell_cache_layout_is_prefills(arch):
    """The prefill cell pins its cache's specs from the decode cache's
    layout over S positions; that is the layout prefill returns."""
    cfg = get_smoke_config(arch)
    B, S = 2, 32
    with torch._subclasses.fake_tensor.FakeTensorMode():
        p = lm.init_params(cfg, device="cpu")
        frames = (torch.empty(B, cfg.n_frontend_tokens, cfg.d_model)
                  if cfg.n_frontend_tokens else None)
        _, got = lm.prefill(p, cfg, torch.zeros(B, S, dtype=torch.int32),
                            frames)
        want = lm.make_decode_cache(cfg, B, S,
                                    enc_len=cfg.n_frontend_tokens,
                                    device="cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in got.items()
            if k != "index"} == {k: (tuple(t.shape), t.dtype)
                                 for k, t in want.items() if k != "index"}


TINY = {"train_4k": (64, 2, "train"), "prefill_32k": (64, 2, "prefill"),
        "decode_32k": (64, 2, "decode")}


def _tiny_shapes(module):
    return dict(module.SHAPES, **{name: module.ShapeConfig(name, *v)
                                  for name, v in TINY.items()})


def test_smoke_train_cell_loss_matches_reference(meshes, monkeypatch):
    """The stablelm-1.6b smoke train cell (vocab 128, 2 x 64), run on
    the CPU from the reference's weights."""
    jm, m = meshes
    monkeypatch.setattr(JSP, "SHAPES", _tiny_shapes(jbase))
    monkeypatch.setattr(specs, "SHAPES", _tiny_shapes(specs))
    jcfg = dataclasses.replace(jsmoke("stablelm-1.6b"), vocab=128)
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), vocab=128)
    jcell = JSP.build_cell("stablelm-1.6b", "train_4k", jm,
                           cfg_override=jcfg)
    cell = specs.build_cell("stablelm-1.6b", "train_4k", m,
                            cfg_override=cfg)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    weights = tree_to_torch(params)
    rs = np.random.RandomState(0)
    toks = rs.randint(0, 128, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with jm:
        want = float(jcell.jit()(params, jadam.init_state(
            params, jadam.AdamConfig()), batch)[2])
    p, opt, _ = cell.materialize("cpu", params=weights)
    got = cell.fn(p, opt, {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in batch.items()})
    assert np.isfinite(want)
    assert float(got[2]) == pytest.approx(want, rel=2e-3)
    # a step of the cell's shapes ran: new params and state of the same
    # layout
    assert _port_leaves((got[0],), (cell.specs[0],)) == \
        _port_leaves((p,), (cell.specs[0],))


def test_materialize_gives_runnable_cells(meshes, monkeypatch):
    _, m = meshes
    monkeypatch.setattr(specs, "SHAPES", _tiny_shapes(specs))
    monkeypatch.setattr(specs, "get_config", get_smoke_config)
    for shape in TINY:
        cell = specs.build_cell("whisper-large-v3", shape, m)
        args = cell.materialize("cpu")
        out = cell.fn(*args)
        fake = _port_leaves(cell.args, cell.specs)
        real = _port_leaves(args, cell.specs)
        assert real == fake, shape
        logits = out[2] if shape == "train_4k" else out[0]
        assert torch.isfinite(logits).all(), shape


# ---------------------------------------------------------------------- #
# the dry-run                                                             #
# ---------------------------------------------------------------------- #
MESHES = {"1x1": (1, 1), "2x4": (2, 4)}
KEYS = {"arch", "shape", "mesh", "n_chips", "step", "status", "trace_s",
        "graph_nodes", "device_model", "memory_analysis",
        "memory_structural", "cost_analysis_raw", "jaxpr_cost_global",
        "jaxpr_cost_by_rule", "jaxpr_cost_vmem_fused",
        "roofline_vmem_fused", "collectives", "roofline"}


@pytest.fixture
def tiny_dryrun(monkeypatch, tmp_path):
    """The dry-run over smoke configs at tiny shapes, its artifacts in
    ``tmp_path``, on a mesh of ``MESHES[name]`` over placeholders."""
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    monkeypatch.setattr(specs, "get_config", get_smoke_config)
    monkeypatch.setattr(specs, "SHAPES", _tiny_shapes(specs))

    def use(name):
        monkeypatch.setattr(
            dryrun, "make_production_mesh",
            lambda *, multi_pod, devices: pmesh.make_mesh(
                MESHES[name], ("data", "model"), devices))
    return use


def _leaf_bytes(cell, per_device):
    total = 0

    def one(path, x, spec):
        nonlocal total
        if hasattr(x, "shape"):
            total += x.numel() * x.element_size() // per_device(spec)
    for a, s in zip(cell.args, cell.specs):
        sh._map_with_path(one, a, s)
    return total


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", TINY)
def test_run_cell_artifact(tiny_dryrun, tmp_path, mesh, shape):
    tiny_dryrun(mesh)
    res = dryrun.run_cell("llama3-8b", shape, False, verbose=False)
    path = tmp_path / f"llama3-8b__{shape}__singlepod.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    assert set(res) == KEYS and res["status"] == "ok"
    n = int(np.prod(MESHES[mesh]))
    assert res["n_chips"] == n
    for key in ("memory_analysis", "cost_analysis_raw", "collectives"):
        assert set(res[key]) == {"reason"} and res[key]["reason"]
    st = res["memory_structural"]
    assert set(st["saved_stacks"]) == {"reason"}
    # structural bytes by hand: each leaf over the devices its spec
    # splits it over
    pm = pmesh.make_mesh(MESHES[mesh], ("data", "model"),
                         pmesh.placeholder_devices(n))
    cell = specs.build_cell("llama3-8b", shape, pm)
    want = _leaf_bytes(cell, lambda s: sh._spec_devices(s, pm))
    assert st["argument_bytes_per_dev"] == want
    assert st["structural_total_per_dev"] == want
    if n == 1:
        assert want == _leaf_bytes(cell, lambda s: 1)
    else:
        assert want < _leaf_bytes(cell, lambda s: 1)
    cost = JC.step_cost(cell.fn, *cell.args)
    assert res["jaxpr_cost_global"] == cost
    assert res["jaxpr_cost_vmem_fused"]["flops"] == cost["flops"]
    assert res["jaxpr_cost_vmem_fused"]["bytes"] <= cost["bytes"]
    roof = res["roofline"]
    assert roof["compute_s"] == pytest.approx(
        cost["flops"] / (n * H.PEAK_FLOPS_BF16))
    assert roof["memory_s"] == pytest.approx(cost["bytes"] / (n * H.HBM_BW))
    assert roof["collective_s"] == 0.0 and roof["n_chips"] == n
    assert res["device_model"]["hbm_bw"] == H.HBM_BW == 3.35e12
    assert res["device_model"]["fused_budget_bytes"] == H.L2_BYTES


def test_main_writes_each_mesh_and_reports_failures(tiny_dryrun, tmp_path,
                                                    monkeypatch, capsys):
    tiny_dryrun("2x4")
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                        "--both-meshes"]) == 0
    for tag in ("singlepod", "multipod"):
        res = json.loads((tmp_path / f"stablelm-1.6b__decode_32k__{tag}"
                          ".json").read_text())
        assert res["status"] == "ok" and res["mesh"] == tag
    assert "dry-run complete: 2/2 OK" in capsys.readouterr().out

    def broken(*a, **kw):
        raise ValueError("no such cell")
    monkeypatch.setattr(dryrun, "build_cell", broken)
    assert dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k"]) == 1
    res = json.loads((tmp_path / "rwkv6-7b__long_500k__singlepod.json")
                     .read_text())
    assert res["status"] == "failed" and "no such cell" in res["error"]


def test_production_meshes_over_placeholders():
    for multi_pod, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        m = pmesh.make_production_mesh(
            multi_pod=multi_pod, devices=pmesh.placeholder_devices(512))
        assert m.devices.shape == shape
        assert {d.type for d in m.devices.flat} == {"meta"}
    assert dryrun.ART_DIR == ROOT / "experiments" / "dryrun_torch"


def test_import_sets_no_environment():
    code = ("import os; before = dict(os.environ); "
            "import repro_torch.launch.dryrun; "
            "assert dict(os.environ) == before")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
