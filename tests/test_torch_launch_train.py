"""The port's training launcher and what it stands on, against the JAX
reference on the CPU: ``TieredArray.move_block`` / ``prefetch_blocks``,
``TieredStateStore`` on equal ledgers, ``init_state_shapes``, the
checkpoint store (the reference's scenarios, and checkpoints crossing
between the packages bit-exactly), and ``launch.train``: the
reference's adaptive scenarios, replan parity on the reference's tiers,
resume after restore, and the one-device mesh."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from _torch_parity import (assert_same, normal, package,  # noqa: E402
                           to_torch, tree_to_torch)

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import tiered_array as jta  # noqa: E402
from repro.core import tpu_v5e_tiers  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.core import TieredArray  # noqa: E402
from repro_torch.core.tiers import MemoryTier  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _bits(t):
    """A tensor's or array's raw bytes, for bit-exact comparison."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    a = np.asarray(t)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


# ===================================================================== #
# TieredArray.move_block / prefetch_blocks                              #
# ===================================================================== #
SHARES = [("device", 0.5), ("pinned_host", 0.25), ("unpinned_host", 0.25)]


def test_move_block_matches_reference():
    x = normal(np.random.RandomState(0), (10, 3))
    ref = jta.TieredArray.place(jnp.asarray(x), SHARES, block_rows=4)
    mine = TieredArray.place(torch.from_numpy(x), SHARES, block_rows=4,
                             device="cpu")
    assert mine.kinds == ref.kinds
    for i, kind in ((0, "pinned_host"), (0, "pinned_host"),
                    (2, "device"), (1, "unpinned_host")):
        assert mine.move_block(i, kind) == ref.move_block(i, kind)
        assert mine.kinds == ref.kinds
        for k in ("device", "pinned_host", "unpinned_host"):
            assert mine.bytes_on(k) == ref.bytes_on(k)
    np.testing.assert_array_equal(mine.gather().numpy(), x)


def test_prefetch_blocks_yields_each_block_in_order():
    x = normal(np.random.RandomState(1), (9, 2))
    mine = TieredArray.place(torch.from_numpy(x), SHARES, block_rows=2,
                             device="cpu")
    ref = jta.TieredArray.place(jnp.asarray(x), SHARES, block_rows=2)
    got = list(mine.prefetch_blocks())
    want = list(ref.prefetch_blocks())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(torch.cat(got).numpy(), x)


# ===================================================================== #
# TieredStateStore                                                      #
# ===================================================================== #
def _tpu_tiers(pkg):
    t = tpu_v5e_tiers()
    if pkg.root == "repro":
        return {k: t[k] for k in ("HBM", "HOST")}
    return {k: MemoryTier(**dataclasses.asdict(t[k])) for k in ("HBM", "HOST")}


def _state_tree(seed, as_tensor):
    rs = np.random.RandomState(seed)
    return {"master": {"w": as_tensor(normal(rs, (10, 4))),
                       "b": as_tensor(normal(rs, (7,))),
                       "s": as_tensor(normal(rs, ()))},
            "m": (as_tensor(normal(rs, (3, 5, 2))),
                  as_tensor(normal(rs, (6, 1))))}


def _store_scenario(pkg, as_tensor, **kw):
    """put, a sub-block move (rounds up to its first block), a
    whole-block move, a move refused by the budget, a budget shrink and
    ``demote_over_budget``, ``update``: what the store and its ledger
    observed."""
    led = pkg.pool_ledger.ResidencyLedger(_tpu_tiers(pkg))
    st = pkg.pool_state_store.TieredStateStore(led, "train", block_rows=4,
                                               **kw)
    seen = []
    st.put("opt", _state_tree(0, as_tensor), [("HOST", 1.0)])
    seen.append((led.placement("train", "opt"), st.nbytes("opt")))
    seen.append(st.move_fn("opt", "HOST", "HBM", 10))
    seen.append(st.move_fn("opt", "HOST", "HBM", 100))
    seen.append(st.move_fn("opt", "HBM", "HBM", 100))
    led.set_budget("train", "HBM", led.placement("train", "opt")["HBM"]
                   + 40)
    seen.append(st.move_fn("opt", "HOST", "HBM", 10 ** 6))
    seen.append((led.placement("train", "opt"), st.shares("opt")))
    led.set_budget("train", "HBM", 50)
    seen.append(st.demote_over_budget("HBM", "HOST"))
    seen.append((led.placement("train", "opt"), st.bytes_on("opt", "HBM"),
                 st.bytes_on("opt", "HOST")))
    st.update("opt", _state_tree(1, as_tensor))
    seen.append(led.placement("train", "opt"))
    seen.append(vars(led.counters))
    return seen, st


STORE_MODULES = ("pool.ledger", "pool.state_store")


def test_state_store_matches_reference():
    want, _ = _store_scenario(package("repro", *STORE_MODULES), jnp.asarray)
    got, st = _store_scenario(package("repro_torch", *STORE_MODULES),
                              to_torch, device="cpu")
    assert_same(got, want)
    # the values survive the moves and hold the update
    back = st.gather("opt")
    fresh = _state_tree(1, to_torch)
    for g, w in zip(pytree.tree_leaves(back), pytree.tree_leaves(fresh)):
        np.testing.assert_array_equal(g.reshape(w.shape).numpy(), w.numpy())
    # every block's kind follows its tier label
    for ta, labels in st.leaves("opt"):
        assert ta.kinds == [{"HBM": "device", "HOST": "pinned_host"}[t]
                            for t in labels]


def test_state_store_maps_kind_named_tiers_to_themselves():
    """A testbed whose tiers are named by their kinds (h100-node's)."""
    from repro_torch.pool import ResidencyLedger, TieredStateStore
    st = TieredStateStore(ResidencyLedger(), "t", device="cpu")
    st.put("o", {"a": torch.ones(4)}, [("unpinned_host", 1.0)])
    assert st.move_fn("o", "unpinned_host", "pinned_host", 16) == 16
    (ta, labels), = st.leaves("o")
    assert ta.kinds == labels == ["pinned_host"]


# ===================================================================== #
# init_state_shapes                                                     #
# ===================================================================== #
@pytest.mark.parametrize("compress", [False, True])
def test_init_state_shapes_matches_reference(compress):
    jcfg = jsmoke("llama3-8b")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    want = jadam.init_state_shapes(jax.eval_shape(lambda: jparams),
                                   jadam.AdamConfig(compress_grads=compress))
    params = tree_to_torch(jparams)
    got = adam.init_state_shapes(params,
                                 adam.AdamConfig(compress_grads=compress))
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = sorted(pytree.tree_flatten_with_path(got)[0],
                key=lambda pl: tuple(getattr(p, "key", getattr(p, "idx", p))
                                     for p in pl[0]))
    assert len(gl) == len(wl)
    for (gp, g), (wp, w) in zip(gl, wl):
        assert jstore._leaf_key(wp) == "/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in gp)
        assert tuple(g.shape) == tuple(w.shape)
        assert g.device.type == "meta"
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


# ===================================================================== #
# checkpoint store: the reference's scenarios on the port               #
# ===================================================================== #
def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 4, generator=g),
                       "b": torch.arange(4.0)},
            "opt": {"m": torch.zeros(8, 4),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    st = _state()
    save(tmp_path, 100, st, metadata={"data_step": 100})
    got, meta = restore(tmp_path, _state(seed=1))
    assert meta["data_step"] == 100
    assert torch.equal(got["params"]["w"], st["params"]["w"])
    assert int(got["opt"]["step"]) == 7
    assert got["opt"]["step"].dtype == torch.int32


def test_checkpoint_latest_and_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save(tmp_path, s, _state(s), keep_last=3)
    assert latest_step(tmp_path) == 5
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert len(kept) == 3 and kept[0].endswith("00000003")


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    save(tmp_path, 1, _state())
    # a crashed writer leaves a .tmp dir: restore must ignore it
    (Path(tmp_path) / "step_00000002.tmp").mkdir()
    assert latest_step(tmp_path) == 1
    got, _ = restore(tmp_path, _state(9))
    assert got is not None


def test_checkpoint_checksum_detects_corruption(tmp_path):
    d = save(tmp_path, 3, _state())
    manifest = json.loads((d / "manifest.json").read_text())
    fn = manifest["leaves"]["params/w"]["file"]
    arr = np.load(d / fn)
    arr[0, 0] += 1.0
    np.save(d / fn, arr)
    with pytest.raises(IOError, match="checksum"):
        restore(tmp_path, _state(1))


def test_checkpoint_elastic_restore_onto_memory_kinds(tmp_path):
    """Restore onto a memory kind per leaf (the port's elastic path; on
    a CPU engine the kinds are logical CPU memory), into ``meta``
    targets."""
    st = _state()
    save(tmp_path, 1, st)
    target = pytree.tree_map(lambda t: t.to("meta"), _state(1))
    kinds = {"params": {"w": "pinned_host", "b": "unpinned_host"},
             "opt": {"m": "device", "step": None}}
    got, _ = restore(tmp_path, target, placement=kinds, device="cpu")
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(st)):
        assert g.device.type == "cpu"
        assert torch.equal(g, w)
    got, _ = restore(tmp_path, target, placement="pinned_host",
                     device="cpu")
    assert torch.equal(got["params"]["w"], st["params"]["w"])


def test_checkpoint_missing_leaf_rejected(tmp_path):
    save(tmp_path, 1, {"a": torch.ones(3)})
    with pytest.raises(KeyError):
        restore(tmp_path, {"b": torch.ones(3)})


# ===================================================================== #
# checkpoints cross between the packages                                #
# ===================================================================== #
@pytest.fixture(scope="module")
def model_state():
    """A smoke llama3-8b train state (bf16 params, fp32 Adam state, an
    int32 step) in each package, equal bit for bit."""
    jcfg = jsmoke("llama3-8b")
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = jadam.init_state(jparams, jadam.AdamConfig())
    jopt["step"] = jnp.int32(11)
    jst = {"params": jparams, "opt": jopt}
    return jst, tree_to_torch(jst)


def _assert_trees_bit_equal(got_flat, want_flat):
    assert len(got_flat) == len(want_flat)
    for (gp, g), (wp, w) in zip(got_flat, want_flat):
        assert gp == wp
        assert tuple(g.shape) == tuple(np.shape(w)), gp
        assert _bits(g) == _bits(w), gp


def _flat_port(tree):
    flat = pytree.tree_flatten_with_path(tree)[0]
    return sorted(("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                            for p in path), leaf) for path, leaf in flat)


def _flat_ref(tree):
    return sorted((jstore._leaf_key(p), np.asarray(leaf))
                  for p, leaf in jax.tree_util.tree_leaves_with_path(tree))


def test_reference_checkpoint_restores_in_port(model_state, tmp_path):
    jst, st = model_state
    jstore.save(tmp_path, 4, jst, metadata={"step": 4})
    target = pytree.tree_map(lambda t: t.to("meta"), st)
    got, meta = restore(tmp_path, target, device="cpu")
    assert meta == {"step": 4}
    assert got["params"]["embed"].dtype == torch.bfloat16
    _assert_trees_bit_equal(_flat_port(got), _flat_ref(jst))


def test_port_checkpoint_restores_in_reference(model_state, tmp_path):
    jst, st = model_state
    save(tmp_path, 4, st, metadata={"step": 4})
    manifest = json.loads((tmp_path / "step_00000004" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["params/embed"]["dtype"] == "bfloat16"
    got, meta = jstore.restore(tmp_path, jst)
    assert meta == {"step": 4}
    assert got["params"]["embed"].dtype == jnp.bfloat16
    _assert_trees_bit_equal(_flat_ref(got), _flat_ref(jst))


def test_checkpoint_manifests_agree(model_state, tmp_path):
    """Both packages number, key, shape, type and checksum the leaves
    alike (the tree description is each framework's own)."""
    jst, st = model_state
    jstore.save(tmp_path / "ref", 1, jst)
    save(tmp_path / "port", 1, st)
    want, got = (json.loads((tmp_path / w / "step_00000001" /
                             "manifest.json").read_text())
                 for w in ("ref", "port"))
    assert got["leaves"] == want["leaves"]


# ===================================================================== #
# launch.train                                                          #
# ===================================================================== #
def _tpu_train_tiers(device):
    """The reference's default planning tiers (HBM and HOST of its TPU
    tier set) as the port's MemoryTier: a parity input only."""
    t = tpu_v5e_tiers()
    return {k: MemoryTier(**dataclasses.asdict(t[k])) for k in ("HBM", "HOST")}


@pytest.fixture
def tpu_tiers(monkeypatch):
    monkeypatch.setattr(train, "probed_train_tiers", _tpu_train_tiers)


ADAPTIVE = ["--arch", "llama3-8b", "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "32", "--adaptive", "--replan-every", "2"]


def _replans(telem):
    return [(d.epoch, d.applied, d.reason, d.moved_bytes, d.denied_bytes)
            for d in telem.replanner.decisions]


def test_train_adaptive_migrates_opt_state_into_ledger(tpu_tiers, capsys):
    """The reference's scenario on the port, and its decisions against
    the reference launcher's on the same tiers and argv."""
    telem = train.main(ADAPTIVE + ["--device", "cpu"])
    assert telem is not None
    led = telem.ledger
    assert led.counters.migrated_bytes > 0
    assert telem.replanner.replans_applied >= 1
    fast_bytes = telem.opt_bytes_on(telem.fast)
    assert fast_bytes > 0
    place = led.placement(telem.tenant, telem.OPT_OBJ)
    assert sum(place.values()) == telem.store.nbytes(telem.OPT_OBJ)
    plan_fast = telem.replanner.plan.fraction_on(telem.OPT_OBJ,
                                                 telem.fast)
    got_fast = fast_bytes / telem.store.nbytes(telem.OPT_OBJ)
    assert got_fast == pytest.approx(plan_fast, abs=0.05)
    assert telem.store.bytes_on(telem.OPT_OBJ, telem.fast) == fast_bytes
    out = capsys.readouterr().out
    assert "opt_state moved=" in out
    ref = jtrain.main(ADAPTIVE)
    assert telem.replanner.replans_applied == ref.replanner.replans_applied
    assert led.counters.migrated_bytes == ref.ledger.counters.migrated_bytes
    assert place == ref.ledger.placement(ref.tenant, ref.OPT_OBJ)
    assert _replans(telem) == _replans(ref)


def test_train_without_adaptive_returns_no_telemetry():
    telem = train.main(["--arch", "llama3-8b", "--smoke", "--steps", "1",
                        "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert telem is None


@pytest.mark.parametrize("flags", [
    ["--replan-every", "4"],
    ["--sample-rate", "0.5"],
    ["--topology", "vendor-a"],
    ["--tenant", "team-a"],
    ["--trace-out", "t.jsonl"],
    ["--predictive"],
    ["--calibrate"],
])
def test_train_adaptive_knobs_require_adaptive(flags):
    with pytest.raises(SystemExit):
        train.main(["--arch", "llama3-8b", "--smoke", "--steps", "1",
                    "--device", "cpu"] + flags)


def test_train_adaptive_artifacts_topology_and_calibration(tmp_path,
                                                           capsys):
    """The engine's control planes under the launcher: a paper testbed,
    calibration and prediction, with the three artifacts written."""
    telem = train.main(ADAPTIVE + [
        "--device", "cpu", "--topology", "vendor-a", "--calibrate",
        "--predictive", "--trace-out", str(tmp_path / "t.jsonl"),
        "--metrics-out", str(tmp_path / "m.prom"),
        "--audit-out", str(tmp_path / "a.json")])
    out = capsys.readouterr().out
    assert "testbed vendor-a" in out and "opt_state moved=" in out
    assert telem.fast == "LDRAM" and telem.calibrator is not None
    assert (tmp_path / "t.jsonl").read_text().strip()
    assert "train_replan" in (tmp_path / "m.prom").read_text()
    assert "calibration" in json.loads((tmp_path / "a.json").read_text())


def test_train_h100_node_topology_gets_capacities():
    """h100-node's probed tiers carry no capacities; the launcher gives
    them the device's and the host's memory."""
    telem = train.main(ADAPTIVE[:-2] + ["--replan-every", "3", "--device",
                                        "cpu", "--topology", "h100-node"])
    assert telem.fast == "device"
    assert all(t.capacity_GiB > 0 for t in telem.replanner.tiers.values())


def test_resume_after_restore_equals_uninterrupted_run(tmp_path):
    base = ["--arch", "llama3-8b", "--smoke", "--batch", "2", "--seq", "32",
            "--device", "cpu", "--ckpt-every", "2"]
    a = train.run(train.parse_args(base + ["--steps", "4", "--ckpt-dir",
                                           str(tmp_path / "ab")]))
    assert sorted(a.losses) == [0, 1, 2, 3]
    assert latest_step(tmp_path / "ab") == 4
    b = train.run(train.parse_args(base + ["--steps", "6", "--ckpt-dir",
                                           str(tmp_path / "ab")]))
    assert b.start == 4 and sorted(b.losses) == [4, 5]
    c = train.run(train.parse_args(base + ["--steps", "6", "--ckpt-dir",
                                           str(tmp_path / "c")]))
    assert [b.losses[i] for i in (4, 5)] == [c.losses[i] for i in (4, 5)]
    assert [a.losses[i] for i in range(4)] == [c.losses[i] for i in range(4)]
    for g, w in zip(pytree.tree_leaves(b.params),
                    pytree.tree_leaves(c.params)):
        assert torch.equal(g, w)
    assert int(b.opt["step"]) == int(c.opt["step"]) == 6


def test_cli_prints_restored_step(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3-8b", "--smoke", "--batch", "2", "--seq", "16", "--device",
           "cpu", "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(cmd + ["--steps", "2"], capture_output=True,
                           text=True, env=env, timeout=300)
    assert first.returncode == 0, first.stderr
    second = subprocess.run(cmd + ["--steps", "3"], capture_output=True,
                            text=True, env=env, timeout=300)
    assert second.returncode == 0, second.stderr
    assert "restored step 2" in second.stdout
    assert "step    2 loss=" in second.stdout and "done" in second.stdout


@pytest.mark.parametrize("spec,ok", [("1", True), ("1x1", True),
                                     ("1x1x1", True), ("2", False),
                                     ("1x4", False), ("2x16x16", False)])
def test_mesh_of_more_than_one_device_names_item_9(spec, ok):
    """``--mesh`` builds a mesh over the CPU's one device, as the
    reference's builds one over its devices: without a list of devices
    a mesh of more entries raises, naming the ROADMAP item that runs
    over several physical devices (queue 1, item 11c; item 9 ported the
    mesh).  Over ``devices`` (logical: the CPU named n times) every
    mesh builds, and the launcher trains on the small ones."""
    dims = tuple(int(d) for d in spec.split("x"))
    n = math.prod(dims)
    cpu = torch.device("cpu")
    if ok:
        mesh = train.parse_mesh(spec, "cpu")
        assert mesh.devices.shape == dims
        assert list(mesh.devices.flat) == [cpu]
        return
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 11c "):
        train.parse_mesh(spec, "cpu")
    with pytest.raises(ValueError, match="item 11c "):
        train.main(["--arch", "llama3-8b", "--smoke", "--steps", "1",
                    "--device", "cpu", "--mesh", spec])
    mesh = train.parse_mesh(spec, "cpu", devices=[cpu] * n)
    assert mesh.devices.shape == dims and mesh.physical_devices == [cpu]
    if n > 8:
        return
    args = ["--arch", "llama3-8b", "--smoke", "--steps", "2", "--batch",
            "4", "--seq", "32", "--device", "cpu"]
    one = train.run(train.parse_args(args))
    split = train.run(train.parse_args(args + ["--mesh", spec]),
                      devices=[cpu] * n)
    assert split.losses[0] == pytest.approx(one.losses[0], abs=1e-5)
    assert split.losses[1] == pytest.approx(one.losses[1], abs=1e-3)
