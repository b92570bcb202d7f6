"""Training under FSDP x TP meshes: the port's launcher over *logical* CPU
devices (a mesh that names the CPU several times) against the JAX
reference's under forced host devices, on smoke models.

(a) shard shapes: each leaf of the params and of the AdamW state at
2x2, 2x4, 4x2 and 2x2x2 on five archs, against the reference's
addressable shards; (b) losses: ``launch.train.run`` at 2x2, 2x4 and
2x2x2 from the reference's initial params, held to the reference's run
at the same mesh: step 0 within ``LOSS_ATOL``, later steps within the
reference's own spread between its 1x1 and mesh runs (measured here)
plus ``LOSS_ATOL``, the masters after step 1 by
``test_train_step_matches_reference``'s rule; the port's mesh runs
against its own 1x1 run to the same limits; (c) ``fused_adam`` once per
distinct block, equal to the plain update; (d) elastic checkpoints,
bit-exact, within the port (2x4 -> 4x2, 1x1) and across the packages in
both directions; (e) planted faults (a per-shard MoE aux, MoE groups
from the local token count, a dropped data shard, the global norm
counting a replicated leaf once per device), each of which must read
outside its limit; (f) ``--adaptive`` on a split mesh: the port raises,
the reference fails in ``pool/state_store.py``.

The reference's side runs in subprocesses (``XLA_FLAGS`` must be set
before JAX starts): this file run as a script,

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src:tests python tests/test_torch_sharded_train.py \\
        mesh8 OUT_DIR PORT_CKPT_DIR

runs one job of ``JOBS`` (its meshes' runs from the reference's initial
params in ``OUT_DIR/init_<arch>.pkl``, which the fixture writes, each
run's masters after step 1 written there too) and prints its readings
as one JSON object.
"""
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
# name -> (arch, --compress-grads)
VARIANTS = {
    "llama3-8b": ("llama3-8b", False),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", False),
    "gpt2-xl-offload": ("gpt2-xl-offload", False),
    "gpt2-xl-offload+compress": ("gpt2-xl-offload", True),
    "rwkv6-7b": ("rwkv6-7b", False),
}
MESHES = ("2x2", "2x4", "2x2x2")
SHAPE_ARCHS = ("llama3-8b", "qwen3-moe-30b-a3b", "gpt2-xl-offload",
               "rwkv6-7b", "jamba-1.5-large-398b")
SHAPE_MESHES = ("2x2", "2x4", "4x2", "2x2x2")
# batch 8 x 64, three steps, the launcher's default lr
STEPS, BATCH, SEQ, LR = 3, 8, 64, 3e-3
CKPT_ARCH, CKPT_AT = "llama3-8b", 2
# job -> (forced host devices, meshes run, shard-shape meshes); the four
# run at once, each within JOB_TIMEOUT_S
JOBS = {"mesh1": (4, ("1x1",), ()),
        "mesh4": (4, ("2x2",), ("2x2",)),
        "mesh8": (8, ("2x4",), ()),
        "mesh8b": (8, ("2x2x2",), ("2x4", "4x2", "2x2x2"))}
JOB_TIMEOUT_S = 600
LOSS_ATOL = 2e-4        # test_torch_train.LOSS_ATOL
CPU = torch.device("cpu")


def _n(spec: str) -> int:
    return math.prod(int(d) for d in spec.split("x"))


def _key(path) -> str:
    """A tree path of either package as 'a/b/0/c'."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


# ===================================================================== #
# the reference's side (this file run as a script)                     #
# ===================================================================== #
def _ref_init(arch: str):
    """The reference's initial params of ``arch``'s smoke model, as
    numpy arrays."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models import lm
    return jax.tree.map(np.asarray, lm.init_params(
        jax.random.PRNGKey(0), get_smoke_config(arch)))


def _init_file(out_dir, arch: str) -> Path:
    return Path(out_dir) / f"init_{arch}.pkl"


def _ref_run(arch: str, compress: bool, spec: str, params, *,
             masters=None, save=None, restore=None) -> dict:
    """The reference launcher's body (``repro.launch.train.main``): the
    params placed by ``param_pspecs``, ``init_state``, the jitted step
    with donation, the data iterator; every step's loss.  The step's
    outputs are pinned to its inputs' placement (the launcher's lets
    XLA choose, then compiles again for the second step): one compile,
    the same losses.  ``masters``:
    write the masters after step 1 there (npz); ``save``: checkpoint
    after ``CKPT_AT`` steps there, as a run of that many steps does at
    its end; ``restore``: resume from that directory's checkpoint
    re-sharded onto this mesh (``store.restore(shardings=)``), after
    checking every restored leaf bit-equal to its file."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    from repro.checkpoint import store
    from repro.configs import get_smoke_config
    from repro.data.pipeline import DataConfig, DataIterator
    from repro.launch import steps as steps_mod
    from repro.launch.mesh import dp_axes
    from repro.launch.train import parse_mesh
    from repro.models import psharding as PS, shardings as sh
    from repro.optim import AdamConfig, init_state

    cfg = get_smoke_config(arch)
    mesh = parse_mesh(spec)
    PS.set_mesh(mesh, dp=dp_axes(mesh), tp="model")
    acfg = AdamConfig(lr=LR, compress_grads=compress)
    out = {}
    with mesh:
        p_specs = sh.param_pspecs(jax.eval_shape(lambda: params), mesh)
        placed = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            params, p_specs)
        opt = init_state(placed, acfg)
        replicated = NamedSharding(mesh, PartitionSpec())
        opt["step"] = jax.device_put(opt["step"], replicated)
        where = jax.tree.map(lambda x: x.sharding, (placed, opt))
        step_fn = jax.jit(steps_mod.make_train_step(cfg, acfg),
                          donate_argnums=(0, 1),
                          out_shardings=where + (replicated,))
        it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                     global_batch=BATCH))
        start = 0
        if restore is not None:
            named = jax.tree.map(lambda s: NamedSharding(mesh, s), p_specs)
            shardings = {"params": named, "opt": {
                k: (NamedSharding(mesh, PartitionSpec()) if k == "step"
                    else named) for k in opt}}
            state, meta = store.restore(restore, {"params": placed,
                                                  "opt": opt},
                                        shardings=shardings)
            out["restore_bit_equal"] = _bit_equal_to_files(restore, state)
            placed, opt = state["params"], state["opt"]
            start = int(meta["step"])
            it.restore({"step": start})
        losses = {}
        for i in range(start, STEPS):
            b = next(it)
            placed, opt, loss = step_fn(
                placed, opt, {"tokens": jnp.asarray(b["tokens"]),
                              "labels": jnp.asarray(b["labels"])})
            losses[i] = float(loss)
            if i == 0 and masters is not None:
                np.savez(masters, **{
                    _key(p): np.asarray(x) for p, x in
                    jax.tree_util.tree_leaves_with_path(opt["master"])})
            if save is not None and i + 1 == CKPT_AT:
                store.save(save, CKPT_AT, {"params": placed, "opt": opt},
                           metadata={"step": CKPT_AT})
    out["losses"] = losses
    return out


def _bit_equal_to_files(ckpt_dir, tree) -> dict:
    """Whether every leaf of ``tree`` equals, bit for bit, the global
    array in the latest checkpoint of ``ckpt_dir`` (the port's raw bf16
    patterns read as 16-bit integers)."""
    import jax
    d = sorted(Path(ckpt_dir).glob("step_????????"))[-1]
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    equal = 0
    for path, x in leaves:
        want = np.load(d / manifest["leaves"][_key(path)]["file"])
        got = np.asarray(x)
        equal += bool(got.tobytes() == want.tobytes()
                      and got.shape == want.shape)
    return {"leaves": len(leaves), "equal": equal}


def _ref_shard_shapes(arch: str, specs) -> dict:
    """Per mesh: each leaf's addressable shard shapes, of the params
    placed by ``param_pspecs`` and of the AdamW state (``err`` too)
    that ``init_state`` makes from them."""
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import get_smoke_config
    from repro.launch.train import parse_mesh
    from repro.models import lm, shardings as sh
    from repro.optim import AdamConfig, init_state
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(
        lambda: lm.init_params(jax.random.PRNGKey(0), cfg))
    out = {}
    for spec in specs:
        mesh = parse_mesh(spec)
        p_specs = sh.param_pspecs(shapes, mesh)
        placed = jax.tree.map(
            lambda s, p: jax.device_put(np.zeros(s.shape, s.dtype),
                                        NamedSharding(mesh, p)),
            shapes, p_specs)
        opt = init_state(placed, AdamConfig(compress_grads=True))
        out[spec] = {
            _key(path): [list(s.data.shape) for s in x.addressable_shards]
            for path, x in jax.tree_util.tree_leaves_with_path(
                {"params": placed, "opt": opt})}
    return out


def _ref_adaptive_failure() -> dict:
    """The reference launcher's ``--adaptive`` at 2x2: its error and the
    frames inside ``src/repro`` it passed through."""
    from repro.launch import train
    try:
        train.main(["--arch", "llama3-8b", "--smoke", "--steps", "1",
                    "--mesh", "2x2", "--adaptive", "--batch", str(BATCH),
                    "--seq", str(SEQ)])
    except Exception as e:  # the reference's failure is the reading
        src = ROOT / "src"
        return {"error": type(e).__name__, "message": str(e)[:300],
                "frames": [[Path(f.filename).relative_to(src).as_posix(),
                            f.lineno] for f in
                           traceback.extract_tb(e.__traceback__)
                           if Path(f.filename).is_relative_to(src)]}
    return {"error": None}


def _reference_job(job: str, out_dir: str, port_ckpt: str) -> dict:
    import jax
    n, meshes, shape_meshes = JOBS[job]
    out = {"devices": len(jax.devices()), "runs": {}, "shapes": {}}
    inits = {}
    for name, (arch, compress) in VARIANTS.items():
        if arch not in inits:
            inits[arch] = pickle.loads(_init_file(out_dir, arch)
                                       .read_bytes())
        params = inits[arch]
        for spec in meshes:
            kw = {}
            if name == CKPT_ARCH and spec == "2x4":
                kw["save"] = str(Path(out_dir) / "ref_ckpt")
            out["runs"][f"{name}@{spec}"] = _ref_run(
                arch, compress, spec, params,
                masters=str(Path(out_dir) / f"{name}@{spec}.npz"), **kw)
    if job == "mesh8":
        out["port_ckpt"] = _ref_run(CKPT_ARCH, False, "2x4",
                                    inits[CKPT_ARCH], restore=port_ckpt)
    if job == "mesh1":
        out["adaptive"] = _ref_adaptive_failure()
    for arch in SHAPE_ARCHS if shape_meshes else ():
        out["shapes"][arch] = _ref_shard_shapes(arch, shape_meshes)
    return out


# ===================================================================== #
# the port's side                                                       #
# ===================================================================== #
def _argv(name: str, spec: str, steps: int = STEPS) -> list:
    arch, compress = VARIANTS[name]
    return (["--arch", arch, "--smoke", "--steps", str(steps), "--batch",
             str(BATCH), "--seq", str(SEQ), "--device", "cpu", "--mesh",
             spec, "--lr", repr(LR)]
            + (["--compress-grads"] if compress else []))


def _port_run(name: str, spec: str, steps: int = STEPS, extra=()):
    """``launch.train.run`` over ``spec``'s logical CPU devices; the
    run's ``masters1`` holds the masters after its first step."""
    from unittest import mock
    from repro_torch.launch import train
    first = []
    make = train.steps_mod.make_train_step

    def recording(cfg, acfg=None):
        step = make(cfg, acfg)

        def run(params, opt, batch):
            out = step(params, opt, batch)
            if not first:
                first.append(out[1]["master"])
            return out
        return run
    with mock.patch.object(train.steps_mod, "make_train_step", recording):
        run = train.run(train.parse_args(_argv(name, spec, steps)
                                         + list(extra)),
                        devices=[CPU] * _n(spec))
    run.masters1 = first[0] if first else None
    return run


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("sharded_train")


@pytest.fixture(scope="module")
def reference(run_dir):
    """Every job of ``JOBS`` at once, each in its own process under its
    forced host device count; before them the port's checkpoint that
    the reference restores (llama3-8b at 2x2, ``CKPT_AT`` steps, the
    port's own initial params)."""
    port_ckpt = run_dir / "port_ckpt"
    _port_run(CKPT_ARCH, "2x2", CKPT_AT, ["--ckpt-dir", str(port_ckpt)])
    for arch in {a for a, _ in VARIANTS.values()}:
        _init_file(run_dir, arch).write_bytes(pickle.dumps(_ref_init(arch)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    procs = {}
    for job, (n, _, _) in JOBS.items():
        procs[job] = subprocess.Popen(
            ["timeout", str(JOB_TIMEOUT_S), sys.executable, __file__, job,
             str(run_dir), str(port_ckpt)],
            env=dict(env, XLA_FLAGS=(
                f"--xla_force_host_platform_device_count={n}")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {"runs": {}, "shapes": {}}
    for job, proc in procs.items():
        stdout, stderr = proc.communicate()
        assert proc.returncode == 0, stderr[-4000:]
        got = json.loads(stdout.strip().splitlines()[-1])
        assert got["devices"] == JOBS[job][0]
        out["runs"].update(got.pop("runs"))
        for arch, per in got.pop("shapes").items():
            out["shapes"].setdefault(arch, {}).update(per)
        out.update(got)
    for r in out["runs"].values():
        r["losses"] = {int(k): v for k, v in r["losses"].items()}
    return out


_INITS: dict = {}


@pytest.fixture
def ref_init(monkeypatch, reference, run_dir):
    """The port's launcher starts from the reference's initial params
    (``lm.init_params`` patched to return a fresh copy of them)."""
    from _torch_parity import tree_to_torch
    from repro_torch.models import lm

    def init(cfg, *, seed=0, device=None):
        if cfg.name not in _INITS:
            _INITS[cfg.name] = tree_to_torch(pickle.loads(
                _init_file(run_dir, cfg.name).read_bytes()))
        return lm.tree_map(lambda t: t.clone().to(device),
                           _INITS[cfg.name])
    monkeypatch.setattr(lm, "init_params", init)


def _spread(reference, name: str, i: int) -> float:
    """The reference's own spread at step ``i``: the largest difference
    between two of its runs of ``name`` (at 1x1 and at every mesh of
    ``MESHES``), all measured here.  Later steps part by rounding alone
    (a sign flip of a small gradient moves a master by 2 lr), as far at
    one device between the packages as between the reference's own
    meshes."""
    xs = [reference["runs"][f"{name}@{m}"]["losses"][i]
          for m in ("1x1",) + MESHES]
    return max(xs) - min(xs)


def _outside(reference, name: str, got: dict, want: dict,
             gap=None) -> list:
    """The steps whose losses part by more than the reference's own
    spread there plus ``LOSS_ATOL``, plus ``gap[i]`` where given (how
    far the two packages part at one device at that step)."""
    return [i for i in range(STEPS) if not abs(got[i] - want[i]) <= (
        _spread(reference, name, i) + LOSS_ATOL
        + (gap[i] if gap else 0.0))]


_RUNS: dict = {}


def _run_once(name: str, spec: str, steps: int, ref: bool):
    """``_port_run`` once per (run, initial params) in this process: the
    runs without a checkpoint directory are deterministic."""
    key = (name, spec, steps, ref)
    if key not in _RUNS:
        _RUNS[key] = _port_run(name, spec, steps)
    return _RUNS[key]


def _masters(run) -> dict:
    """The run's masters after its first step, as global arrays."""
    import torch.utils._pytree as pytree
    from repro_torch.models import shardings as sh
    return {_key(p): sh.gather(x).numpy() for p, x in
            pytree.tree_flatten_with_path(run.masters1)[0]}


def _masters_agree(got: dict, want: dict) -> list:
    """``test_train_step_matches_reference``'s rule over every leaf: an
    AdamW first step moves each master by about lr, so the masters agree
    to a few lr wherever the grads' signs agree.  Returns the leaves
    that break it."""
    bad = []
    for key, w in want.items():
        d = np.abs(got[key] - w)
        if not (np.mean(d < 1e-6 + 3 * LR) > 0.995 and d.max() < 3 * LR):
            bad.append(key)
    assert set(got) == set(want)
    return bad


# ===================================================================== #
# (a) shard shapes                                                      #
# ===================================================================== #
@pytest.mark.parametrize("spec", SHAPE_MESHES)
@pytest.mark.parametrize("arch", SHAPE_ARCHS)
def test_shard_shapes_match_reference(reference, arch, spec):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train
    from repro_torch.models import lm, shardings as sh
    from repro_torch.optim import AdamConfig, init_state
    import torch.utils._pytree as pytree
    cfg = get_smoke_config(arch)
    mesh = train.parse_mesh(spec, "cpu", devices=[CPU] * _n(spec))
    params = lm.init_params(cfg, seed=0, device="cpu")
    placed = sh.to_named(params, sh.param_pspecs(params, mesh), mesh)
    opt = init_state(placed, AdamConfig(compress_grads=True))
    got = {}
    for path, x in pytree.tree_flatten_with_path(
            {"params": placed, "opt": opt})[0]:
        # a plain leaf (the step counter) lives on the first device
        got[_key(path)] = ([list(s) for s in x.shard_shapes()]
                           if isinstance(x, sh.ShardedTensor)
                           else [list(x.shape)])
    assert got == reference["shapes"][arch][spec]


# ===================================================================== #
# (b) losses and masters against the reference and against 1x1          #
# ===================================================================== #
@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_mesh_losses_and_masters_match_reference(reference, ref_init,
                                                 run_dir, name, spec):
    """From the reference's initial params, the port at ``spec`` against
    the reference at ``spec``: losses within the reference's own spread
    plus ``LOSS_ATOL`` plus the packages' gap at one device (both 1x1
    runs read here); masters after step 1 by the rule."""
    ref = reference["runs"]
    run, one = _run_once(name, spec, STEPS, True), \
        _run_once(name, "1x1", STEPS, True)
    assert sorted(run.losses) == list(range(STEPS))
    gap = [abs(one.losses[i] - ref[f"{name}@1x1"]["losses"][i])
           for i in range(STEPS)]
    assert _outside(reference, name, run.losses,
                    ref[f"{name}@{spec}"]["losses"], gap) == []
    assert _masters_agree(_masters(run), dict(
        np.load(run_dir / f"{name}@{spec}.npz"))) == []


@pytest.mark.parametrize("name", list(VARIANTS))
def test_one_device_losses_match_reference(reference, ref_init, run_dir,
                                           name):
    """At 1x1: step 0 within ``LOSS_ATOL`` (``test_torch_train``'s) and
    the masters after step 1 by the rule.  Later steps part by rounding
    alone (rwkv6-7b's bf16 recurrence 2.1e-3 at step 2, past the
    reference's own spread there): the mesh tests add that gap to their
    limit."""
    want = reference["runs"][f"{name}@1x1"]["losses"]
    run = _run_once(name, "1x1", STEPS, True)
    assert abs(run.losses[0] - want[0]) <= LOSS_ATOL
    assert _masters_agree(_masters(run), dict(
        np.load(run_dir / f"{name}@1x1.npz"))) == []


@pytest.mark.parametrize("spec", MESHES)
@pytest.mark.parametrize("name", list(VARIANTS))
def test_mesh_run_matches_own_one_device_run(reference, name, spec):
    """The port against itself (its own initial params): a mesh run's
    losses and masters against its 1x1 run's, within the reference's
    own spread plus ``LOSS_ATOL``; step 0 equal to rounding."""
    one, split = (_run_once(name, m, STEPS, False) for m in ("1x1", spec))
    assert abs(split.losses[0] - one.losses[0]) <= 1e-5
    assert _outside(reference, name, split.losses, one.losses) == []
    assert _masters_agree(_masters(split), _masters(one)) == []


# ===================================================================== #
# (c) the fused update per distinct block                               #
# ===================================================================== #
@pytest.mark.parametrize("spec", MESHES)
def test_fused_update_runs_once_per_block_and_equals_plain(spec,
                                                           monkeypatch):
    import torch.utils._pytree as pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import ops
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, shardings as sh
    from repro_torch.optim import adam
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    mesh = train.parse_mesh(spec, "cpu", devices=[CPU] * _n(spec))
    params = lm.init_params(cfg, seed=0, device="cpu")
    params = sh.to_named(params, sh.param_pspecs(params, mesh), mesh)
    b = batch_for_step(DataConfig(cfg.vocab, SEQ, BATCH), 0)
    _, grads = steps.make_grad_step(cfg)(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    calls = []
    fused = ops.fused_adam
    monkeypatch.setattr(ops, "fused_adam", lambda *a, **k: (
        calls.append(tuple(a[0].shape)), fused(*a, **k))[1])
    out = {}
    for on in (False, True):
        acfg = adam.AdamConfig(lr=LR, use_fused_kernel=on)
        out[on] = adam.apply_update(params, adam.init_state(params, acfg),
                                    grads, acfg)
    blocks = [t for x in pytree.tree_leaves(params)
              for t in sh.local_tensors(x)]
    assert sorted(calls) == sorted(tuple(t.shape) for t in blocks)
    assert len(calls) > len(pytree.tree_leaves(params))
    for a, c in zip(pytree.tree_leaves(out[False]),
                    pytree.tree_leaves(out[True])):
        assert type(a) is type(c)
        assert torch.equal(sh.gather(a), sh.gather(c))
        if isinstance(a, sh.ShardedTensor):
            assert a.shard_shapes() == c.shard_shapes()


def test_gradients_of_a_block_held_twice_are_summed():
    """Copies of one block on several physical devices (two tensors of
    one block, as two cards would hold) each get the sum of their
    gradients (``steps._all_reduce``); distinct blocks are left alone."""
    from repro_torch.launch import steps, train
    from repro_torch.models import shardings as sh
    mesh = train.parse_mesh("2", "cpu", devices=[CPU] * 2)
    a, b = torch.ones(4), torch.full((4,), 2.0)
    copies = steps._all_reduce(sh.ShardedTensor((4,), sh.P(None), mesh,
                                                [a, b]))
    assert all(torch.equal(t, torch.full((4,), 3.0))
               for t in copies.shards)
    split = sh.ShardedTensor((8,), sh.P("model"), mesh, [a, b])
    assert steps._all_reduce(split) is split


@pytest.mark.parametrize("arch", ["whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_cross_input_models_split_like_one_device(arch):
    """The models that read frames (Whisper's encoder, the VLM's image
    embeddings): the loss and its gradients at 2x2, each data shard
    taking its rows of the frames, equal one device's to rounding (bf16
    gradients summed over two data shards: within
    ``test_torch_train.GRAD_REL["dense"]`` of a leaf's norm)."""
    import torch.utils._pytree as pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, shardings as sh
    cfg = get_smoke_config(arch)
    rs = np.random.RandomState(0)
    batch = {"tokens": torch.as_tensor(rs.randint(0, cfg.vocab, (4, 32))),
             "labels": torch.as_tensor(rs.randint(0, cfg.vocab, (4, 32))),
             "frames": torch.as_tensor(rs.standard_normal(
                 (4, cfg.n_frontend_tokens, cfg.d_model)), dtype=torch.float32)}
    params = lm.init_params(cfg, seed=0, device="cpu")
    mesh = train.parse_mesh("2x2", "cpu", devices=[CPU] * 4)
    placed = sh.to_named(params, sh.param_pspecs(params, mesh), mesh)
    (l1, g1), (l2, g2) = (steps.make_grad_step(cfg)(p, batch)
                          for p in (params, placed))
    assert abs(float(l1) - float(l2)) <= 1e-5
    for a, c in zip(pytree.tree_leaves(g1), pytree.tree_leaves(g2)):
        c = sh.gather(c).float()
        assert torch.linalg.norm(a.float() - c) <= 3e-2 * max(
            float(torch.linalg.norm(a.float())), 1e-6)


# ===================================================================== #
# (d) elastic checkpoints                                               #
# ===================================================================== #
def _assert_restored_bit_equal(ckpt_dir, tree) -> None:
    import torch.utils._pytree as pytree
    from repro_torch.models import shardings as sh
    d = sorted(Path(ckpt_dir).glob("step_????????"))[-1]
    manifest = json.loads((d / "manifest.json").read_text())
    flat = pytree.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(manifest["leaves"])
    for path, x in flat:
        want = np.load(d / manifest["leaves"][_key(path)]["file"])
        got = sh.gather(x)
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16)
        assert got.numpy().tobytes() == want.tobytes(), _key(path)


@pytest.mark.parametrize("to", ["4x2", "1x1"])
def test_port_checkpoint_reshards_elastically(reference, tmp_path, to):
    """Saved at 2x4 after two steps, restored at ``to``: every leaf bit
    for bit, and the third step's loss within the limits of the
    uninterrupted 2x4 run."""
    from repro_torch.checkpoint import restore
    from repro_torch.launch import train
    from repro_torch.models import shardings as sh
    from repro_torch.optim import init_state_shapes, AdamConfig
    name = "qwen3-moe-30b-a3b"
    ck = tmp_path / "ck"
    _port_run(name, "2x4", CKPT_AT, ["--ckpt-dir", str(ck)])
    mesh = train.parse_mesh(to, "cpu", devices=[CPU] * _n(to))
    whole = _run_once(name, "2x4", STEPS, False)
    shapes = {"params": whole.params,
              "opt": init_state_shapes(whole.params, AdamConfig())}
    specs = sh.param_pspecs(whole.params, mesh)
    placement = sh.named_shardings(
        {"params": specs, "opt": {**sh.opt_state_pspecs(specs, mesh)}},
        mesh)
    state, meta = restore(ck, shapes, placement=placement)
    assert meta["step"] == CKPT_AT
    _assert_restored_bit_equal(ck, state)
    if to != "1x1":
        assert sh.mesh_of(state) is mesh
    resumed = _port_run(name, to, STEPS, ["--ckpt-dir", str(ck)])
    assert resumed.start == CKPT_AT and sorted(resumed.losses) == [2]
    assert abs(resumed.losses[2] - whole.losses[2]) <= \
        _spread(reference, name, 2) + LOSS_ATOL


def test_reference_checkpoint_restores_in_port(reference, run_dir,
                                               tmp_path):
    """The reference's checkpoint of llama3-8b at 2x4 after two steps,
    restored by the port's launcher at 2x2: every leaf bit for bit, and
    the third step within the limits of the reference's uninterrupted
    2x4 run."""
    from repro_torch.checkpoint import restore
    from repro_torch.launch import train
    from repro_torch.models import shardings as sh
    ck = tmp_path / "ref_ckpt"
    shutil.copytree(run_dir / "ref_ckpt", ck)
    mesh = train.parse_mesh("2x2", "cpu", devices=[CPU] * 4)
    like = _port_run(CKPT_ARCH, "2x2", 0)
    template = {"params": like.params, "opt": like.opt}
    state, _ = restore(ck, template, placement=sh.named_shardings(
        {"params": sh.param_pspecs(like.params, mesh),
         "opt": sh.opt_state_pspecs(sh.param_pspecs(like.params, mesh),
                                    mesh)}, mesh))
    _assert_restored_bit_equal(ck, state)
    resumed = _port_run(CKPT_ARCH, "2x2", STEPS, ["--ckpt-dir", str(ck)])
    want = reference["runs"][f"{CKPT_ARCH}@2x4"]["losses"][2]
    assert resumed.start == CKPT_AT
    assert abs(resumed.losses[2] - want) <= \
        _spread(reference, CKPT_ARCH, 2) + LOSS_ATOL


def test_port_checkpoint_restores_in_reference(reference):
    """The port's checkpoint of llama3-8b at 2x2 after two steps (the
    fixture's), restored by the reference at 2x4: every leaf bit for
    bit, and the reference's third step within the limits of the port's
    uninterrupted 2x2 run."""
    got = reference["port_ckpt"]
    assert got["restore_bit_equal"]["equal"] == \
        got["restore_bit_equal"]["leaves"] > 0
    whole = _run_once(CKPT_ARCH, "2x2", STEPS, False)
    assert sorted(got["losses"]) == ["2"]
    assert abs(got["losses"]["2"] - whole.losses[2]) <= \
        _spread(reference, CKPT_ARCH, 2) + LOSS_ATOL


# ===================================================================== #
# (e) planted faults                                                    #
# ===================================================================== #
def _moe_capacity_cfg():
    """The MoE smoke model at capacity factor 1.0, so the grouping
    decides which tokens drop."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                               capacity_factor=1.0)


def _loss_terms(cfg, spec):
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train
    from repro_torch.models import lm, shardings as sh
    params = lm.init_params(cfg, seed=0, device="cpu")
    if spec != "1x1":
        mesh = train.parse_mesh(spec, "cpu", devices=[CPU] * _n(spec))
        params = sh.to_named(params, sh.param_pspecs(params, mesh), mesh)
    b = batch_for_step(DataConfig(cfg.vocab, SEQ, BATCH), 0)
    with torch.no_grad():
        return [float(t) for t in lm.loss_terms(
            params, cfg, torch.as_tensor(b["tokens"]),
            torch.as_tensor(b["labels"]))]


# the MoE terms at a split against one device: both rounding alone
MOE_TERM_RTOL = 1e-5


@pytest.mark.parametrize("fault", [None, "aux per shard",
                                   "groups from local tokens"])
def test_moe_keeps_global_batch_semantics(monkeypatch, fault):
    """At 2x4 (two data shards, experts over four), the MoE's cross
    entropy and aux loss equal one device's; planting either fault moves
    one of them past the limit."""
    from repro_torch.models import lm, modules as M
    cfg = _moe_capacity_cfg()
    want = _loss_terms(cfg, "1x1")
    if fault == "aux per shard":
        # each shard's E * sum(me * ce) from its own terms (rescaled to
        # the shard), averaged over the shards
        whole = lm._shards_aux

        def per_shard(terms, first):
            n = len(terms)
            return sum(whole([[x * n for x in t]], first)
                       for t in terms) / n
        monkeypatch.setattr(lm, "_shards_aux", per_shard)
    elif fault == "groups from local tokens":
        orig = M.moe_fwd

        def local_groups(p, x, *, shards=None, **kw):
            out, _ = orig(p, x, **kw)
            return out, orig(p, x, shards=shards, **kw)[1]
        monkeypatch.setattr(M, "moe_fwd", local_groups)
    got = _loss_terms(cfg, "2x4")
    off = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    assert (max(off) <= MOE_TERM_RTOL) == (fault is None), off


@pytest.mark.parametrize("fault", [None, "dropped data shard"])
def test_dropped_data_shard_fails(reference, monkeypatch, fault):
    """llama3-8b at 2x4 against the port's 1x1 run: within the limits,
    and outside them with one data shard's gradient dropped (its loss
    still counted; the masters rule, a few lr, does not see it)."""
    from repro_torch.models import lm
    name, spec = "llama3-8b", "2x4"
    one = _run_once(name, "1x1", STEPS, False)
    if fault:
        orig = lm._shard_loss

        def drop(p, cfg, shard, *a):
            ce, terms = orig(p, cfg, shard, *a)
            return (ce.detach() if shard.index == 1 else ce), terms
        monkeypatch.setattr(lm, "_shard_loss", drop)
    split = _port_run(name, spec)
    off = _outside(reference, name, split.losses, one.losses)
    assert (off == []) == (fault is None), (split.losses, one.losses)


# the global norm at a split against one device: bf16 gradients summed
# over data shards round apart (llama3-8b smoke at 2x4: 6.9e-4 of it)
NORM_RTOL = 3e-3


# the fault at 2x2x2, whose pod axis replicates every block: at 2x2 and
# 2x4 every block of llama3-8b's smoke model but the norm scales is split
# over data x model, so counting per device adds only those scales
@pytest.mark.parametrize("fault,spec", [(None, m) for m in MESHES] + [
    ("norm per device", "2x2x2")])
def test_global_norm_counts_each_block_once(monkeypatch, fault, spec):
    """The norm ``grad_clip`` divides by (``adam._global_norm``) over the
    placed gradients equals one device's; counting each replicated
    block once per mesh device reads past ``NORM_RTOL``.  (AdamW is
    invariant to one scale of every gradient, so a wrong norm under a
    clip that binds barely moves the losses: the norm itself is the
    reading.)"""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, shardings as sh
    from repro_torch.optim import adam
    import torch.utils._pytree as pytree
    cfg = get_smoke_config("llama3-8b")
    b = batch_for_step(DataConfig(cfg.vocab, SEQ, BATCH), 0)
    b = {k: torch.as_tensor(v) for k, v in b.items()}
    params = lm.init_params(cfg, seed=0, device="cpu")
    mesh = train.parse_mesh(spec, "cpu", devices=[CPU] * _n(spec))
    placed = sh.to_named(params, sh.param_pspecs(params, mesh), mesh)
    norms = [float(adam._global_norm(pytree.tree_leaves(
        steps.make_grad_step(cfg)(p, b)[1]))) for p in (params, placed)]
    if fault:
        monkeypatch.setattr(adam, "_norm_blocks", lambda g: list(
            getattr(g, "shards", [g])))
        norms[1] = float(adam._global_norm(pytree.tree_leaves(
            steps.make_grad_step(cfg)(placed, b)[1])))
    rel = abs(norms[1] - norms[0]) / norms[0]
    assert (rel <= NORM_RTOL) == (fault is None), (norms, rel)


# ===================================================================== #
# (f) --adaptive on a split mesh                                        #
# ===================================================================== #
def test_adaptive_on_a_split_mesh_fails_like_reference(reference):
    from repro_torch.launch import train
    got = reference["adaptive"]
    assert got["error"] == "ValueError" and "pinned_host" in \
        got["message"]
    assert got["frames"][-1] == ["repro/pool/state_store.py", 73]
    assert ["repro/launch/train.py", 99] in got["frames"]
    with pytest.raises(ValueError, match="ROADMAP section 3"):
        train.run(train.parse_args(_argv("llama3-8b", "2x2", 1)
                                   + ["--adaptive"]),
                  devices=[CPU] * 4)


if __name__ == "__main__":
    print(json.dumps(_reference_job(*sys.argv[1:4])))
