"""input_specs(): fake-tensor stand-ins + partition specs for every cell
(counterpart of ``repro.launch.specs``).

Builds, for a given (arch x shape x mesh), everything the dry-run needs:
the step callable, its abstract arguments (fake tensors built under
``FakeTensorMode``, the port's ``jax.eval_shape``: shapes and dtypes, no
storage) and, beside them, their ``PartitionSpec`` trees from
``models.shardings``.  Nothing is placed on the mesh, so a production
mesh over placeholder devices (``launch.mesh.placeholder_devices``)
builds every cell; ``Cell.materialize`` gives real arguments of the
cell's shapes on one device, so a (small) cell can be run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import SHAPES, ModelConfig, ShapeConfig
from ..configs.registry import get_config
from ..core.tiered_array import DeviceLike, resolve_device
from ..models import lm
from ..models import shardings as sh
from ..optim import adam
from . import steps as steps_mod
from .mesh import dp_axes as mesh_dp_axes
from .mesh import tp_size

P = sh.P


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class Cell:
    """One (arch x shape) dry-run cell, ready to trace."""

    arch: str
    shape: ShapeConfig
    step_name: str            # train_step | prefill_step | serve_step
    fn: Callable
    args: Tuple               # fake-tensor args (ints and 0-d step real)
    specs: Tuple              # PartitionSpec trees mirroring ``args``
    out_specs: Any            # PartitionSpec trees of the outputs, or None
    model_cfg: ModelConfig
    donate_argnums: Tuple[int, ...] = ()
    adam_cfg: Optional[adam.AdamConfig] = None

    def materialize(self, device: DeviceLike = None, *, params=None,
                    seed: int = 0) -> Tuple:
        """The cell's arguments as real tensors on ``device`` (CUDA
        unless ``"cpu"``): ``params`` (default ``lm.init_params`` from
        ``seed``), a fresh optimizer state or a zero cache at the cell's
        index, and token ids (and frames) from a generator seeded with
        ``seed``.  ``self.fn(*cell.materialize(...))`` runs the step."""
        dev = resolve_device(device)
        cfg, B, S = self.model_cfg, self.shape.global_batch, \
            self.shape.seq_len
        if params is None:
            params = lm.init_params(cfg, seed=seed, device=dev)
        gen = torch.Generator().manual_seed(seed)

        def ids(n):
            return torch.randint(0, cfg.vocab, (B, n), generator=gen,
                                 dtype=torch.int32).to(dev)

        def with_frames(batch):
            if cfg.n_frontend_tokens:
                batch["frames"] = torch.randn(
                    B, cfg.n_frontend_tokens, cfg.d_model,
                    generator=gen).to(device=dev, dtype=torch.bfloat16)
            return batch

        if self.step_name == "train_step":
            opt = adam.init_state(params, self.adam_cfg)
            return params, opt, with_frames({"tokens": ids(S),
                                             "labels": ids(S)})
        if self.step_name == "prefill_step":
            return params, with_frames({"tokens": ids(S)})
        cache = lm.make_decode_cache(cfg, B, round_up(S + 64, 4096),
                                     enc_len=cfg.n_frontend_tokens,
                                     device=dev)
        cache["index"] = S
        return params, cache, ids(1)


def eval_shape(fn: Callable, *args, mode: Optional[FakeTensorMode] = None,
               **kw):
    """What ``fn`` returns, as fake tensors under ``mode`` (a new one by
    default): shapes and dtypes, no storage (``jax.eval_shape``)."""
    with mode or FakeTensorMode():
        return fn(*args, **kw)


def param_structs(cfg: ModelConfig, mesh, fsdp: Optional[str] = "data",
                  mode: Optional[FakeTensorMode] = None):
    shapes = eval_shape(lm.init_params, cfg, device="cpu", mode=mode)
    specs = sh.param_pspecs(shapes, mesh, fsdp=fsdp)
    return shapes, specs


# per-device budget under which inference replicates weights over the
# data axes (TP-only "serving sharding": no per-step FSDP all-gather)
SERVE_REPLICATED_BUDGET = 8 * 1024**3


def _serve_fsdp(cfg: ModelConfig, mesh) -> Optional[str]:
    per_dev = 2 * cfg.param_count() / max(tp_size(mesh), 1)
    return None if per_dev <= SERVE_REPLICATED_BUDGET else "data"


def build_cell(arch: str, shape_name: str, mesh,
               adam_cfg: Optional[adam.AdamConfig] = None,
               cfg_override: Optional[ModelConfig] = None,
               serve_tp_only: bool = True) -> Cell:
    """The cell's step and fake arguments.  Unlike the reference, no
    logical-axis mapping is activated (``models.psharding``): the port's
    model modules place no constraints yet (ROADMAP queue 1, item 11)."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    dp = mesh_dp_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    mode = FakeTensorMode()

    fsdp = "data"
    if shape.step in ("prefill", "decode") and serve_tp_only:
        fsdp = _serve_fsdp(cfg, mesh)
    params, p_specs = param_structs(cfg, mesh, fsdp=fsdp, mode=mode)
    tok_spec = sh.batch_pspec(B, mesh, dp)

    def tokens(n):
        return eval_shape(torch.empty, (B, n), dtype=torch.int32,
                          mode=mode)

    def frames(batch, specs):
        if cfg.n_frontend_tokens:
            batch["frames"] = eval_shape(
                torch.empty, (B, cfg.n_frontend_tokens, cfg.d_model),
                dtype=torch.bfloat16, mode=mode)
            specs["frames"] = P(tok_spec[0] if len(tok_spec) else None,
                                None, None)
        return batch, specs

    if shape.step == "train":
        adam_cfg = adam_cfg or adam.AdamConfig()
        opt = eval_shape(adam.init_state, params, adam_cfg, mode=mode)
        # a real 0-d step: AdamW's fused path reads it on the host
        opt["step"] = torch.zeros((), dtype=torch.int32)
        opt_specs = sh.opt_state_pspecs(p_specs, mesh)
        if adam_cfg.compress_grads:
            opt_specs = dict(opt_specs)
            opt_specs["err"] = p_specs
        batch, b_specs = frames({"tokens": tokens(S), "labels": tokens(S)},
                                {"tokens": tok_spec, "labels": tok_spec})
        fn = steps_mod.make_train_step(cfg, adam_cfg)
        # donate params + opt state: in-place buffer reuse (without it the
        # step holds OLD and NEW optimizer state simultaneously — +2x).
        return Cell(arch, shape, "train_step", fn, (params, opt, batch),
                    (p_specs, opt_specs, b_specs), (p_specs, opt_specs, P()),
                    cfg, donate_argnums=(0, 1), adam_cfg=adam_cfg)

    if shape.step == "prefill":
        batch, b_specs = frames({"tokens": tokens(S)}, {"tokens": tok_spec})
        fn = steps_mod.make_prefill_step(cfg)
        # pin the cache's output specs (the reference leaves the
        # scan-stacked KV partially replicated otherwise).  The prefill
        # cache has the decode cache's layout over S positions; building
        # that is cheaper than running the step (the reference's
        # eval_shape), which unrolls the recurrent scans
        out_cache = eval_shape(lm.make_decode_cache, cfg, B, S,
                               enc_len=cfg.n_frontend_tokens, device="cpu",
                               mode=mode)
        del out_cache["index"]
        cache_specs = sh.cache_pspecs(out_cache, mesh, B, dp)
        return Cell(arch, shape, "prefill_step", fn, (params, batch),
                    (p_specs, b_specs), (None, cache_specs), cfg)

    # decode: serve_step with a KV/state cache of seq_len
    max_seq = round_up(S + 64, 4096)
    cache = eval_shape(lm.make_decode_cache, cfg, B, max_seq,
                       enc_len=cfg.n_frontend_tokens, device="cpu",
                       mode=mode)
    cache["index"] = S           # the step decodes token S + 1
    cache_specs = sh.cache_pspecs(cache, mesh, B, dp)
    fn = steps_mod.make_serve_step(cfg)
    # donate the cache: decode updates it in place (KV buffers are the
    # dominant memory at 32k/500k context).
    return Cell(arch, shape.__class__(shape.name, S, B, "decode"),
                "serve_step", fn, (params, cache, tokens(1)),
                (p_specs, cache_specs, tok_spec), (None, cache_specs),
                cfg, donate_argnums=(1,))


def input_specs(arch: str, shape_name: str, mesh, **kw):
    """The dry-run entry: abstract inputs for the cell's step function."""
    return build_cell(arch, shape_name, mesh, **kw).args
