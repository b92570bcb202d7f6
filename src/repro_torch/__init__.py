"""repro_torch: the PyTorch/CUDA port of ``repro``, for NVIDIA Hopper.

Module paths mirror ``src/repro/``: ``repro_torch.serving.engine`` is the
counterpart of ``repro.serving.engine``.  The package imports ``torch``
and numpy and nothing of ``repro``; framework-free modules are kept as
copies.  Every Pallas kernel of the reference that the ported path runs
is a CUDA kernel under ``csrc/``, built at first use (``kernels.build``).

Subpackages (imported lazily so ``import repro_torch`` stays light):
  configs   the attention-only model configs (configs.ARCH_IDS)
  core      tier descriptors, data objects, placement policies, the
            cost model, migration policies, memory kinds, TieredArray
  cluster   namespaced ledger keys
  pool      residency ledger
  telemetry access traces, sampling, phase detection, adaptive replan
  obs       control-plane trace, metrics registry, SLOs, audit, probes
  kernels   CUDA kernels, their plain PyTorch versions, dispatch
  models    model blocks and the pattern LM (prefill, training loss)
  data      deterministic synthetic token pipeline
  optim     AdamW (clipping, bf16 compression, fused kernel path)
  offload   ZeRO-Offload training engine
  serving   continuous-batching paged-KV serving
  launch    step builders and the serving CLI
"""
import importlib

__version__ = "0.1.0"

_LAZY_SUBPACKAGES = ("configs", "core", "cluster", "pool", "telemetry",
                     "obs", "kernels", "models", "data", "optim",
                     "offload", "serving", "launch")


def __getattr__(name):
    if name in _LAZY_SUBPACKAGES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY_SUBPACKAGES))
