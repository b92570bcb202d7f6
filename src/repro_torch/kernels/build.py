"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` (``LIBRARIES``) is compiled by its own ``nvcc``
for ``sm_90a`` into ``<build dir>/<name>-<hash>.so``, all sources at
once in parallel, at the first launch of any kernel (or by an explicit
``build_all()``).
The hash covers the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  The build
directory is ``build/kernels`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``.  Nothing but the repository's sources and
the CUDA toolkit (``$NVCC``, else ``/usr/local/cuda/bin/nvcc``, else
``nvcc`` on ``PATH``) is used.

Launch counters live here too: each kernel wrapper calls ``count``
where it launches its kernel, and only there, which adds one to
``SHAPE_LAUNCHES[(name, shape)]``; ``LAUNCHES[name]`` sums a kernel's
counts over its shapes (``KERNELS``: one name per wrapper, so a library
of several kernels counts each).  So a run can show which kernels its
path went through, and at which shapes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from collections import Counter
from collections.abc import Mapping
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
LIBRARIES = ("decode_attention", "paged_decode_attention",
             "flash_attention", "fused_expert_ffn", "fused_adam",
             "moe_bucket", "ssm_state_update")
KERNELS = ("decode_attention", "paged_decode_attention", "flash_attention",
           "fused_expert_ffn", "fused_adam", "moe_bucket_positions",
           "moe_bucket_scatter", "moe_bucket_combine", "ssm_state_update")
SHAPE_LAUNCHES: Dict[Tuple[str, tuple], int] = Counter()


class _Launches(Mapping):
    """Each kernel's launches: ``SHAPE_LAUNCHES`` summed over shapes."""

    def __getitem__(self, name: str) -> int:
        if name not in KERNELS:
            raise KeyError(name)
        return sum(n for (k, _), n in SHAPE_LAUNCHES.items() if k == name)

    def __iter__(self):
        return iter(KERNELS)

    def __len__(self) -> int:
        return len(KERNELS)


LAUNCHES = _Launches()

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
          "-I", str(CSRC))
_ARGTYPES = {
    # q, k, v, kv_len, out, m_part, l_part, acc_part, B, H, KV, S, HD, T,
    # n_split, scale, stream
    "decode_attention_bf16": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    # q, k_pool, v_pool, tbl, kv_len, k_new, v_new, out, m_part, l_part,
    # acc_part, B, H, KV, nb, bt, HD, T, n_split, scale, stream
    "paged_decode_attention_bf16": [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, out, B, Sq, Sk, H, KV, HD, causal, scale, stream
    "flash_attention_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    # x, w_gate, w_up, w_down, ids, wts, h scratch, its end, out, B, K,
    # D, F, E, e_lo, e_hi, out_f32, stream
    "fused_expert_ffn_bf16": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    # master, m, v, g, out_master, out_m, out_v, n, g_dtype,
    # lr, b1, b2, eps, wd, b1c, b2c, 1 - b1, 1 - b2, stream
    "fused_adam_f32": [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_float] * 9 + [ctypes.c_void_p],
    # ids, pos, G, T*k, E, stream
    "moe_bucket_positions_i64": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    # x, ids, pos, buf, N, T, k, D, G, C, E, dtype, stream
    "moe_bucket_scatter": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    # expert_out, ids, topw, pos, out, N, T, k, D, G, C, E, dtype, stream
    "moe_bucket_combine": [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    # state, slots, x, x_ld, Bm, Cm, bc_ld, dt, A, D, y, B, n_slots, H,
    # G, N, P, stream
    "ssm_state_update_f32": [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 6 + [ctypes.c_void_p],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}   # name -> nvcc output (ptxas -v report)


def reset_launches() -> None:
    SHAPE_LAUNCHES.clear()


def count(name: str, *shape: int) -> None:
    """One launch of kernel ``name`` at ``shape``."""
    SHAPE_LAUNCHES[(name, shape)] += 1


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set $NVCC or install the CUDA toolkit)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together.  Returns name -> library path."""
    out = {name: _target(name) for name in LIBRARIES}
    todo = {n: p for n, p in out.items() if not p.is_file()}
    if not todo:
        return out
    nvcc = nvcc_path()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_all()[name]))
            for fn, argtypes in _ARGTYPES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(rc: int, fn: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch "
                           "(unsupported shape, or a refused launch)")
