"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a``
into ``<build dir>/<name>-<hash>.so``, all sources at once in parallel,
at the first launch of any kernel (or by an explicit ``build_all()``).
The hash covers the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  The build
directory is ``build/kernels`` at the repository root, or
``$REPRO_TORCH_BUILD_DIR``.  Nothing but the repository's sources and
the CUDA toolkit (``$NVCC``, else ``/usr/local/cuda/bin/nvcc``, else
``nvcc`` on ``PATH``) is used.

Launch counters live here too: ``LAUNCHES[name]`` is a plain integer
that each kernel wrapper bumps where it launches its kernel, and only
there, so a run can show which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("decode_attention", "paged_decode_attention", "flash_attention")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
          "-I", str(CSRC))
_ARGTYPES = {
    # q, k, v, kv_len, out, B, H, KV, S, HD, scale, stream
    "decode_attention_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    # q, k_pool, v_pool, tbl, kv_len, k_new, v_new, out,
    # B, H, KV, nb, bt, HD, scale, stream
    "paged_decode_attention_bf16": [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p],
    # q, k, v, out, B, Sq, Sk, H, KV, HD, causal, scale, stream
    "flash_attention_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}   # name -> nvcc output (ptxas -v report)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    out = {name: _target(name) for name in KERNELS}
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
