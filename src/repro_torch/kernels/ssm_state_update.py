"""The Mamba-2 decode state update over per-request state slots: the
CUDA kernel ``csrc/ssm_state_update.cu`` and its wrapper.

No TPU kernel is replaced: the reference has no decode form of the
published Mamba-2 block (``models/modules.py::mamba2_step``).  Its plain
version (``ref.ssm_state_update``) gathers the rows' states, decays
them, adds dt B x^T, scatters them back and reads C^T state out: four
or five passes over the state and a temporary.  The kernel reads each
row's state once and writes it once, in place.

Bound on the H100: device-memory bytes, 2 B H N P 4 (the fp32 state
read and written), 512 MiB and 0.16 ms a layer at granite-4.0-h-small's
64 rows x 128 heads x N 128 x P 64.

Design: one block of 256 threads a (head, row); each thread owns 4
columns of P and N / (256 / (P / 4)) rows of the state, with 8 rows'
16-byte loads in flight before it stores; B and C are the row's
group's, shared by its H / G heads; the column sums of C_n s_n meet in
shared memory and y = C^T s + D x.
"""
from __future__ import annotations

import torch

from . import build
from ._launch import require, stream_of


def _columns(t: torch.Tensor, name: str, rows: int, width: int) -> int:
    """Raise unless ``t`` is a (rows, width) bf16 CUDA slice of a
    row-major buffer (contiguous columns, any row stride); returns the
    row stride in elements."""
    if t.device.type != "cuda" or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: takes a bf16 CUDA tensor (got "
                         f"{t.dtype} on {t.device})")
    if tuple(t.shape) != (rows, width) or (width > 1 and t.stride(1) != 1):
        raise ValueError(f"{name}: shape {tuple(t.shape)} strides "
                         f"{t.stride()}, expected ({rows}, {width}) with "
                         "contiguous columns")
    return t.stride(0)


def ssm_state_update(state: torch.Tensor, slots: torch.Tensor,
                     x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                     dt: torch.Tensor, A: torch.Tensor,
                     D: torch.Tensor) -> torch.Tensor:
    """state (n_slots, H, N, P) fp32, updated in place at the rows'
    slots; slots (B,) int32 (int64 cast); x (B, H*P), Bm and Cm (B,
    G*N): bf16 with contiguous columns (slices of one step's conv
    output); dt (B, H) fp32 (after softplus); A (H,) fp32 (negative);
    D (H,) fp32.  Returns y (B, H, P) fp32.  Raises on any other input,
    and on CPU tensors (``kernels.ops`` routes those to
    ``ref.ssm_state_update``)."""
    n_slots, H, N, P = state.shape
    B = x.shape[0]
    G = Bm.shape[1] // N
    require(state, "state", torch.float32, (n_slots, H, N, P))
    x_ld = _columns(x, "x", B, H * P)
    b_ld = _columns(Bm, "Bm", B, G * N)
    if _columns(Cm, "Cm", B, G * N) != b_ld:
        raise ValueError("Bm and Cm must share a row stride")
    ids = slots.to(torch.int32).contiguous()
    require(ids, "slots", torch.int32, (B,), aligned=False)
    require(dt, "dt", torch.float32, (B, H), aligned=False)
    require(A, "A", torch.float32, (H,), aligned=False)
    require(D, "D", torch.float32, (H,), aligned=False)
    y = torch.empty((B, H, P), dtype=torch.float32, device=state.device)
    with torch.cuda.device(state.device):
        rc = build.load("ssm_state_update").ssm_state_update_f32(
            state.data_ptr(), ids.data_ptr(), x.data_ptr(), x_ld,
            Bm.data_ptr(), Cm.data_ptr(), b_ld, dt.data_ptr(), A.data_ptr(),
            D.data_ptr(), y.data_ptr(), B, n_slots, H, G, N, P,
            stream_of(state))
    build.check(rc, "ssm_state_update")
    build.count("ssm_state_update", B, H, N, P, G)
    return y
