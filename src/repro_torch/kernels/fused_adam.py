"""One-pass AdamW: the CUDA kernel ``csrc/fused_adam.cu`` and its
wrapper.

Replaces ``repro/kernels/fused_adam.py`` (``fused_adam_2d`` /
``_adam_kernel`` and the wrapper ``fused_adam``), the optimizer step of
``offload/train_engine.py::ZeroOffloadEngine.train_step`` (once per
parameter leaf per step) and of ``optim/adam.py::apply_update`` with
``use_fused_kernel=True``.

Bound on the H100: device-memory bytes.  Each element reads master, m
and v (12 bytes) and g (2 or 4) and writes 12 bytes, against about 15
fp32 operations: 12.8 GB and 3.8 ms at gpt2-xl-offload's largest leaf
(``mlp.w_up``, 491.5 M elements, bf16 g).  Design: a grid-stride loop
of 16-byte loads, 4 elements per thread, with the ``n % 4`` tail done
element by element; a tensor with a pointer not aligned for those loads
goes through a scalar loop.  The hyperparameters are float arguments,
so a new step's bias corrections need no recompile; nothing is padded.
Outputs are new tensors, as the reference returns new arrays.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build
from ._launch import require, stream_of

G_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_adam(master: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               g: torch.Tensor, *, lr: float, b1: float, b2: float,
               eps: float, wd: float, b1c, b2c
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """master/m/v fp32 and g (fp32, bf16 or fp16) of one shape,
    contiguous, on one CUDA device; any alignment.  ``b1c``/``b2c`` are
    the bias corrections ``1 - b ** step`` (a float or a 0-d tensor).
    Returns new (master', m', v'), fp32.  Raises on any other input, and
    on CPU tensors (``kernels.ops`` routes those to ``ref.fused_adam``).
    """
    shape = tuple(master.shape)
    for t, name in ((master, "master"), (m, "m"), (v, "v")):
        require(t, name, torch.float32, shape, aligned=False)
    if g.dtype not in G_DTYPES:
        raise ValueError(f"g: dtype {g.dtype}, kernel takes "
                         f"{sorted(map(str, G_DTYPES))}")
    require(g, "g", g.dtype, shape, aligned=False)
    if len({t.device for t in (master, m, v, g)}) != 1:
        raise ValueError("master, m, v and g must be on one device")
    outs = tuple(torch.empty(shape, dtype=torch.float32,
                             device=master.device) for _ in range(3))
    n = master.numel()
    if n == 0:
        return outs
    b1, b2 = float(b1), float(b2)
    with torch.cuda.device(master.device):
        rc = build.load("fused_adam").fused_adam_f32(
            master.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            *(o.data_ptr() for o in outs), n, G_DTYPES[g.dtype],
            float(lr), b1, b2, float(eps), float(wd), float(b1c),
            float(b2c), 1.0 - b1, 1.0 - b2, stream_of(master))
    build.check(rc, "fused_adam")
    build.count("fused_adam", n)
    return outs
