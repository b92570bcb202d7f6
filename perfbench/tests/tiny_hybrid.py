"""The hybrid cell at a size the CPU holds: granite-4.0-h-small's
configuration and the chat traffic file's structure, two periods of its
layer pattern at small widths.  Its limit is set as the card's is,
between the program's and the float8 control's readings on the CPU (see
``test_bench_hybrid``)."""
from __future__ import annotations

import copy

from perfbench import harness

harness.set_environment()

HYBRID_MODEL = {"n_layers": 20, "d_model": 128, "n_heads": 4, "n_kv": 2,
                "head_dim": 32, "d_ff": 64, "n_experts": 8, "top_k": 2,
                "vocab": 512, "capacity_factor": 1.25, "moe_groups": 4,
                "mamba_head_dim": 32, "mamba_d_state": 16, "ssd_chunk": 16,
                "shared_expert_ff": 64, "attn_layers": [5, 15]}
LIMIT = 2e-3


def hybrid_cell(**mix) -> dict:
    c = copy.deepcopy(harness.cell("hybrid-chat-closed64"))
    c["config"]["model"].update(HYBRID_MODEL)
    c["config"]["serving"].update(max_batch=4, max_context=96,
                                  num_blocks=64)
    t = c["traffic"]
    t["prompt"].update(median=24, min=8, max=48)
    t["output"].update(median=8, min=4, max=16)
    t.update(clients=4, warmup={"requests": 2})
    t["check"].update(served_tokens=120, served_logit_gap_mean=LIMIT)
    t["trace"] = {"iterations": 4}
    t.update(mix)
    return c
