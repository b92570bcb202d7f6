"""Cells of the benchmark at a size the CPU holds: the configuration and
traffic files' own structure, with small sizes.

At this size the logits are a third of the served model's, so the tiny
cell gets a limit of its own, set as the card's was, between the two
readings: on the CPU, over ~120 served tokens, the program read 0 -
8.6e-4 (eight seeds), the float8 control 4.0e-3 - 1.2e-2 (four) and a
decode step that leaves the cache unchanged 0.029 - 0.055 (four)."""
from __future__ import annotations

import copy

from perfbench import harness

harness.set_environment()

SERVE_MODEL = {"n_layers": 8, "d_model": 256, "n_heads": 4, "n_kv": 2,
               "head_dim": 64, "d_ff": 64, "n_experts": 32, "top_k": 8,
               "vocab": 512, "capacity_factor": 1.25, "moe_groups": 4}


def serve_cell(**mix) -> dict:
    c = copy.deepcopy(harness.cell("moe-chat-closed64"))
    c["config"]["model"].update(SERVE_MODEL)
    c["config"]["serving"].update(max_batch=4, max_context=96,
                                  num_blocks=64)
    t = c["traffic"]
    t["prompt"].update(median=24, min=8, max=48)
    t["output"].update(median=8, min=4, max=16)
    t.update(clients=4, warmup={"requests": 2})
    t["check"].update(served_tokens=120, served_logit_gap_mean=2e-3)
    t["trace"] = {"iterations": 4}
    t.update(mix)
    return c

