"""Mean per decode step, over the window's decode iterations, of the
summed ``engine.decode.mamba`` spans: the host's enqueue of each Mamba-2
layer's decode (norm, in_proj, conv and slot states, the state update,
gated norm, out_proj), read from the engine's tracer, which the hybrid
driver turns on in traced runs.

A span times the host, and the host blocks once the card's launch queue
is full: where the card is busy, as behind ``fused_expert_ffn``'s passes
in the hybrid cell, most of a span is that wait.  So the metric also
falls when other kernels get faster, with no change to the Mamba
layers' own host work; read it beside ``idle_share`` and the kernels'
rooflines."""
UNIT, LAYER, MOVES = "ms", "serving/engine.py decode iteration", "output_tok_s"


def read(out):
    return out.ctx.get("mamba_enqueue_ms")
