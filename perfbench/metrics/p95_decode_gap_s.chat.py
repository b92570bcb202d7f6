"""95th percentile of every gap between a request's consecutive tokens
that ends in the window, on the host's clock: a decode step, and the
prefills the engine runs before it, stall every running row."""
UNIT, LAYER, MOVES = "s", "serving/engine.py decode iteration", "output_tok_s"


def read(out):
    g = out.ctx.get("p95_decode_gap_s")
    return g if g == g else None
