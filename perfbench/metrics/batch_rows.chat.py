"""Mean rows a decode step, over the window's decode iterations (the
scheduler's running list when each began)."""
UNIT, LAYER, MOVES = "rows", "serving/scheduler.py admission and batching", "output_tok_s"


def read(out):
    d = out.ctx["decodes"]
    return sum(r for _, _, r in d) / len(d) if d else None
