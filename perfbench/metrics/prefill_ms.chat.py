"""Mean host-clock span of a request's prefill in the window
(``ServingEngine._do_prefill``, which ends in the host read of the
first token)."""
from perfbench.readers import mean_ms

UNIT, LAYER, MOVES = "ms", "serving/engine.py prefill", "output_tok_s"


def read(out):
    return mean_ms(out.ctx["prefills"])
