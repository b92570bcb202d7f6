"""Mean host-clock span of a decode iteration in the window
(``ServingEngine._decode_iteration``, which ends in the host read of
its tokens)."""
from perfbench.readers import mean_ms

UNIT, LAYER, MOVES = "ms", "serving/engine.py decode iteration", "output_tok_s"


def read(out):
    return mean_ms(out.ctx["decodes"])
