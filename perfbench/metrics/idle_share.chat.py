"""Share of the traced slice with no kernel, copy or memset on the
card."""
from perfbench.readers import idle_share

UNIT, LAYER, MOVES = "%", "device", "output_tok_s"


def read(out):
    return idle_share(out)
