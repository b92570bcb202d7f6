"""Model FLOPs of the tokens prefilled and decoded in the window over
the window and the card's bf16 peak."""
from perfbench.readers import mfu

UNIT, LAYER, MOVES = "%", "whole serving step", "output_tok_s"


def read(out):
    return mfu(out)
