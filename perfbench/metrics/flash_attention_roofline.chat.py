"""flash_attention's share of its roofline in the traced slice: causal
FLOPs and q, k, v, out bytes of each prefill call."""
from perfbench.readers import roofline

UNIT, LAYER, MOVES = "%", "kernels/ops.py flash_attention", "output_tok_s"


def read(out):
    return roofline(out, "flash_attention")
