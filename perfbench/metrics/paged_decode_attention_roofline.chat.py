"""paged_decode_attention's share of its roofline in the traced slice:
K and V of the blocks each row's table names up to its kv_len."""
from perfbench.readers import roofline

UNIT, LAYER, MOVES = "%", "kernels/ops.py paged_decode_attention", "output_tok_s"


def read(out):
    return roofline(out, "paged_decode_attention")
