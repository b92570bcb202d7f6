"""fused_expert_ffn's share of its roofline in the traced slice: bytes
of the distinct experts each call's ids route to, plus x and out."""
from perfbench.readers import roofline

UNIT, LAYER, MOVES = "%", "kernels/ops.py fused_expert_ffn", "output_tok_s"


def read(out):
    return roofline(out, "fused_expert_ffn")
