"""ssm_state_update's share of its roofline in the traced slice: each
call's rows' fp32 Mamba-2 states read and written once, plus x, B, C,
dt and y (``costs/hybrid.py``)."""
from perfbench.readers import roofline

UNIT, LAYER, MOVES = "%", "kernels/ops.py ssm_state_update", "output_tok_s"


def read(out):
    return roofline(out, "ssm_state_update")
