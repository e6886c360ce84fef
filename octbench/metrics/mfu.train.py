"""The whole training step's share of the cards' bf16 peak: three times
the model's forward operations (its reference module's ``forward_ops``:
the forward, the gradient of the inputs and that of the weights; neither
recomputation nor elementwise work is counted) for the B-scans trained in
the window, over the window, over the cards' 989 TFLOP/s each."""

from octbench.harness import reference
from octbench.work import PEAK


def read(ctx):
    if not ctx["window_s"]:
        return None
    cfg = ctx["cfg"]
    flops = 3 * reference(cfg).forward_ops(cfg)
    rate = flops * ctx["bscans"] / ctx["window_s"]
    return 100.0 * rate / (ctx["chips"] * PEAK["bf16"])
