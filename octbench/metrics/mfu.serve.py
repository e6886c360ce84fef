"""The whole served graph's share of the card's int8 peak: the model's
operations (its reference module's ``forward_ops``) for the B-scans served
in the window, over the window, over 1,979 TOP/s."""

from octbench.harness import reference
from octbench.work import PEAK


def read(ctx):
    if not ctx["window_s"]:
        return None
    cfg = ctx["cfg"]
    rate = reference(cfg).forward_ops(cfg) * ctx["bscans"] / ctx["window_s"]
    return 100.0 * rate / (ctx["chips"] * PEAK["int8"])
