"""K7's share of its roofline in the served ReLayNet: the least time of
the graph's seven 7x3 int8 convs, counted from the layer shapes
(``work.relaynet_k7_bounds``), over the device time of the kernels that compute
them in the traced window."""

from octbench.trace import device_seconds
from octbench.work import relaynet_k7_bounds

# K7's bodies: conv7x3_mma (b1..b6) and stem7x3_mma (b0)
KERNELS = ("conv7x3_mma", "stem7x3_mma")


def read(ctx):
    trace, cfg = ctx.get("trace"), ctx["cfg"]
    if not trace or cfg["model"] != "relaynet":
        return None
    seconds, calls = device_seconds(trace, *KERNELS)
    if not calls:
        return None
    least_ms = sum(relaynet_k7_bounds(cfg["width"], cfg["image_size"], n)
                   for n in ctx["profiled_batches"])
    return 100.0 * least_ms / (seconds * 1e3)
