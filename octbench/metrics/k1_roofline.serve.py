"""K1's share of its roofline in the served U-Net: the least time of the
graph's 3x3 int8 convs (the stem included), counted from the layer shapes
(``work.unet_k1_bounds``), over the device time of the kernels that compute
them in the traced window."""

from octbench.trace import device_seconds
from octbench.work import unet_k1_bounds

# K1's bodies: conv3x3_int8_mma, conv3x3_int8_stem, conv3x3_int8_kernel
KERNELS = ("conv3x3_int8",)


def read(ctx):
    trace, cfg = ctx.get("trace"), ctx["cfg"]
    if not trace or cfg["model"] != "unet":
        return None
    seconds, calls = device_seconds(trace, *KERNELS)
    if not calls:
        return None
    f, hw, nc = cfg["width"], cfg["image_size"], cfg["num_classes"]
    least_ms = sum(unet_k1_bounds(f, hw, nc, n)
                   for n in ctx["profiled_batches"])
    return 100.0 * least_ms / (seconds * 1e3)
