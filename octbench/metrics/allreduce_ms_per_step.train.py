"""Device time of the NCCL kernels (K6's sums, K8's statistics and the
gradients, all-reduced) a step on rank 0's card, over the traced steps."""

from octbench.trace import device_seconds

KERNELS = ("nccl", "Nccl")


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("traced_steps"):
        return None
    seconds, calls = device_seconds(trace, *KERNELS)
    if not calls:
        return None
    return 1e3 * seconds / ctx["traced_steps"]
