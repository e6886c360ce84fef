"""Device busy time a step on rank 0's card, from the profiler over the
traced steps."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not ctx.get("traced_steps"):
        return None
    return 1e3 * trace["busy_s"] / ctx["traced_steps"]
