"""MiB rank 0 puts into its collectives a step (the program's
``collective.bytes``), over the traced steps."""

from octbench.program_trace import counter


def read(ctx):
    nbytes, steps = counter(ctx, "collective.bytes"), ctx.get("traced_steps")
    if nbytes is None or not steps:
        return None
    return nbytes / 2 ** 20 / steps
