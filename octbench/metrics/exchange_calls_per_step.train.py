"""Collectives rank 0 makes a step (the program's ``collective.calls``:
K6's sums, the loss's sums and the gradients), over the traced steps."""

from octbench.program_trace import counter


def read(ctx):
    calls, steps = counter(ctx, "collective.calls"), ctx.get("traced_steps")
    if calls is None or not steps:
        return None
    return calls / steps
