"""Idle time of rank 0's card while the host waited in the program's
``input.wait`` span for its next batch, a step, over the traced steps."""

from octbench.program_trace import idle_ms


def read(ctx):
    return idle_ms(ctx, lambda name: name == "input.wait", "steps")
