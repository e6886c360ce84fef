"""Idle time of rank 0's card while the host was inside one of the
program's ``step.*`` spans (the step's own dispatch), a step, over the
traced steps."""

from octbench.program_trace import idle_ms


def read(ctx):
    return idle_ms(ctx, lambda name: name.startswith("step."), "steps")
