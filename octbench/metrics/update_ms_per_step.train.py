"""Device time under the program's ``step.update`` span a step on rank
0's card (the gradient sum, the optimizer step and the running
statistics), over the traced steps."""

from octbench.program_trace import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ("step.update",), "steps")
