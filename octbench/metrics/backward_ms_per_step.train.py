"""Device time under the program's ``step.backward`` span a step on rank
0's card (the autograd engine's launches included), over the traced
steps."""

from octbench.program_trace import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ("step.backward",), "steps")
