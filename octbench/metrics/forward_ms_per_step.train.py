"""Device time under the program's ``step.forward`` and ``step.loss``
spans a step on rank 0's card (the train-mode forward with K6's sums and
the loss), over the traced steps."""

from octbench.program_trace import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ("step.forward", "step.loss"), "steps")
