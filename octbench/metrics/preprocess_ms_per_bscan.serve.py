"""Device time under the program's ``serve.preprocess`` spans (the
z-score and the input's quantisation to int8) a B-scan, over the traced
B-scans."""

from octbench.program_trace import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ("serve.preprocess",), "bscans")
