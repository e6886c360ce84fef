"""Device time under the program's ``serve.unpool`` spans (ReLayNet's
three index unpools) a B-scan, over the traced B-scans."""

from octbench.program_trace import span_device_ms


def read(ctx):
    return span_device_ms(ctx, ("serve.unpool",), "bscans")
