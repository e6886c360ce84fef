"""Device time of the served graph a B-scan: CUDA events around each
``forward`` call in the window, summed, over the B-scans served."""


def read(ctx):
    if not ctx.get("forward_ms"):
        return None
    return sum(ctx["forward_ms"]) / ctx["bscans"]
